"""Image database: the epoch-shuffled sampler, augmentation draws and the
batch readers of training (counterpart of ``squeezedet_tpu/data/imdb.py``,
copied because the JAX package's modules import jax).

The sampler is ``np.random.RandomState``, drawn in the JAX package's
order, so the two packages give the same batches for the same seed:

* every batch's decisions are drawn at once, under one lock, as a
  :class:`BatchPlan` (the index window with any epoch reshuffle, then
  (dy, dx, flip) per image), so the stream does not depend on how many
  prefetch threads run the plans;
* :meth:`Imdb.sampler_state` / :meth:`Imdb.set_sampler_state` snapshot
  and restore the permutation, the cursor and the MT19937 state.

KITTI's images are PNG files.  :func:`read_frame` decodes them with
OpenCV where it imports, as the JAX package does, and with the port's
own codec (``data/png.py``) where it does not; PNG headers are read by
``data/png.py`` (other formats, such as VOC's JPEGs, by PIL).  Only the
host-resize readers (:meth:`Imdb.read_batch`,
:meth:`Imdb.read_batch_raw_targets`, and eval's
:meth:`Imdb.read_image_batch`) need cv2, for ``cv2.resize``: the canvas
readers of ``--device_augment`` and ``--device_dataset`` (eval's
:meth:`Imdb.read_image_rows` among them) run without cv2 and PIL.

Data parallelism shards the sampler two ways in the JAX package:
:meth:`Imdb.shard_hosts` gives each host a strided shard of the split
(the port's train CLI does not call it: every rank draws one global
batch from one seed and keeps its rows), and :meth:`Imdb.shard_data`
partitions the split into one strided shard per data-parallel device
for a sharded ``--device_dataset``, whose batches are drawn shard-major
so that each device gathers only from its own shard
(:meth:`Imdb.load_canvas_shards`, and eval's
:meth:`Imdb.eval_shard_batches`).

With ``mc.use_native_loader`` (``--native_loader``) the f32 host-resize
readers, eval's :meth:`Imdb.read_image_batch` and
:meth:`Imdb.read_batch_raw_targets` without ``uint8_images``, load their
pixels through the C++ loader (``native/dataloader.py``), the augment
decisions still drawn here in the reference's RNG order.  The loader is
never skipped silently: where it cannot build or decode a frame, the
read raises.
"""

from __future__ import annotations

import functools
import os
import random
import shutil
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from squeezedet_torch.config import ModelConfig
from squeezedet_torch.data import png
from squeezedet_torch.ops.nms import batch_iou


@dataclass
class BatchPlan:
    """One batch's sampler decisions, drawn atomically under the lock.

    ``seq`` is the draw sequence number (monotonic per imdb); ``state``
    is the sampler snapshot taken just after this batch's draws, the
    state a resumed run restores to continue with the next batch.
    ``augment`` holds the per-image ((dx, dy), flip) decisions (None when
    augmentation is off), so the pixel work that consumes the plan draws
    no RNG and may run on any thread in any order.
    """

    seq: int
    batch_idx: List[str]
    augment: Optional[List[Tuple[Tuple[int, int], bool]]]
    state: Dict[str, np.ndarray]

    def select(self, rows: slice) -> "BatchPlan":
        """The plan of the batch's slots ``rows`` (a data-parallel rank's
        share), with the whole batch's draws and post-draw state."""
        return BatchPlan(self.seq, self.batch_idx[rows],
                         None if self.augment is None else self.augment[rows],
                         self.state)


@functools.lru_cache(maxsize=None)
def _opencv():
    """The cv2 module where it imports, else None (looked up once)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def read_frame(path: str) -> np.ndarray:
    """Decode an image file to BGR uint8 [H, W, 3], as ``cv2.imread``.

    OpenCV decodes where it imports: libpng in C, without the GIL, so the
    loader's threads decode in parallel.  Elsewhere ``png.imread_png``
    decodes (PNG only), which is much slower on rows written with the
    Avg and Paeth filters (see ``data/png.py``).  PNG is lossless, so
    both give the same pixels."""
    cv2 = _opencv()
    if cv2 is None:
        return png.imread_png(path)
    im = cv2.imread(path)
    if im is None:
        raise ValueError("{}: OpenCV cannot read it".format(path))
    return im


class Imdb:
    """Image database base class."""

    def __init__(self, name: str, mc: ModelConfig,
                 rng: Optional[np.random.RandomState] = None):
        self._name = name
        self._classes: Sequence[str] = []
        self._image_set = ""
        self._image_idx: List[str] = []
        self._data_root_path = ""
        self._rois: Dict[str, list] = {}
        self.mc = mc
        self._rng = rng if rng is not None else np.random.RandomState()

        # batch reader state
        self._perm_idx: Optional[List[str]] = None
        self._cur_idx = 0
        self._draw_seq = 0
        self._lock = threading.Lock()
        self._size_cache: Dict[str, Tuple[int, int]] = {}

        # bounded decoded-image cache (mc.image_cache_mb, 0 = off)
        self._image_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._image_cache_bytes = 0
        self._image_cache_lock = threading.Lock()

    def _imread(self, idx: str) -> np.ndarray:
        """Decode the image for ``idx`` (BGR uint8, like cv2.imread).

        When ``mc.image_cache_mb > 0`` decoded frames stay in a
        byte-bounded LRU so later epochs skip the decode.  Cached arrays
        are read-only and shared across batches; every consumer here
        copies them (astype, canvas assignment, resize)."""
        path = self._image_path_at(idx)
        budget = int(getattr(self.mc, "image_cache_mb", 0)) << 20
        if budget <= 0:
            return read_frame(path)
        with self._image_cache_lock:
            im = self._image_cache.get(idx)
            if im is not None:
                self._image_cache.move_to_end(idx)
                return im
        im = read_frame(path)
        im.setflags(write=False)
        with self._image_cache_lock:
            if idx not in self._image_cache:
                self._image_cache[idx] = im
                self._image_cache_bytes += im.nbytes
            while (self._image_cache_bytes > budget
                   and len(self._image_cache) > 1):
                _, old = self._image_cache.popitem(last=False)
                self._image_cache_bytes -= old.nbytes
        return im

    def _image_size(self, idx: str) -> Tuple[int, int]:
        """(width, height) from the image header without a full decode:
        a PNG's by ``data/png.py``, any other format's by PIL."""
        size = self._size_cache.get(idx)
        if size is None:
            path = self._image_path_at(idx)
            if path.lower().endswith(".png"):
                size = png.read_png_size(path)
            else:
                from PIL import Image
                with Image.open(path) as im:
                    size = im.size
            self._size_cache[idx] = size
        return size

    # -- properties mirroring the reference API -----------------------------
    @property
    def name(self):
        return self._name

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def image_idx(self):
        return self._image_idx

    @property
    def image_set(self):
        return self._image_set

    @property
    def data_root_path(self):
        return self._data_root_path

    # -- sampler ------------------------------------------------------------
    def _shuffle_image_idx(self):
        perm = self._rng.permutation(np.arange(len(self._image_idx)))
        self._perm_order = perm
        self._perm_idx = [self._image_idx[i] for i in perm]
        self._cur_idx = 0

    def shard_hosts(self, process_index: int, process_count: int) -> None:
        """Keep only process ``process_index``'s strided shard of the
        image list, so that ``process_count`` processes with their own
        seeds feed disjoint batches.  The canvas extents are pinned to the
        whole list first: every process must ship the same canvas."""
        if process_count <= 1:
            return
        with self._lock:
            self.canvas_size()
            self._image_idx = self._image_idx[process_index::process_count]
            if not self._image_idx:
                raise ValueError("host shard {}/{} is empty: fewer images "
                                 "than processes".format(process_index,
                                                         process_count))
            self._shuffle_image_idx()

    def shard_data(self, num_shards: int,
                   batch_size: Optional[int] = None) -> None:
        """Draw batches shard-major for a canvas stack sharded over
        ``num_shards`` data-parallel devices: shard s is ``images[s::D]``,
        and each batch is the concatenation, in shard order, of
        ``batch_size / D`` draws from each shard's own epoch permutation.
        Slot group s then references only shard s, so device s gathers
        its canvas rows from its own block.  The stream depends on the
        seed and ``num_shards`` only.

        ``batch_size`` is the effective batch the plan is drawn at (the
        global train batch, or eval's batch), ``mc.batch_size`` when
        omitted; it must divide by ``num_shards``.  Sharding again the
        same way keeps the live stream; another way raises.
        """
        if num_shards <= 1:
            return
        batch_size = self.mc.batch_size if batch_size is None else batch_size
        with self._lock:
            shards = getattr(self, "_data_shards", None)
            if shards is not None:
                if len(shards) == num_shards and \
                        batch_size == self._shard_batch:
                    return
                raise ValueError(
                    "imdb is already sharded {} ways at batch {}; cannot "
                    "shard {} ways at batch {} (the stream is a function "
                    "of the sharding: build a fresh imdb)".format(
                        len(shards), self._shard_batch, num_shards,
                        batch_size))
            if batch_size % num_shards:
                raise ValueError(
                    "batch {} is not divisible by the {} data shards"
                    .format(batch_size, num_shards))
            self.canvas_size()  # pinned over the whole list
            shards = [self._image_idx[s::num_shards]
                      for s in range(num_shards)]
            per = batch_size // num_shards
            for s, shard in enumerate(shards):
                if per > len(shard):
                    raise ValueError(
                        "per-shard batch {} exceeds the {} images of data "
                        "shard {}/{}".format(per, len(shard), s, num_shards))
            self._data_shards = shards
            self._shard_batch = batch_size
            # the padded row stride of the shard-major canvas stack
            self._shard_rows = max(len(s) for s in shards)
            if hasattr(self, "_dataset_pos"):
                del self._dataset_pos
            self._shard_perm_order = [None] * num_shards
            self._shard_perm_idx = [None] * num_shards
            self._shard_cur = [0] * num_shards
            for s in range(num_shards):
                self._shuffle_shard(s)

    @property
    def num_data_shards(self) -> int:
        return len(getattr(self, "_data_shards", None) or ()) or 1

    def _shuffle_shard(self, s: int) -> None:
        shard = self._data_shards[s]
        perm = self._rng.permutation(np.arange(len(shard)))
        self._shard_perm_order[s] = perm
        self._shard_perm_idx[s] = [shard[i] for i in perm]
        self._shard_cur[s] = 0

    def sampler_state(self) -> Dict[str, np.ndarray]:
        """Snapshot of the input-stream position as plain arrays: the
        epoch permutation, the cursor and the augmentation RNG.

        The trainer checkpoints the *consumed* batch's snapshot (each
        :class:`BatchPlan` carries its own), so resume redraws exactly
        the batches after the last one trained on.  This method snapshots
        the producer side, which a prefetch queue may run ahead of."""
        with self._lock:
            return self._sampler_state_locked()

    def _sampler_state_locked(self) -> Dict[str, np.ndarray]:
        key, pos, has_gauss, cached = self._rng.get_state()[1:]
        perm = getattr(self, "_perm_order", None)
        state = {
            "perm_order": (np.asarray(perm, np.int64)
                           if perm is not None
                           else np.zeros((0,), np.int64)),
            "cur_idx": np.asarray(self._cur_idx, np.int64),
            "rng_key": np.asarray(key, np.uint32),
            "rng_pos": np.asarray(pos, np.int64),
            "rng_has_gauss": np.asarray(has_gauss, np.int64),
            "rng_cached_gaussian": np.asarray(cached, np.float64),
        }
        if getattr(self, "_data_shards", None):
            d = len(self._data_shards)
            perm2 = np.full((d, self._shard_rows), -1, np.int64)
            for s in range(d):
                p = self._shard_perm_order[s]
                perm2[s, :len(p)] = p
            state["shard_perm_order"] = perm2
            state["shard_cur"] = np.asarray(self._shard_cur, np.int64)
        return state

    def set_sampler_state(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a :meth:`sampler_state` snapshot (inverse op).  A
        data-sharded snapshot needs an imdb sharded the same way."""
        with self._lock:
            perm = np.asarray(state["perm_order"], np.int64)
            if perm.size:
                if perm.size != len(self._image_idx):
                    raise ValueError(
                        "sampler state is for a {}-image set, this "
                        "imdb has {}".format(perm.size,
                                             len(self._image_idx)))
                self._perm_order = perm
                self._perm_idx = [self._image_idx[i] for i in perm]
            self._cur_idx = int(state["cur_idx"])
            self._set_shard_state_locked(state)
            self._rng.set_state(
                ("MT19937", np.asarray(state["rng_key"], np.uint32),
                 int(state["rng_pos"]), int(state["rng_has_gauss"]),
                 float(state["rng_cached_gaussian"])))

    def _set_shard_state_locked(self, state) -> None:
        sharded = getattr(self, "_data_shards", None)
        has_shard_state = "shard_perm_order" in state and \
            np.asarray(state["shard_perm_order"]).size
        if sharded and not has_shard_state:
            raise ValueError(
                "this imdb is data-sharded {} ways but the sampler state is "
                "unsharded: resume on as many data-parallel devices as the "
                "run was checkpointed on".format(len(sharded)))
        if not has_shard_state:
            return
        if not sharded:
            raise ValueError("sampler state is data-sharded; call "
                             "shard_data() before restoring it")
        perm2 = np.asarray(state["shard_perm_order"], np.int64)
        if perm2.shape[0] != len(sharded):
            raise ValueError(
                "sampler state has {} data shards, this imdb has {}: resume "
                "on as many data-parallel devices as the run was "
                "checkpointed on".format(perm2.shape[0], len(sharded)))
        for s in range(perm2.shape[0]):
            p = perm2[s][perm2[s] >= 0]
            if p.size != len(sharded[s]):
                raise ValueError("sampler-state shard {} has {} rows, this "
                                 "imdb's shard has {}".format(
                                     s, p.size, len(sharded[s])))
            self._shard_perm_order[s] = p
            self._shard_perm_idx[s] = [sharded[s][i] for i in p]
        cur = [int(c) for c in np.asarray(state["shard_cur"])]
        for s, c in enumerate(cur):
            if not 0 <= c <= len(sharded[s]):
                raise ValueError("sampler-state shard {} cursor {} is out of "
                                 "range for its {}-image shard".format(
                                     s, c, len(sharded[s])))
        self._shard_cur = cur

    def reset_cursor(self) -> None:
        """Rewind the sequential read cursor to the start of the image
        list (eval's full-split scans), under the sampler lock."""
        with self._lock:
            self._cur_idx = 0

    def _next_batch_idx(self, shuffle: bool) -> List[str]:
        with self._lock:
            return self._next_batch_idx_locked(shuffle)

    def _next_batch_idx_locked(self, shuffle: bool) -> List[str]:
        mc = self.mc
        if shuffle and getattr(self, "_data_shards", None):
            # per-shard windows, concatenated shard-major (shard_data)
            per = self._shard_batch // len(self._data_shards)
            batch_idx: List[str] = []
            for s, shard in enumerate(self._data_shards):
                if self._shard_cur[s] + per >= len(shard):
                    self._shuffle_shard(s)
                batch_idx.extend(self._shard_perm_idx[s][
                    self._shard_cur[s]:self._shard_cur[s] + per])
                self._shard_cur[s] += per
            return batch_idx
        if shuffle:
            # the epoch window is a straight slice of the permutation, so
            # a batch may not exceed the image list
            if mc.batch_size > len(self._image_idx):
                raise ValueError(
                    "batch_size={} exceeds the {} images in this imdb; "
                    "shrink the batch or grow the dataset".format(
                        mc.batch_size, len(self._image_idx)))
            if self._cur_idx + mc.batch_size >= len(self._image_idx):
                self._shuffle_image_idx()
            batch_idx = self._perm_idx[
                self._cur_idx:self._cur_idx + mc.batch_size]
            self._cur_idx += mc.batch_size
        else:
            if self._cur_idx + mc.batch_size >= len(self._image_idx):
                batch_idx = (
                    self._image_idx[self._cur_idx:]
                    + self._image_idx[:self._cur_idx + mc.batch_size
                                      - len(self._image_idx)])
                self._cur_idx += mc.batch_size - len(self._image_idx)
            else:
                batch_idx = self._image_idx[
                    self._cur_idx:self._cur_idx + mc.batch_size]
                self._cur_idx += mc.batch_size
        return batch_idx

    def next_draw_seq(self) -> int:
        """The sequence number the next :meth:`draw_batch_plan` will get
        (loaders capture it at start to ticket their enqueue order)."""
        with self._lock:
            return self._draw_seq

    def _gt_boxes_for(self, idx: str) -> np.ndarray:
        return np.array(
            [[b[0], b[1], b[2], b[3]] for b in self._rois[idx][:]])

    def draw_batch_plan(self, shuffle: bool = True) -> BatchPlan:
        """Draw one batch's sampler decisions atomically: the index window
        (with any epoch reshuffle), each image's augmentation values in
        the reference's order (dy, dx, flip), a sequence number and the
        post-draw sampler snapshot."""
        mc = self.mc
        with self._lock:
            batch_idx = self._next_batch_idx_locked(shuffle)
            augment = None
            if mc.data_augmentation:
                augment = [
                    self._draw_augment_locked(self._gt_boxes_for(idx))
                    for idx in batch_idx]
            seq = self._draw_seq
            self._draw_seq += 1
            state = self._sampler_state_locked()
        return BatchPlan(seq=seq, batch_idx=batch_idx, augment=augment,
                         state=state)

    def _image_path_at(self, idx: str) -> str:
        raise NotImplementedError

    # -- augmentation ---------------------------------------------------------
    def _draw_augment_locked(self, gt_bbox: np.ndarray
                             ) -> Tuple[Tuple[int, int], bool]:
        """RNG half of the augmentation: draw (dy, dx, flip) in the
        reference's order; the caller holds the sampler lock."""
        mc = self.mc
        dx = dy = 0
        if mc.drift_x > 0 or mc.drift_y > 0:
            # largest drift that keeps every GT box inside the image
            max_drift_x = min(gt_bbox[:, 0] - gt_bbox[:, 2] / 2.0 + 1)
            max_drift_y = min(gt_bbox[:, 1] - gt_bbox[:, 3] / 2.0 + 1)
            assert max_drift_x >= 0 and max_drift_y >= 0, \
                'bbox out of image'
            dy = self._rng.randint(-mc.drift_y,
                                   min(mc.drift_y + 1, max_drift_y))
            dx = self._rng.randint(-mc.drift_x,
                                   min(mc.drift_x + 1, max_drift_x))
        flip = bool(self._rng.randint(2) > 0.5)
        return (dx, dy), flip

    def _augment(self, gt_bbox: np.ndarray, orig_w: float, orig_h: float,
                 im: Optional[np.ndarray] = None,
                 plan_aug: Optional[Tuple[Tuple[int, int], bool]] = None):
        """Drift crop + horizontal flip, shared by every reader.

        With ``plan_aug`` the (dx, dy, flip) decisions come from a
        :class:`BatchPlan` and no RNG is drawn here; without it they are
        drawn under the lock.  Shifts the GT boxes and, when ``im`` is
        given, applies the padded crop and the flip to the pixels.

        Returns (im, gt_bbox, orig_w, orig_h, (dx, dy), flip).
        """
        mc = self.mc
        if plan_aug is not None:
            (dx, dy), flip = plan_aug
        else:
            with self._lock:
                (dx, dy), flip = self._draw_augment_locked(gt_bbox)
        drift = mc.drift_x > 0 or mc.drift_y > 0
        if drift:
            gt_bbox[:, 0] -= dx
            gt_bbox[:, 1] -= dy
            orig_h -= dy
            orig_w -= dx
            if im is not None:
                orig_x, dist_x = max(dx, 0), max(-dx, 0)
                orig_y, dist_y = max(dy, 0), max(-dy, 0)
                # the reference pads the crop with 0 after the mean
                # subtraction; raw uint8 pixels pad with the rounded means
                if im.dtype == np.uint8:
                    shifted = np.full(
                        (int(orig_h), int(orig_w), 3),
                        np.round(self.mc.bgr_means_array()),
                        np.uint8)
                else:
                    shifted = np.zeros((int(orig_h), int(orig_w), 3),
                                       np.float32)
                shifted[dist_y:, dist_x:, :] = im[orig_y:, orig_x:, :]
                im = shifted

        if flip:
            if im is not None:
                im = im[:, ::-1, :]
            gt_bbox[:, 0] = orig_w - 1 - gt_bbox[:, 0]
        return im, gt_bbox, orig_w, orig_h, (dx, dy), flip

    def _warn_truncated_gt(self, idx: str, total: int, max_gt: int):
        print('WARNING: {}: {} of {} GT boxes dropped by max_gt={}; '
              'raise max_gt to cover the dataset'.format(
                  idx, total - max_gt, total, max_gt))

    def _padded_gt(self, bi, idx, labels, gt_bbox, max_gt, gt_out,
                   labels_out, num_gt):
        """Write one image's GT rows into the padded batch arrays."""
        if len(gt_bbox) > max_gt:
            self._warn_truncated_gt(idx, len(gt_bbox), max_gt)
        n = min(len(gt_bbox), max_gt)
        gt_out[bi, :n] = gt_bbox[:n]
        labels_out[bi, :n] = np.asarray(labels[:n], np.int32)
        num_gt[bi] = n

    # -- reading ------------------------------------------------------------
    def read_image_batch(self, shuffle: bool = True):
        """Images only, resized on the host (eval's reader).

        Returns (images, scales): a list of [H, W, 3] f32 mean-subtracted
        arrays at model resolution and the per-image (x_scale, y_scale).
        Needs cv2 for ``cv2.resize``, unless the native loader reads the
        batch; :meth:`read_image_rows` (eval's ``--device_dataset``) does
        not.
        """
        mc = self.mc
        if mc.use_native_loader:
            from squeezedet_torch.native import dataloader
            batch_idx = self._next_batch_idx(shuffle)
            images, scales = dataloader.load_image_batch(
                [self._image_path_at(i) for i in batch_idx], mc.image_width,
                mc.image_height, mc.bgr_means, mc.num_thread)
            return list(images), [tuple(map(float, s)) for s in scales]
        cv2 = _opencv()
        if cv2 is None:
            raise ImportError(
                "read_image_batch resizes with OpenCV (cv2), which does not "
                "import here; evaluate with --device_dataset, whose reader "
                "(read_image_rows) resizes on the device and needs no cv2")
        batch_idx = self._next_batch_idx(shuffle)
        images, scales = [], []
        for i in batch_idx:
            im = self._imread(i).astype(np.float32)
            im -= mc.bgr_means_array()
            orig_h, orig_w, _ = [float(v) for v in im.shape]
            im = cv2.resize(im, (mc.image_width, mc.image_height))
            images.append(im)
            scales.append((mc.image_width / orig_w, mc.image_height / orig_h))
        return images, scales

    def read_image_rows(self, shuffle: bool = False):
        """:meth:`read_image_batch` minus the pixels, for device-resident
        eval (``--device_dataset``): the split's canvases stay on the
        device (:meth:`load_canvas_dataset`) and each poll sends only row
        positions and extents.

        Returns (pos [B] i32 rows into the canvas stack, aug [B, 5] f32
        rows (0, 0, 0, orig_w, orig_h) for the on-device resize and
        normalization, scales list of per-image (x_scale, y_scale)).
        """
        mc = self.mc
        batch_idx = self._next_batch_idx(shuffle)
        b = len(batch_idx)
        pos = np.zeros((b,), np.int32)
        aug = np.zeros((b, 5), np.float32)
        scales = []
        for bi, idx in enumerate(batch_idx):
            pos[bi] = self.dataset_position(idx)
            w, h = self._image_size(idx)
            aug[bi] = (0.0, 0.0, 0.0, float(w), float(h))
            scales.append((mc.image_width / w, mc.image_height / h))
        return pos, aug, scales

    def eval_shard_batches(self, batch_size: int):
        """The shard-major sequential plan of device-resident eval over
        :meth:`shard_data`'s D shards: batch t's slot group s covers shard
        s's rows [t*per, (t+1)*per), so replica s gathers only from its
        own block of the canvas stack.

        Yields (pos [B] i32 padded rows of the stack, aug [B, 5] f32
        zero-drift rows, scales list of per-slot (x_scale, y_scale),
        image_indices [B] i64 into ``image_idx``, -1 marking a pad slot).
        Pad slots (past the end of a shard) re-read the shard's row 0 and
        are to be dropped; every image appears exactly once.
        """
        shards = getattr(self, "_data_shards", None)
        if not shards:
            raise ValueError("eval_shard_batches requires shard_data()")
        mc = self.mc
        d = len(shards)
        if batch_size % d:
            raise ValueError("batch {} is not divisible by the {} data "
                             "shards".format(batch_size, d))
        per = batch_size // d
        index_of = {idx: i for i, idx in enumerate(self._image_idx)}
        rows = self._shard_rows
        for t in range(-(-rows // per)):
            pos = np.zeros((batch_size,), np.int32)
            aug = np.zeros((batch_size, 5), np.float32)
            img_is = np.full((batch_size,), -1, np.int64)
            scales = []
            for s, shard in enumerate(shards):
                for k in range(per):
                    b = s * per + k
                    r = t * per + k
                    valid = r < len(shard)
                    idx = shard[r if valid else 0]
                    pos[b] = s * rows + (r if valid else 0)
                    w, h = self._image_size(idx)
                    aug[b] = (0.0, 0.0, 0.0, float(w), float(h))
                    scales.append((mc.image_width / w, mc.image_height / h))
                    if valid:
                        img_is[b] = index_of[idx]
            yield pos, aug, scales, img_is

    def evaluate_detections(self, eval_dir, global_step, all_boxes):
        raise NotImplementedError

    def visualize_detections(self, image_dir, image_format, det_error_file,
                             output_image_dir, num_det_per_type=10):
        """The error-type gallery: up to ``num_det_per_type`` images of
        each error type in ``det_error_file``, drawn with PIL (imported
        here) into ``output_image_dir/<type>/``.  Returns the drawn
        images, BGR."""
        from PIL import Image, ImageDraw

        with open(det_error_file) as f:
            lines = f.readlines()
        random.shuffle(lines)

        dets_per_type: Dict[str, list] = {}
        for line in lines:
            obj = line.strip().split(' ')
            dets_per_type.setdefault(obj[1], []).append({
                'im_idx': obj[0],
                'bbox': [float(obj[2]), float(obj[3]),
                         float(obj[4]), float(obj[5])],
                'class': obj[6],
                'score': float(obj[7]),
            })

        out_ims = []
        color = (200, 200, 0)
        for error_type, dets in dets_per_type.items():
            det_im_dir = os.path.join(output_image_dir, error_type)
            if os.path.exists(det_im_dir):
                shutil.rmtree(det_im_dir)
            os.makedirs(det_im_dir)
            for i in range(min(num_det_per_type, len(dets))):
                det = dets[i]
                im = Image.open(
                    os.path.join(image_dir, det['im_idx'] + image_format))
                draw = ImageDraw.Draw(im)
                draw.rectangle(det['bbox'], outline=color)
                draw.text((det['bbox'][0], det['bbox'][1]),
                          '{:s} ({:.2f})'.format(det['class'], det['score']),
                          fill=color)
                im.save(os.path.join(det_im_dir, str(i) + image_format))
                out_ims.append(np.array(im)[:, :, ::-1])  # RGB -> BGR
        return out_ims

    def read_batch(self, shuffle: bool = True,
                   plan: Optional[BatchPlan] = None):
        """Images + training annotations, resized on the host (cv2).

        Returns (image_per_batch, label_per_batch, delta_per_batch,
        aidx_per_batch, bbox_per_batch) as the reference does.  ``plan``
        supplies pre-drawn sampler decisions (the prefetch path); without
        it one is drawn here, from the same RNG stream.
        """
        import cv2
        mc = self.mc
        if mc.data_augmentation:
            assert mc.drift_x >= 0 and mc.drift_y > 0, \
                'mc.DRIFT_X and mc.DRIFT_Y must be >= 0'
        if plan is None:
            plan = self.draw_batch_plan(shuffle)
        batch_idx = plan.batch_idx

        image_per_batch, label_per_batch = [], []
        bbox_per_batch, delta_per_batch, aidx_per_batch = [], [], []
        debug_stats = AssignStats() if mc.debug_mode else None

        for bi, idx in enumerate(batch_idx):
            im = self._imread(idx).astype(np.float32)
            im -= mc.bgr_means_array()
            orig_h, orig_w, _ = [float(v) for v in im.shape]

            label_per_batch.append([b[4] for b in self._rois[idx][:]])
            gt_bbox = self._gt_boxes_for(idx)

            if mc.data_augmentation:
                im, gt_bbox, orig_w, orig_h, _, _ = self._augment(
                    gt_bbox, orig_w, orig_h, im,
                    plan_aug=plan.augment[bi])

            im = cv2.resize(im, (mc.image_width, mc.image_height))
            image_per_batch.append(im)

            x_scale = mc.image_width / orig_w
            y_scale = mc.image_height / orig_h
            gt_bbox[:, 0::2] *= x_scale
            gt_bbox[:, 1::2] *= y_scale
            bbox_per_batch.append(gt_bbox)

            aidx_per_image, delta_per_image = assign_anchors(
                gt_bbox, np.asarray(mc.anchor_box), stats=debug_stats)
            delta_per_batch.append(delta_per_image)
            aidx_per_batch.append(aidx_per_image)

        if debug_stats is not None:
            debug_stats.dump()
        return (image_per_batch, label_per_batch, delta_per_batch,
                aidx_per_batch, bbox_per_batch)

    def read_batch_raw_targets(self, shuffle: bool = True,
                               max_gt: int = 48,
                               uint8_images: bool = False,
                               plan: Optional[BatchPlan] = None):
        """Like :meth:`read_batch` but with the anchor matcher left to the
        device: the host decodes, augments and resizes (cv2), and pads
        the GT to ``max_gt`` boxes.

        Returns (images [B, H, W, 3] f32 mean-subtracted, or uint8 with
        ``uint8_images``, gt_boxes [B, max_gt, 4] f32, gt_labels
        [B, max_gt] i32, num_gt [B] i32).  The f32 pixels come from the
        native loader under ``mc.use_native_loader``.
        """
        mc = self.mc
        if plan is None:
            plan = self.draw_batch_plan(shuffle)
        batch_idx = plan.batch_idx

        b = len(batch_idx)
        gt_out = np.zeros((b, max_gt, 4), np.float32)
        labels_out = np.zeros((b, max_gt), np.int32)
        num_gt = np.zeros((b,), np.int32)
        if mc.use_native_loader and not uint8_images:
            return self._read_raw_targets_native(plan, max_gt, gt_out,
                                                 labels_out, num_gt)
        import cv2
        images = np.zeros((b, mc.image_height, mc.image_width, 3),
                          np.uint8 if uint8_images else np.float32)
        for bi, idx in enumerate(batch_idx):
            im = self._imread(idx)
            if not uint8_images:
                im = im.astype(np.float32)
                im -= mc.bgr_means_array()
            orig_h, orig_w, _ = [float(v) for v in im.shape]
            labels = [box[4] for box in self._rois[idx][:]]
            gt_bbox = self._gt_boxes_for(idx)

            if mc.data_augmentation:
                im, gt_bbox, orig_w, orig_h, _, _ = self._augment(
                    gt_bbox, orig_w, orig_h, im,
                    plan_aug=plan.augment[bi])

            images[bi] = cv2.resize(im, (mc.image_width, mc.image_height))
            gt_bbox[:, 0::2] *= mc.image_width / orig_w
            gt_bbox[:, 1::2] *= mc.image_height / orig_h
            self._padded_gt(bi, idx, labels, gt_bbox, max_gt, gt_out,
                            labels_out, num_gt)
        return images, gt_out, labels_out, num_gt

    def _read_raw_targets_native(self, plan, max_gt, gt_out, labels_out,
                                 num_gt):
        """:meth:`read_batch_raw_targets` through the native loader: the
        plan's augment decisions (drawn in the reference's order: dy, dx,
        flip) and the GT box math here, the pixel work in the C++
        threads."""
        from squeezedet_torch.native import dataloader
        mc = self.mc
        paths, drifts, flips = [], [], []
        for bi, idx in enumerate(plan.batch_idx):
            paths.append(self._image_path_at(idx))
            orig_w, orig_h = (float(v) for v in self._image_size(idx))
            labels = [box[4] for box in self._rois[idx][:]]
            gt_bbox = self._gt_boxes_for(idx)
            dxdy, flip = (0, 0), False
            if mc.data_augmentation:
                _, gt_bbox, orig_w, orig_h, dxdy, flip = self._augment(
                    gt_bbox, orig_w, orig_h, im=None,
                    plan_aug=plan.augment[bi])
            drifts.append(dxdy)
            flips.append(flip)
            gt_bbox[:, 0::2] *= mc.image_width / orig_w
            gt_bbox[:, 1::2] *= mc.image_height / orig_h
            self._padded_gt(bi, idx, labels, gt_bbox, max_gt, gt_out,
                            labels_out, num_gt)
        images, _ = dataloader.load_train_batch(
            paths, mc.image_width, mc.image_height, mc.bgr_means,
            np.asarray(drifts, np.float32), np.asarray(flips, np.uint8),
            mc.num_thread)
        return images, gt_out, labels_out, num_gt

    def canvas_size(self) -> Tuple[int, int]:
        """(H0, W0) = the largest image extents of the dataset, from the
        headers (cached): the fixed canvas every image is shipped in."""
        if not hasattr(self, "_canvas_hw"):
            h0 = w0 = 0
            for idx in self._image_idx:
                w, h = self._image_size(idx)
                h0, w0 = max(h0, h), max(w0, w)
            self._canvas_hw = (h0, w0)
        return self._canvas_hw

    def _plan_row(self, bi, idx, orig_w, orig_h, plan, max_gt, aug, gt_out,
                  labels_out, num_gt):
        """The GT box math of the canvas and plan-row readers: one aug
        row (dx, dy, flip, ow', oh') and the GT at model resolution."""
        mc = self.mc
        labels = [box[4] for box in self._rois[idx][:]]
        gt_bbox = self._gt_boxes_for(idx)
        dxdy, flip = (0, 0), False
        if mc.data_augmentation:
            _, gt_bbox, orig_w, orig_h, dxdy, flip = self._augment(
                gt_bbox, orig_w, orig_h, im=None, plan_aug=plan.augment[bi])
        # orig_w/orig_h are now the post-drift extents (ow', oh'); the
        # real extents are ow' + dx, oh' + dy
        aug[bi] = (dxdy[0], dxdy[1], float(flip), orig_w, orig_h)
        gt_bbox[:, 0::2] *= mc.image_width / orig_w
        gt_bbox[:, 1::2] *= mc.image_height / orig_h
        self._padded_gt(bi, idx, labels, gt_bbox, max_gt, gt_out,
                        labels_out, num_gt)

    def read_batch_canvas(self, shuffle: bool = True, max_gt: int = 48,
                          plan: Optional[BatchPlan] = None):
        """Raw-canvas batch for the on-device augmentation: the host only
        decodes and does the GT box math.

        Returns (canvas [B, H0, W0, 3] uint8 with each image in its
        top-left corner, aug [B, 5] f32 rows (dx, dy, flip, ow', oh'),
        gt_boxes [B, max_gt, 4] f32 at model resolution, gt_labels
        [B, max_gt] i32, num_gt [B] i32).
        """
        if plan is None:
            plan = self.draw_batch_plan(shuffle)
        b = len(plan.batch_idx)
        h0, w0 = self.canvas_size()
        canvas = np.zeros((b, h0, w0, 3), np.uint8)
        aug = np.zeros((b, 5), np.float32)
        gt_out = np.zeros((b, max_gt, 4), np.float32)
        labels_out = np.zeros((b, max_gt), np.int32)
        num_gt = np.zeros((b,), np.int32)
        for bi, idx in enumerate(plan.batch_idx):
            im = self._imread(idx)
            canvas[bi, :im.shape[0], :im.shape[1]] = im
            self._plan_row(bi, idx, float(im.shape[1]), float(im.shape[0]),
                           plan, max_gt, aug, gt_out, labels_out, num_gt)
        return canvas, aug, gt_out, labels_out, num_gt

    def load_canvas_dataset(self) -> np.ndarray:
        """Decode every image of the split once into one uint8 canvas
        stack [N, H0, W0, 3] (top-left anchored, like the
        :meth:`read_batch_canvas` rows), for ``--device_dataset``; under
        :meth:`shard_data`, every shard's padded block in shard order."""
        h0, w0 = self.canvas_size()
        if getattr(self, "_data_shards", None):
            return self.load_canvas_shards(range(len(self._data_shards)))
        n = len(self._image_idx)
        out = np.zeros((n, h0, w0, 3), np.uint8)
        for i, idx in enumerate(self._image_idx):
            im = self._imread(idx)
            out[i, :im.shape[0], :im.shape[1]] = im
            # the decoded extents are authoritative: the plan-row reader
            # scales GT by _image_size
            self._size_cache[idx] = (im.shape[1], im.shape[0])
        return out

    def load_canvas_shards(self, shard_ids) -> np.ndarray:
        """The canvas stack of the given :meth:`shard_data` shards,
        shard-major, each padded to ``_shard_rows`` rows: the block a
        data-parallel device holds.  Each process decodes only its own
        shards."""
        shards = getattr(self, "_data_shards", None)
        if not shards:
            raise ValueError("load_canvas_shards requires shard_data()")
        h0, w0 = self.canvas_size()
        shard_ids = list(shard_ids)
        out = np.zeros((len(shard_ids) * self._shard_rows, h0, w0, 3),
                       np.uint8)
        for block, s in enumerate(shard_ids):
            for i, idx in enumerate(shards[s]):
                im = self._imread(idx)
                out[block * self._shard_rows + i,
                    :im.shape[0], :im.shape[1]] = im
                self._size_cache[idx] = (im.shape[1], im.shape[0])
        return out

    def dataset_position(self, idx: str) -> int:
        """Row of ``idx`` in :meth:`load_canvas_dataset`'s stack (under
        :meth:`shard_data`, ``shard * _shard_rows + row_in_shard``)."""
        if not hasattr(self, "_dataset_pos"):
            shards = getattr(self, "_data_shards", None)
            if shards:
                self._dataset_pos = {
                    image_id: s * self._shard_rows + i
                    for s, shard in enumerate(shards)
                    for i, image_id in enumerate(shard)}
            else:
                self._dataset_pos = {
                    image_id: i
                    for i, image_id in enumerate(self._image_idx)}
        return self._dataset_pos[idx]

    def read_batch_plan_rows(self, shuffle: bool = True, max_gt: int = 48,
                             plan: Optional[BatchPlan] = None):
        """:meth:`read_batch_canvas` minus the pixels, for the
        device-resident dataset: (pos [B] i32 rows into the stack, aug
        [B, 5] f32, gt_boxes [B, max_gt, 4] f32, gt_labels [B, max_gt]
        i32, num_gt [B] i32), with the same draws and GT math."""
        if plan is None:
            plan = self.draw_batch_plan(shuffle)
        b = len(plan.batch_idx)
        pos = np.zeros((b,), np.int32)
        aug = np.zeros((b, 5), np.float32)
        gt_out = np.zeros((b, max_gt, 4), np.float32)
        labels_out = np.zeros((b, max_gt), np.int32)
        num_gt = np.zeros((b,), np.int32)
        for bi, idx in enumerate(plan.batch_idx):
            pos[bi] = self.dataset_position(idx)
            orig_w, orig_h = [float(v) for v in self._image_size(idx)]
            self._plan_row(bi, idx, orig_w, orig_h, plan, max_gt, aug,
                           gt_out, labels_out, num_gt)
        return pos, aug, gt_out, labels_out, num_gt


class AssignStats:
    """Anchor-assignment IoU statistics for ``debug_mode``."""

    def __init__(self):
        self.avg_ious = 0.0
        self.num_objects = 0
        self.max_iou = 0.0
        self.min_iou = 1.0
        self.num_zero_iou_obj = 0

    def record(self, iou_val: float):
        self.num_objects += 1
        if iou_val <= 0:
            self.min_iou = min(iou_val, self.min_iou)
            self.num_zero_iou_obj += 1
        else:
            self.max_iou = max(iou_val, self.max_iou)
            self.min_iou = min(iou_val, self.min_iou)
            self.avg_ious += iou_val

    def dump(self):
        print('max iou: {}'.format(self.max_iou))
        print('min iou: {}'.format(self.min_iou))
        print('avg iou: {}'.format(
            self.avg_ious / max(self.num_objects, 1)))
        print('number of objects: {}'.format(self.num_objects))
        print('number of objects with 0 iou: {}'.format(
            self.num_zero_iou_obj))


def assign_anchors(gt_bbox: np.ndarray, anchor_box: np.ndarray,
                   stats: Optional[AssignStats] = None
                   ) -> Tuple[List[int], List[List[float]]]:
    """Greedy anchor-target assignment on the host.

    Per GT box in order: the highest-IoU anchor not yet claimed by an
    earlier box of this image; if every positive-IoU anchor is claimed
    (or all IoUs are zero), the nearest unclaimed anchor by squared
    distance in (cx, cy, w, h).  Returns (anchor indices, deltas).
    """
    num_anchors = len(anchor_box)
    aidx_per_image: List[int] = []
    delta_per_image: List[List[float]] = []
    aidx_set = set()
    for i in range(len(gt_bbox)):
        overlaps = batch_iou(anchor_box, gt_bbox[i])
        aidx = num_anchors
        for ov_idx in np.argsort(overlaps)[::-1]:
            if overlaps[ov_idx] <= 0:
                if stats is not None:
                    stats.record(float(overlaps[ov_idx]))
                break
            if ov_idx not in aidx_set:
                aidx_set.add(ov_idx)
                aidx = ov_idx
                if stats is not None:
                    stats.record(float(overlaps[ov_idx]))
                break
        if aidx == num_anchors:
            dist = np.sum(np.square(gt_bbox[i] - anchor_box), axis=1)
            for dist_idx in np.argsort(dist):
                if dist_idx not in aidx_set:
                    aidx_set.add(dist_idx)
                    aidx = dist_idx
                    break

        box_cx, box_cy, box_w, box_h = gt_bbox[i]
        delta = [
            (box_cx - anchor_box[aidx][0]) / anchor_box[aidx][2],
            (box_cy - anchor_box[aidx][1]) / anchor_box[aidx][3],
            float(np.log(box_w / anchor_box[aidx][2])),
            float(np.log(box_h / anchor_box[aidx][3])),
        ]
        aidx_per_image.append(int(aidx))
        delta_per_image.append(delta)
    return aidx_per_image, delta_per_image
