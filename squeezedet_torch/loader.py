"""Multi-threaded host prefetch of training batches (counterpart of
``squeezedet_tpu/loader.py``).

Worker threads read batches into a bounded queue while the consumer
trains.  Each worker first draws a :class:`~squeezedet_torch.data.imdb.
BatchPlan` (all of the batch's RNG draws, atomically under the sampler
lock), does the decode and box math without the lock, then enqueues in
plan order by ticket: the stream the consumer sees is a deterministic
function of the seed for any thread count, and each item carries the
sampler snapshot taken right after its own draws.  ``consumed_state()``
is the snapshot of the last item handed out; checkpointing it makes
resume exact.

``rows`` keeps only those slots of each drawn batch (a data-parallel
rank's share); the draws, and so the stream, are the whole batch's.

Items, by mode: ``(images f32, Targets)`` (host targets);
``(images, gt, labels, num_gt)`` (device matcher); ``(canvas, aug, gt,
labels, num_gt)`` (``device_augment``); ``(pos, aug, gt, labels,
num_gt)`` (``device_dataset``, whose pixels already sit on the device).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from squeezedet_torch.data.targets import batch_to_dense_targets


class PrefetchLoader:
    """Background producers of training batches, in draw order."""

    def __init__(self, imdb, *, num_threads: Optional[int] = None,
                 capacity: Optional[int] = None, shuffle: bool = True,
                 device_targets: bool = False, max_gt: int = 48,
                 uint8_images: bool = False,
                 device_augment: bool = False,
                 device_dataset: bool = False,
                 rows: Optional[slice] = None):
        mc = imdb.mc
        self._rows = rows
        self._imdb = imdb
        self._shuffle = shuffle
        self._device_targets = device_targets
        self._max_gt = max_gt
        self._uint8_images = uint8_images
        self._device_augment = device_augment
        self._device_dataset = device_dataset
        self._num_anchors = mc.anchors
        self._num_classes = mc.classes
        self._queue: queue.Queue = queue.Queue(
            maxsize=capacity if capacity is not None else
            max(2, mc.queue_capacity // max(1, mc.batch_size)))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._enq_cv = threading.Condition()
        self._next_enq_seq: Optional[int] = None
        self._consumed_state: Optional[Dict[str, np.ndarray]] = None
        n = num_threads if num_threads is not None else mc.num_thread
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, n))]

    def start(self) -> "PrefetchLoader":
        # Tickets start at the imdb's current draw sequence; while this
        # loader runs its workers must be the only plan drawers.
        self._next_enq_seq = self._imdb.next_draw_seq()
        for t in self._threads:
            t.start()
        return self

    def _read(self, plan):
        imdb = self._imdb
        if self._device_dataset:
            return imdb.read_batch_plan_rows(max_gt=self._max_gt, plan=plan)
        if self._device_augment:
            return imdb.read_batch_canvas(max_gt=self._max_gt, plan=plan)
        if self._device_targets:
            return imdb.read_batch_raw_targets(
                max_gt=self._max_gt, uint8_images=self._uint8_images,
                plan=plan)
        return batch_to_dense_targets(
            imdb.read_batch(plan=plan), num_anchors=self._num_anchors,
            num_classes=self._num_classes)

    def _worker(self):
        try:
            while not self._stop.is_set():
                plan = self._imdb.draw_batch_plan(shuffle=self._shuffle)
                item = self._read(plan if self._rows is None
                                  else plan.select(self._rows))
                # ticketed enqueue: wait for this plan's turn, so batches
                # reach the queue in draw order
                with self._enq_cv:
                    while plan.seq != self._next_enq_seq:
                        if self._stop.is_set():
                            return
                        self._enq_cv.wait(0.2)
                enqueued = False
                while not self._stop.is_set():
                    try:
                        self._queue.put((item, plan.state), timeout=0.5)
                        enqueued = True
                        break
                    except queue.Full:
                        continue
                if enqueued:
                    with self._enq_cv:
                        self._next_enq_seq = plan.seq + 1
                        self._enq_cv.notify_all()
        except BaseException as e:  # handed to the consumer by get()
            self._error = e
            self._stop.set()
            with self._enq_cv:
                self._enq_cv.notify_all()

    def get(self, timeout: float = 60.0):
        """The next item; raises the producer's error if one failed."""
        while True:
            if self._error is not None:
                raise RuntimeError("prefetch worker failed") from self._error
            try:
                item, state = self._queue.get(timeout=min(timeout, 1.0))
                self._consumed_state = state
                return item
            except queue.Empty:
                timeout -= 1.0
                if timeout <= 0:
                    raise TimeoutError("prefetch queue starved for 60 s")

    def consumed_state(self) -> Optional[Dict[str, np.ndarray]]:
        """Sampler snapshot of the last item :meth:`get` returned (None
        before the first): checkpoint this, not ``imdb.sampler_state()``,
        which runs ahead by the prefetch lead."""
        return self._consumed_state

    def stop(self):
        self._stop.set()
        with self._enq_cv:
            self._enq_cv.notify_all()
        # drain so producers blocked on put() can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)
