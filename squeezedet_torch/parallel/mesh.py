"""Meshes (counterpart of ``squeezedet_tpu/parallel/mesh.py``).

A JAX mesh is a device array that one jitted program spans.  The port's
data-parallel *mesh* is the list of devices of its replicas, one per
coordinate of the data axis: eval and serve hold one replica of the
detector per device in one process and run each replica on its rows of
the batch (:func:`run_replicas`), with no collective; training runs one
process per coordinate (``parallel/distributed.py``).

A :class:`SpatialMesh` (:func:`make_mesh_2d`, :func:`make_mesh_spatial`)
adds the spatial axes: each data coordinate holds ``n_h x n_w`` tiles of
its images (:meth:`SpatialMesh.tiling`, a ``halo.Tiling``), whose
backbone runs tiled with halo exchanges (``models/halo.py``).  The JAX
package's ``image_sharding`` and ``stacked_image_sharding`` (batch over
``data``, height over ``spatial``, width over ``spatial_w``) are the
rows a data coordinate takes (:func:`shard_slices`, or a rank's
``DataParallel.rows``) and its tiling's ``split`` of them, which each
forward applies to its own images, a scanned step's included.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from squeezedet_torch.models.halo import Tiling


def make_mesh(num_devices: int, device) -> List[torch.device]:
    """The devices of ``num_devices`` replicas of kind ``device``: CUDA
    cards 0, 1, ... taken in turn (a card takes several replicas when
    there are fewer cards than replicas), or the CPU for each."""
    from squeezedet_torch.parallel.distributed import rank_device
    if num_devices < 1:
        raise ValueError("a mesh needs at least one device, got {}".format(
            num_devices))
    return [rank_device(device, i) for i in range(num_devices)]


@dataclass(frozen=True)
class SpatialMesh:
    """``devices[d]``: the ``n_h * n_w`` tile devices (row-major) of data
    coordinate ``d``."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    n_h: int
    n_w: int

    @property
    def n_data(self) -> int:
        return len(self.devices)

    def tiling(self, coord: int = 0) -> Tiling:
        """The tiles of data coordinate ``coord``."""
        return Tiling(self.n_h, self.n_w, self.devices[coord])


def _spatial_mesh(n_data: int, n_h: int, n_w: int, device) -> SpatialMesh:
    if min(n_data, n_h, n_w) < 1:
        raise ValueError("mesh axes must be >= 1, got data {} x height {} "
                         "x width {}".format(n_data, n_h, n_w))
    flat = make_mesh(n_data * n_h * n_w, device)
    per = n_h * n_w
    return SpatialMesh(tuple(tuple(flat[d * per:(d + 1) * per])
                             for d in range(n_data)), n_h, n_w)


def make_mesh_2d(n_data: int, n_spatial: int, device) -> SpatialMesh:
    """Data x spatial mesh: ``n_data`` coordinates of the batch, each with
    its images' height over ``n_spatial`` tiles; devices as
    :func:`make_mesh` takes them (tiles share cards when there are fewer
    cards than tiles)."""
    return _spatial_mesh(n_data, n_spatial, 1, device)


def make_mesh_spatial(n_h: int, n_w: int = 1, *, device) -> SpatialMesh:
    """Pure spatial mesh: the whole batch over ``n_h`` (height) x ``n_w``
    (width) tiles, the reference's batch-1 eval protocol spread over
    several devices."""
    return _spatial_mesh(1, n_h, n_w, device)


def spatial_factors(n: int, height: int, width: int,
                    stride: int = 16) -> tuple:
    """Largest (n_h, n_w) with n_h * n_w <= n such that every
    stride-halving conv stage divides evenly over both spatial axes
    (H % (stride * n_h) == 0 and W % (stride * n_w) == 0); (1, 1) when
    no multi-device split qualifies.  Ties prefer the larger n_h.  The
    JAX package's function, which its int8 eval uses (XLA's partitioner
    mis-types an uneven s8 split): the port's halo exchange takes uneven
    splits in int8 too, but its int8 eval keeps the JAX geometry."""
    best = (1, 1)
    for n_h in range(1, n + 1):
        if height % (stride * n_h):
            continue
        for n_w in range(1, n // n_h + 1):
            if width % (stride * n_w):
                continue
            if n_h * n_w >= best[0] * best[1]:
                best = (n_h, n_w)
    return best


def visible_devices(device) -> int:
    """How many devices of ``device``'s kind this process sees (the CPU
    counts as one)."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def auto_mesh(batch_size: int, device) -> Optional[List[torch.device]]:
    """A mesh over the largest count of visible devices that divides the
    batch; None when that is one device."""
    n = visible_devices(device)
    while n > 1 and batch_size % n:
        n -= 1
    return make_mesh(n, device) if n > 1 else None


def data_axis_size(mesh) -> int:
    """Extent of the data axis: 1 for no mesh, else the mesh's length."""
    return 1 if mesh is None else len(mesh)


def local_data_coords(owners: Sequence[int], process: int) -> List[int]:
    """The data-axis coordinates that ``process`` owns, where coordinate
    ``i`` belongs to process ``owners[i]``.

    This is the JAX package's mapping for a process that drives several
    devices; the port's trainer runs one rank per coordinate and loads
    shard ``rank`` directly.  Each process's slots are one block of the
    batch and the blocks follow process order, so the owners must ascend
    along the axis (which also makes each process's coordinates
    contiguous), and the process must own at least one.
    """
    owners = list(owners)
    if any(b < a for a, b in zip(owners, owners[1:])):
        raise ValueError(
            "data-axis owners {} do not ascend in process order: each "
            "process's slots of the batch must follow the previous "
            "process's".format(owners))
    coords = [i for i, p in enumerate(owners) if p == process]
    if not coords:
        raise ValueError("process {} owns no coordinate of the data axis "
                         "(owners {})".format(process, owners))
    return coords


def local_shard_gather(coord: int, block: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Canvas rows ``pos`` (global rows of the shard-major padded stack,
    ``Imdb.shard_data``) from ``block``, the one shard of data-axis
    coordinate ``coord``: the shard-local gather, which needs no
    collective because ``coord``'s slots reference only its shard."""
    return torch.index_select(block, 0,
                              pos.long() - coord * block.shape[0])


def replicate(det, mesh: Sequence[torch.device]) -> list:
    """One replica of ``det`` per mesh device: ``det`` itself on its own
    device (inference reads its weights only, so replicas that share a
    device share them), a copy on each other device."""
    home = det.anchors.device
    copies = {}
    out = []
    for dev in mesh:
        dev = torch.device(dev)
        if dev == home:
            out.append(det)
            continue
        if dev not in copies:
            copies[dev] = copy.deepcopy(det).to(dev)
        out.append(copies[dev])
    return out


def shard_slices(batch_size: int, n: int) -> List[slice]:
    """The rows of each of ``n`` replicas in a ``batch_size`` batch."""
    if batch_size % n:
        raise ValueError("batch {} is not divisible by the {} replicas of "
                         "the mesh".format(batch_size, n))
    per = batch_size // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def run_replicas(fn, replicas: Sequence, inputs: Sequence) -> list:
    """``fn(replica, *replica_inputs)`` for every replica, each on its
    own device and, on CUDA, its own stream, all launched before any is
    waited on.  ``inputs[i]`` is replica i's tuple of tensors, already on
    its device.  Returns each call's outputs copied to the host, a list
    of tuples of tensors.  A lone replica runs on the current stream."""
    if len(replicas) == 1:
        return [tuple(o.cpu() for o in fn(replicas[0], *inputs[0]))]
    outs = []
    for det, args in zip(replicas, inputs):
        dev = det.anchors.device
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for a in args:
                    a.record_stream(stream)
                outs.append((stream, fn(det, *args)))
        else:
            outs.append((None, fn(det, *args)))
    host = []
    for stream, out in outs:
        if stream is not None:
            stream.synchronize()
        host.append(tuple(o.cpu() for o in out))
    return host
