"""Process groups for data-parallel training (counterpart of
``squeezedet_tpu/parallel/distributed.py``).

The JAX package runs one controller per host and lets XLA insert the
gradient all-reduce over a device mesh.  The port runs one process per
device, a *rank*, joined by ``torch.distributed``: under ``torchrun``
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) or spawned on one
host by :func:`spawn` (the train CLI's ``--num_devices``).

The backend follows one rule, printed when the group starts:

* ``nccl`` when each rank of the host has a CUDA device of its own;
* ``gloo`` on the CPU;
* ``gloo`` when several ranks share one CUDA device, which NCCL refuses.

It is never switched after a failure.  Gloo takes CUDA tensors for
``all_reduce`` and ``broadcast``; the port's other collectives carry
host integers (:meth:`DataParallel.all_gather_ints`), which travel as
CPU tensors under gloo.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

@dataclass(frozen=True)
class DataParallel:
    """This process's place in a data-parallel job: its rank among
    ``world`` ranks, its device and the group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def primary(self) -> bool:
        """Rank 0 writes the job's checkpoints, events and metrics."""
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's slots of the ``batch_size`` batch.  ``batch_size``
        is the global batch in every layout, on one host or several:
        every rank draws the same batch from one seed and trains on its
        share of it."""
        if batch_size % self.world:
            raise ValueError(
                "batch_size={} is not divisible by the {} data-parallel "
                "ranks".format(batch_size, self.world))
        per = batch_size // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        torch.distributed.all_reduce(tensor)
        return tensor

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place."""
        for t in tensors:
            torch.distributed.broadcast(t, src=0)

    def all_gather_ints(self, values: Sequence[int]) -> np.ndarray:
        """Every rank's ``values``, as a [world, len(values)] array."""
        # host integers: gloo gathers CPU tensors; NCCL only device ones
        device = self.device if self.backend == "nccl" else "cpu"
        mine = torch.tensor(list(values), dtype=torch.int64, device=device)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        torch.distributed.all_gather(out, mine)
        return torch.stack(out).cpu().numpy()

    def barrier(self) -> None:
        if self.backend == "nccl":
            torch.distributed.barrier(device_ids=[self.device.index])
        else:
            torch.distributed.barrier()


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank`` for ranks of kind
    ``device``: CUDA card ``local_rank`` modulo the visible cards (ranks
    share a card when there are fewer cards than ranks), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device, local_world: int) -> str:
    """The backend rule of this module's docstring."""
    device = torch.device(device)
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_data_parallel(device, *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       local_world_size: Optional[int] = None
                       ) -> DataParallel:
    """Join the job's process group and return this rank's place in it.

    Each argument left out is read from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; the
    local values default to the global ones, one host), and the group
    meets at ``MASTER_ADDR:MASTER_PORT``.  ``device`` is the kind of
    device the ranks train on (``"cuda"`` or ``"cpu"``); the rank's own
    is :func:`rank_device`.
    """
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size)) \
        if local_world_size is None else local_world_size
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev, local_world_size)
    if dev.type == "cpu":
        # the host's cores are shared by its ranks, as torchrun shares them
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // local_world_size))
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    torch.distributed.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world_size,
        **kwargs)
    if dev.type == "cuda":
        why = ("each rank has a CUDA device of its own" if backend == "nccl"
               else "{} ranks share {} CUDA device(s)".format(
                   local_world_size, torch.cuda.device_count()))
    else:
        why = "CPU ranks"
    print("torch.distributed: rank {} of {} on {}, backend {} ({})".format(
        rank, world_size, dev, backend, why), flush=True)
    return DataParallel(rank, world_size, dev, backend)


def shutdown() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def is_primary_process() -> bool:
    """Whether this process is rank 0, or runs alone."""
    return not torch.distributed.is_initialized() or \
        torch.distributed.get_rank() == 0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, fn, world_size: int, port: int, args) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    fn(*args)


def spawn(fn, world_size: int, *args) -> None:
    """Run ``fn(*args)`` in ``world_size`` new processes on this host,
    each with a launcher environment as ``torchrun --nproc_per_node``
    gives it, and wait for all of them.  ``fn`` must be importable (a
    module-level function).  If one process fails, the others are ended
    and its error raised here."""
    import torch.multiprocessing as mp
    mp.start_processes(_spawned, args=(fn, world_size, free_port(), args),
                       nprocs=world_size, join=True, start_method="spawn")
