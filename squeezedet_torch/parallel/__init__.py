"""Data parallelism over ``torch.distributed`` (counterpart of
``squeezedet_tpu/parallel``): process groups and the backend rule
(``distributed.py``), the replica mesh and the shard helpers
(``mesh.py``), and a hermetic multi-process dry run (``dryrun.py``)."""

from squeezedet_torch.parallel.distributed import (  # noqa: F401
    DataParallel,
    init_data_parallel,
    is_primary_process,
    spawn,
)
from squeezedet_torch.parallel.mesh import (  # noqa: F401
    auto_mesh,
    local_data_coords,
    make_mesh,
    replicate,
    run_replicas,
)
