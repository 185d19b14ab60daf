"""Multi-device parallelism on torch.distributed: one process per card, the
chain, snapshot and training batches sharded over a 1-D ``DeviceMesh``
(``mesh.py``, ``sharding.py``), and the FOM grid itself split over the ranks
(``domain.py``). ``dryrun.py`` runs every sharded family once at tiny
shapes."""

from bayesianinferencedl_tpu_torch.parallel.mesh import device_mesh, launch  # noqa: F401
from bayesianinferencedl_tpu_torch.parallel.sharding import (  # noqa: F401
    dp_train_step,
    sharded_da_pcn,
    sharded_pcn,
    sharded_pt_da,
    sharded_pt_mala,
    sharded_pt_pcn,
    sharded_smc,
    sharded_snapshots,
)
from bayesianinferencedl_tpu_torch.parallel.domain import solve_fom_domain_sharded  # noqa: F401
