"""Device meshes, halo exchange, sharded pipelines and solvers.

Counterpart of :mod:`darsia_tpu.parallel`.  A mesh names torch devices, a
device possibly several times (``cuda:0`` eight times checks an 8-device
mesh on one card; ``cpu`` eight times on the CPU); a sharded array is a
nested list of tensors, one per mesh position on its device; the shards meet
only in :mod:`.collectives`.  The batched W1 solve runs many pairs as a
leading tensor axis of one loop on one device.
"""

from .beckmann import sharded_beckmann_newton
from .halo import halo_exchange, halo_exchange_2d
from .mesh import Mesh, Placement, batch_sharding, create_mesh
from .pipeline import (
    sharded_analysis_step,
    sharded_production_pipeline,
    sharded_tvd,
    sharded_tvd_2d,
)
from .tpfa import sharded_tpfa_cg
from .warp import sharded_warp
from .wasserstein import batched_wasserstein, sharded_wasserstein_batch

__all__ = [
    "Mesh",
    "Placement",
    "batch_sharding",
    "batched_wasserstein",
    "create_mesh",
    "halo_exchange",
    "halo_exchange_2d",
    "sharded_analysis_step",
    "sharded_beckmann_newton",
    "sharded_production_pipeline",
    "sharded_tpfa_cg",
    "sharded_tvd",
    "sharded_tvd_2d",
    "sharded_warp",
    "sharded_wasserstein_batch",
]
