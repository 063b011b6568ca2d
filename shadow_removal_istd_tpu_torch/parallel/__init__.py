"""Data parallelism across ranks, two-stage pipeline inference and host
-> device prefetch; the data axis of the JAX package's ``parallel/``.

Spatial row sharding (``make_mesh_2d``, ``image_sharding``) and tensor
parallelism (``make_mesh_tp``, ``make_mesh_3d``, ``model_sharding``,
``gather_model_leaves``) are not ported yet.
"""

from shadow_removal_istd_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    distributed_init,
    is_primary,
    make_mesh,
    shard_batch,
    shard_state,
)
from shadow_removal_istd_tpu_torch.parallel.pipeline import (  # noqa: F401
    StackedPipeline,
    overlap,
)
from shadow_removal_istd_tpu_torch.parallel.prefetch import (  # noqa: F401
    prefetch_to_device,
)
