"""Parallelism across ranks, two-stage pipeline inference and host ->
device prefetch; the JAX package's ``parallel/``.

``mesh.py``: the (data, spatial, model) mesh of ranks, the data axis's
collectives and the state's placement; ``spatial.py``: row slabs and
halo exchanges of the forward; ``tensor.py``: column-parallel layers
over the model axis.
"""

from shadow_removal_istd_tpu_torch.parallel.mesh import (  # noqa: F401
    MODEL_AXIS,
    SPATIAL_AXIS,
    Mesh,
    distributed_init,
    gather_model_leaves,
    image_sharding,
    is_primary,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    make_mesh_tp,
    model_sharding,
    shard_batch,
    shard_images,
    shard_state,
    train_batch_sharding,
    unshard_state,
)
from shadow_removal_istd_tpu_torch.parallel.pipeline import (  # noqa: F401
    StackedPipeline,
    overlap,
)
from shadow_removal_istd_tpu_torch.parallel.prefetch import (  # noqa: F401
    prefetch_to_device,
)
