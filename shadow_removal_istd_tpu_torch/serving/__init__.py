"""Online serving of the port: a bucketed stacked-inference engine and a
micro-batching HTTP daemon."""

from shadow_removal_istd_tpu_torch.serving.engine import (  # noqa: F401
    ArtifactEngine,
    InferenceEngine,
)
from shadow_removal_istd_tpu_torch.serving.server import (  # noqa: F401
    MicroBatcher,
    OverloadedError,
    ServerStats,
    ShadowRemovalServer,
)
