"""Steps of the port (stacked inference so far)."""

from shadow_removal_istd_tpu_torch.engine.steps import infer_step  # noqa: F401
