"""Engine of the port: configuration, train state, the train / eval /
inference steps, the fused epoch and the trainer."""

from shadow_removal_istd_tpu_torch.engine.steps import infer_step  # noqa: F401
