"""Learning-rate controllers; port of
``shadow_removal_istd_tpu/engine/schedules.py``.

The exponential per-epoch decay is ``engine/state.learning_rate``. This
module holds the legacy tree's ReduceLROnPlateau (reference
STCGAN/stcgan.py:66-71: factor 0.8, cooldown 10, min_lr 1e-7, torch
defaults patience 10 / threshold 1e-4 rel) as a host-side controller
whose ``scale`` multiplies the constant base rate
(``TrainState.lr_scale_g``/``lr_scale_d``). The JAX package scales the
Adam updates by the same factor; the two agree up to f32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    """Torch-semantics plateau controller (mode='min')."""

    base_lr: float
    factor: float = 0.8
    patience: int = 10
    threshold: float = 1e-4      # relative improvement threshold
    cooldown: int = 10
    min_lr: float = 1e-7

    best: float = field(default=float("inf"), init=False)
    num_bad_epochs: int = field(default=0, init=False)
    cooldown_counter: int = field(default=0, init=False)
    current_lr: float = field(init=False)

    def __post_init__(self):
        self.current_lr = self.base_lr

    @property
    def scale(self) -> float:
        return self.current_lr / self.base_lr

    def step(self, metric: float) -> float:
        """Advance one epoch with the monitored value; returns scale.

        Torch's order: improvement check, then cooldown decrement (which
        suppresses bad-epoch counting), then the reduction."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.current_lr = max(self.current_lr * self.factor,
                                  self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter,
                "current_lr": self.current_lr}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.cooldown_counter = d["cooldown_counter"]
        self.current_lr = d["current_lr"]
