"""Adversarial losses: {standard, least-squares} x {normal, relativistic,
relativistic-average}, for both the D and G directions.

Port of ``shadow_removal_istd_tpu/losses/adversarial.py``, quirks kept:
``mode="reference"`` reproduces what the reference engine executes. Its
``cal_loss`` uses MSE when ``ls`` is False and BCE-with-logits when it is
True (inverted relative to the flag's name), and ``ls`` comes from
comparing ``d_loss_fn`` with the misspelling ``"leastsqure"``, so it is
False for every real flag value: the reference always runs MSE with
labels real=1 / fake=0. ``mode="corrected"`` gives what the flags name
(standard -> BCE, leastsquare -> MSE, fake label 0).

The relativistic average is over the global batch: inside
``parallel.mesh.data_parallel`` every rank's batch sums are summed over
the ranks, with their gradient (``parallel.mesh.batch_mean``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from shadow_removal_istd_tpu_torch.parallel.mesh import batch_mean


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


@dataclass(frozen=True)
class AdversarialLoss:
    """ls: the least-squares flag as the engine computes it; rel:
    relativistic (RpGAN); avg: relativistic-average (RaGAN, with rel);
    mode: "reference" or "corrected"."""

    ls: bool = False
    rel: bool = False
    avg: bool = False
    mode: str = "reference"

    def _labels(self) -> tuple[float, float]:
        if self.mode == "reference":
            return (1.0, -1.0 if self.ls else 0.0)
        return (1.0, 0.0)

    def _cal(self, c_out: torch.Tensor, label: float) -> torch.Tensor:
        c_out = _acc(c_out)
        use_mse = (not self.ls) if self.mode == "reference" else self.ls
        if use_mse:
            return (c_out - label).square().mean()
        # numerically stable sigmoid BCE with logits (optax's form)
        return (-label * F.logsigmoid(c_out)
                - (1.0 - label) * F.logsigmoid(-c_out)).mean()

    def d_loss(self, c_real: torch.Tensor,
               c_fake: torch.Tensor) -> torch.Tensor:
        """Discriminator objective."""
        c_real, c_fake = _acc(c_real), _acc(c_fake)
        real_l, fake_l = self._labels()
        if self.rel:
            if self.avg:  # RaGAN
                lr = self._cal(c_real - batch_mean(c_fake), real_l)
                lf = self._cal(c_fake - batch_mean(c_real), fake_l)
                return (lr + lf) * 0.5
            return self._cal(c_real - c_fake, real_l)  # RpGAN
        lr = self._cal(c_real, real_l)  # SGAN
        lf = self._cal(c_fake, fake_l)
        return (lr + lf) * 0.5

    def g_loss(self, c_real: torch.Tensor,
               c_fake: torch.Tensor) -> torch.Tensor:
        """Generator objective."""
        c_real, c_fake = _acc(c_real), _acc(c_fake)
        real_l, fake_l = self._labels()
        if self.rel:
            if self.avg:  # RaGAN
                lf = self._cal(c_fake - batch_mean(c_real), real_l)
                lr = self._cal(c_real - batch_mean(c_fake), fake_l)
                return (lr + lf) * 0.5
            return self._cal(c_fake - c_real, real_l)  # RpGAN
        return self._cal(c_fake, real_l)  # SGAN


def make_adversarial_loss(d_loss_fn: str, d_type: str,
                          mode: str = "reference") -> AdversarialLoss:
    """Build from the CLI flags as the engine wires them; in reference
    mode ``ls`` compares against the same misspelling ("leastsqure")."""
    if mode == "reference":
        ls = d_loss_fn == "leastsqure"  # [sic]
    else:
        ls = d_loss_fn == "leastsquare"
    return AdversarialLoss(ls=ls, rel="rel" in d_type, avg="avg" in d_type,
                           mode=mode)
