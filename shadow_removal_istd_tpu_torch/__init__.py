"""PyTorch/CUDA port of ``shadow_removal_istd_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package re-implements its
serving path (stacked MNet G1 -> G2 in eval mode) in PyTorch, with the
MNet decoder step as a hand-written CUDA kernel (``csrc/``). It imports
neither JAX nor the JAX package.

Every entry point takes ``device=``, ``"cuda"`` by default. Without a
card the default raises: the CPU is used only when asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"``; raises when CUDA is asked
    for and absent, so nothing silently runs on the CPU."""
    try:
        dev = torch.device(device)
    except RuntimeError as exc:      # an unknown device type
        raise ValueError(f"device must be cuda or cpu, got {device!r}"
                         ) from exc
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
