"""Shadow-parameter (sp) preprocessing; port of the part of
``shadow_removal_istd_tpu/tools/preprocess.py`` that ``data/h5.py``'s
``build_h5`` needs: the reference's ratio sp (src/utils.py:45-47)."""

from __future__ import annotations

import numpy as np


def compute_sp(shadowed: np.ndarray, shadowless: np.ndarray) -> np.ndarray:
    """Per-pixel shadow parameters (float32): shadowless / shadowed, with
    zero shadowed pixels counted as 1."""
    shadowed = shadowed.copy()
    shadowed[shadowed == 0] = 1
    return shadowless.astype(np.float32) / shadowed.astype(np.float32)
