"""Small statistics used by the drivers and readers."""

from __future__ import annotations

import numpy as np

# a failed or refused request: later than every limit
FAILED_S = 1e9


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation) of all values."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
