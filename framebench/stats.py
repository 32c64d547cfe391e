"""Arithmetic of a window of frame times."""
from __future__ import annotations

import math


def rate_ms(window_s: float, frames: int) -> float:
    """Milliseconds a frame over the whole window: all the window's time
    over all the frames it completed."""
    if frames <= 0:
        raise ValueError("the window completed no frame")
    return 1e3 * window_s / frames


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100): a frame time that
    was measured, with at least q% of the frames at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]

