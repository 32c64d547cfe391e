"""Roofline shares from a trace: a kernel's least time a frame (the
larger of its bytes over the HBM rate and its operations over the
float32 rate, counted by roofline/<kernel>.py from the frame's shape)
over its device time a frame. A kernel that did not run reads
nothing."""
from __future__ import annotations


def bound_ms(t, kernel: str) -> float:
    nbytes, flop = t.rooflines[kernel].count(t.shape)
    return 1e3 * max(nbytes / t.peaks["hbm_bytes_per_s"],
                     flop / t.peaks["fp32_flops_per_s"])


def device_ms(t, kernel: str) -> float:
    return t.per_frame_ms(t.matching(t.rooflines[kernel].NAMES))


def share(t, kernel: str):
    """The kernel's share of its roofline, %; None where it did not run
    or where not every device was traced."""
    if not t.complete:
        return None
    ms = device_ms(t, kernel)
    return None if ms <= 0.0 else 100.0 * bound_ms(t, kernel) / ms


def total_share(t):
    """Every counted kernel's least time over their device time, %."""
    if not t.complete:
        return None
    ran = [k for k in t.rooflines if device_ms(t, k) > 0.0]
    if not ran:
        return None
    return 100.0 * sum(bound_ms(t, k) for k in ran) \
        / sum(device_ms(t, k) for k in ran)
