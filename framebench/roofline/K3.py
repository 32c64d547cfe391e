"""K3, SVGF's temporal history fetch (temporal_fetch_kernel), a frame,
once for each SVGF chain: the history's signal (4 channels) and moments
(2) read at the configuration's svgf_bits, the current and the
previous depth read to validate them (8 B), the reprojected signal,
moments and history length written as float32 (28 B)."""
NAMES = ("temporal_fetch_kernel",)


def count(shape):
    per_px = 6 * shape.svgf_bytes + 8 + 28
    return shape.pixels * per_px * shape.svgf_chains, 0
