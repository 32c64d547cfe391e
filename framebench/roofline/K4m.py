"""K4's moments filter (filter_moments_kernel), a frame, once for each
SVGF chain: the signal (16 B), moments (8 B), depth (4 B) and normal
(12 B) read once, the signal and its variance written once (20 B); a
7 x 7 stencil's weighted sums, 8 operations a tap at the least."""
NAMES = ("filter_moments_kernel",)


def count(shape):
    n = shape.svgf_chains
    return shape.pixels * 60 * n, shape.pixels * 49 * 8 * n
