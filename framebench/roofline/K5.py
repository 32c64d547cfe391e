"""K5, the TAA history fetch (window_sample_kernel), a frame, once for
each history fetch: each pixel's uv read (8 B), the history's three
float32 planes read once (12 B) and the sample written (12 B), no
operations: the bytes of chip_smoke.py's bound at 1080p, where every
row of the history is reached."""
from framebench.frame_shape import TAA_PLANES

NAMES = ("window_sample_kernel",)


def count(shape):
    per_px = 8 + 4 * TAA_PLANES + 4 * TAA_PLANES
    return shape.pixels * per_px * shape.taa_fetches, 0
