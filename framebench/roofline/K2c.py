"""K2c, the closest-hit ray query (trace_closest_kernel), a frame: each
ray's origin and direction read once (24 B) and its hit written once
(distance, triangle and two barycentrics, 16 B), no operations; the
tree and its tests left out, as for K2."""
NAMES = ("trace_closest_kernel",)


def count(shape):
    return shape.pixels * shape.radiance_queries * (24 + 16), 0
