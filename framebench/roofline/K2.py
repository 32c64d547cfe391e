"""K2, the any-hit ray query (trace_any_kernel), a frame: each ray's
origin and direction read once (24 B in float32) and its answer written
once (1 B), no operations. The tree is left out, since a query need
not read all of it, and so are the node and triangle tests, which
depend on the tree and not on the frame's shapes."""
NAMES = ("trace_any_kernel",)


def count(shape):
    return shape.pixels * shape.any_hit_queries * (24 + 1), 0
