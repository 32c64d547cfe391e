"""K4's a-trous step (atrous_kernel), a frame, ``svgf_atrous_iterations``
steps for each SVGF chain: the signal (16 B), depth (4 B) and normal
(12 B) read once and the signal written once (16 B); a 5 x 5 stencil's
weighted sums, 8 operations a tap at the least."""
NAMES = ("atrous_kernel",)


def count(shape):
    n = shape.svgf_chains * shape.atrous_steps
    return shape.pixels * 48 * n, shape.pixels * 25 * 8 * n
