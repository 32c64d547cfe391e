"""K1, the G-buffer raster (raster_tiles_kernel), a frame: one pass
over every pixel that writes at least its visibility: depth, triangle
id and two barycentrics, 16 B in float32. The candidates it reads and
the attributes the port writes beside them are left out, so that the
count stays a lower bound whatever the G-buffer's layout."""
NAMES = ("raster_tiles_kernel",)


def count(shape):
    return shape.pixels * 16, 0
