"""K2c_roofline: kernel K2c's least time a frame (roofline/K2c.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K2c")
