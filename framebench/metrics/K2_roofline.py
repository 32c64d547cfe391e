"""K2_roofline: kernel K2's least time a frame (roofline/K2.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K2")
