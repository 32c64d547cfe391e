"""K5_roofline: kernel K5's least time a frame (roofline/K5.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K5")
