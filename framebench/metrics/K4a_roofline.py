"""K4a_roofline: kernel K4a's least time a frame (roofline/K4a.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K4a")
