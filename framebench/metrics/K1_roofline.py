"""K1_roofline: kernel K1's least time a frame (roofline/K1.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K1")
