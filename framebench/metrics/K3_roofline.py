"""K3_roofline: kernel K3's least time a frame (roofline/K3.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K3")
