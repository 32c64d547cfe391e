"""K4m_roofline: kernel K4m's least time a frame (roofline/K4m.py) over
its device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.share(t, "K4m")
