"""kernels_roofline: the least time of every counted kernel that ran
(roofline/) over their device time, %."""
from framebench import rooflines


def read(t):
    return rooflines.total_share(t)
