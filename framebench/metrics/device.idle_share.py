"""device.idle_share: the share of the traced window in which the
device ran no operation, 1 - (union of its operations' intervals) /
(the window), on the trace's own timeline, averaged over the devices
the run uses; nothing where a device went unrecorded."""
from framebench import profile


def read(t):
    if not t.complete:
        return None
    return 1.0 - profile.busy_s_per_device(t) / t.window_s
