"""ops.device_ms: device ms a frame of every other device operation:
PyTorch's own kernels, copies, sorts and scans, summed over devices."""


def read(t):
    if not t.complete:
        return None
    return t.per_frame_ms([o for o in t.ops if not t.is_port_kernel(o[0])])
