"""kernels.device_ms: device ms a frame of the port's own CUDA kernels
(the ``__global__`` functions of its csrc/), summed over devices."""


def read(t):
    if not t.complete:
        return None
    return t.per_frame_ms([o for o in t.ops if t.is_port_kernel(o[0])])
