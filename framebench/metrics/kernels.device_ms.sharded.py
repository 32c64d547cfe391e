"""kernels.device_ms.sharded: kernels.device_ms (see its reader) in the sharded cells,
where it moves frame_ms.sharded."""
from framebench import spec

read = spec.metric("kernels.device_ms")
