"""ops.device_ms.sharded: ops.device_ms (see its reader) in the sharded cells,
where it moves frame_ms.sharded."""
from framebench import spec

read = spec.metric("ops.device_ms")
