"""device.idle_share.sharded: device.idle_share (see its reader) in the sharded cells,
where it moves frame_ms.sharded."""
from framebench import spec

read = spec.metric("device.idle_share")
