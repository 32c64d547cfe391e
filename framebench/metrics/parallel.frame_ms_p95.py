"""parallel.frame_ms_p95: the 95th percentile (nearest rank) of the
traced frames' times, each the harness's "frame" span (the call and the
wait for every card) on the host clock, under the profiler. A sharded
frame is the host's: one thread launches every shard's segment graphs
and the copies between them, so its tail follows the host. Nothing
where no frame span was recorded."""
from framebench import stats


def read(t):
    ms = [(e - s) / 1e3 for name, s, e in t.spans if name == "frame"]
    return stats.percentile(ms, 95.0) if ms else None
