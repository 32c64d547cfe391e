"""runtime.capture_ms: the port's own ``capture_ms`` summed over the
keys it captured in set-up (host ms)."""


def read(t):
    return t.counters.get("capture_ms")
