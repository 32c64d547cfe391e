"""parallel.copy_ms: device ms a frame of the copies between two cards,
summed over the cards: the row exchanges' halo and gather copies
between graph segments and the image's gather to the first card. The
profiler records each as a peer-to-peer memcpy, "Memcpy PtoP (Device ->
Device)"; a copy within one card ("Memcpy DtoD") is not counted.
Nothing where a card went unrecorded or no copy between cards ran."""

PEER = "Memcpy PtoP"


def read(t):
    if not t.complete:
        return None
    ops = [o for o in t.ops if o[0].startswith(PEER)]
    return t.per_frame_ms(ops) if ops else None
