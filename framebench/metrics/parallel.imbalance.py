"""parallel.imbalance: the busiest card's busy time in the traced window
(the union of its operations' intervals) over the mean of the cards'
busy times, >= 1: a sharded frame waits for its busiest card. Nothing
on one card, or where a card went unrecorded."""
from framebench import profile


def read(t):
    if t.devices < 2 or not t.complete:
        return None
    busy = [profile.busy_us(t, d) for d in range(t.devices)]
    return max(busy) * len(busy) / sum(busy)
