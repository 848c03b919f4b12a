"""Share of the card's busy time in NCCL's kernels (the collectives between
cards), each card's union averaged over the cards."""


def read(t):
    if t.busy_s <= 0 or t.collective_s <= 0:
        return None
    return 100.0 * t.collective_s / t.busy_s
