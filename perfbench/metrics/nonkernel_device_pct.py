"""Share of the card's busy time outside the tree kernels: the dispatch's
padding, the vote and every other torch operation."""


def read(t):
    if t.busy_s <= 0 or t.kernel_s <= 0:
        return None
    return 100.0 * (t.busy_s - t.kernel_s) / t.busy_s
