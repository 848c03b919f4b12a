"""Share of the bound of the stretch's router work (``perfbench/cost.py``'s
rule: each routed token's projected features read once, the tree's four
tables once, its expert id written once; one launch a layer over a rank's
batch shard) that K1 reaches in its device time on a card."""


def read(t):
    if t.kernel_s <= 0 or t.kernel_bound_s <= 0:
        return None
    return 100.0 * t.kernel_bound_s / t.kernel_s
