"""K1's share of the bound of the stretch's router work in a model cell
(``perfbench/cost.py``'s rule: each routed token's projected features read
once, the tree's four tables once, its expert id written once; one launch a
layer over a rank's batch shard), in K1's device time on a card.  Every
model cell reads it through this file: ``router_roofline_pct.<cell>``."""


def read(t):
    if t.kernel_s <= 0 or t.kernel_bound_s <= 0:
        return None
    return 100.0 * t.kernel_bound_s / t.kernel_s
