"""Share of the bound (``perfbench/cost.py``) of the stretch's real records
that the tree kernels reach in their device time: the kernels' layer."""


def read(t):
    if t.kernel_s <= 0:
        return None
    return 100.0 * t.bound_s / t.kernel_s
