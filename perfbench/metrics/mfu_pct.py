"""Share of the bound (``perfbench/cost.py``) of the stretch's real records
that the whole classification step reaches in the stretch's wall time."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * t.bound_s / t.window_s
