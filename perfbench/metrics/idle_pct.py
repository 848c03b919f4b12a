"""Share of the traced stretch with nothing running on the card."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
