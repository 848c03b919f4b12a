"""Records classified in the window over the window's seconds (host clock)."""


def read(w):
    return w.records / w.seconds
