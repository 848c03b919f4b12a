"""Process start to the window's first step (host clock): imports, the
card's context, trees, frames, the program's construction and warm-up."""


def read(w):
    return w.setup_s
