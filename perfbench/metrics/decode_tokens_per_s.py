"""Tokens decoded in the window over the window's seconds (host clock, rank
0's): every row's token of every decode step, one a row a step."""


def read(w):
    return w.records / w.seconds
