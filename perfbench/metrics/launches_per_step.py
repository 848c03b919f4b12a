"""Kernels the card ran in the traced stretch over the driver's steps in it
(copies and fills not counted; on several cards each card's, averaged): a
model cell's launches a decode step, which a cut in the step's launches
moves."""


def read(t):
    if t.launches <= 0 or t.steps <= 0:
        return None
    return t.launches / t.steps
