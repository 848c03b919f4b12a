"""Host µs a call in the vote and the cascade's own Python: the self time of
the ``cascade.*`` and ``forest.*`` spans (``perfbench/spans.py``), less the
cascade's blocking reads (``cascade.sync``) and metric observations
(``cascade.observe``)."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    if s is None:
        return None
    return s.self_us(("cascade.", "forest."), exclude=("cascade.sync", "cascade.observe"))
