"""Host µs a call in the cascade's histogram observations: the time in
``cascade.observe`` spans (``perfbench/spans.py``), the exit margins' copy
to the host included."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    return None if s is None else s.self_us(("cascade.observe",))
