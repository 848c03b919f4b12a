"""Host µs a call blocked on the card in the cascade: the time in
``cascade.sync`` spans (``perfbench/spans.py``), each stage's synchronize and
the survivors' read back."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    return None if s is None else s.self_us(("cascade.sync",))
