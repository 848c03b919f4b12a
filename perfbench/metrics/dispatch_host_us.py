"""Host µs a call in the tuned entry itself: the self time of the ``tune.*``
spans (``perfbench/spans.py``), the entry's checks, memo probe and padding."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    return None if s is None else s.self_us(("tune.",))
