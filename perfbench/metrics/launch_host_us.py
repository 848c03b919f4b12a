"""Host µs a call in the kernels' wrappers and launch: the time in the
``kernel.*`` spans (``perfbench/spans.py``), argument checks, tile choice,
allocation, the library handle, the stream and the ctypes call."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    return None if s is None else s.self_us(("kernel.",))
