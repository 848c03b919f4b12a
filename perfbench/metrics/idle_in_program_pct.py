"""Share of the card's idle time in the traced stretch whose gap midpoint
falls under a program span (``perfbench/spans.py``): idle the program's own
host work leaves, against the caller's loop around it."""

from perfbench import spans


def read(t):
    s = spans.of(t)
    if s is None or s.idle_s <= 0:
        return None
    return 100.0 * s.idle_in_program_share()
