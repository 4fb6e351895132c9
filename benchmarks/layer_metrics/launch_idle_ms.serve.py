"""Mean launch idle of a decode step (ms): over the engine's decode steps
in the traced window (``engine:step`` spans, ``bk/steps.py``), the time
inside ``[launch, launched]`` in which nothing ran on the card: the host
dispatching the eager step's operations faster or slower than the card
runs them."""

from bk import steps


def read(run):
    st = steps.decode_steps(run)
    if not st or not run.ops:
        return None
    b = steps.busy(run)
    return sum(b.idle(a["launch"], a["launched"]) for a in st) / len(st) \
        * 1e3
