"""Mean device time of a decode step (ms): over the engine's decode steps
in the traced window (``engine:step`` spans, ``bk/steps.py``), the card's
merged busy time inside each step's ``[launch, synced]``, from the eager
step's launch to its token readback."""

from bk import steps


def read(run):
    st = steps.decode_steps(run)
    if not st or not run.ops:
        return None
    b = steps.busy(run)
    return sum(b.busy(a["launch"], a["synced"]) for a in st) / len(st) * 1e3
