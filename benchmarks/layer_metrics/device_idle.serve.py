"""Share of the traced window (%) in which no operation ran on the card
(overlapping operations merged)."""


def read(run):
    if not run.ops or run.t1 <= run.t0:
        return None
    busy = run.trace.busy_s(run.ops, run.t0, run.t1)
    return (1 - busy / (run.t1 - run.t0)) * 100
