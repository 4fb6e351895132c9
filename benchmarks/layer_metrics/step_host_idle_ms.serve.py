"""Mean host idle between decode steps (ms): over each pair of consecutive
decode steps in the traced window (``engine:step`` spans,
``bk/steps.py``), the time from the first's token readback (``synced``) to
the second's launch in which nothing ran on the card: token emission, the
step record, the loop, admission, the prefills' host work and the
re-upload of the slot mirrors."""

from bk import steps


def read(run):
    gaps = steps.host_gaps(steps.decode_steps(run))
    if not gaps or not run.ops:
        return None
    b = steps.busy(run)
    return sum(b.idle(s, e) for s, e in gaps) / len(gaps) * 1e3
