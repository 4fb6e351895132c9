"""Mean decode step (ms): the engine's step records (``util/steprec.py``)
of the decode steps that ended in the traced window, each step's wall
less its prefill stall."""


def read(run):
    walls, last = [], None
    for r in run.steps:
        decoded = last is None or r["step"] > last
        last = r["step"]
        if decoded and run.t0 <= r["t"] <= run.t1:
            walls.append(r["wall_s"] - r["stall_s"])
    return sum(walls) / len(walls) * 1e3 if walls else None
