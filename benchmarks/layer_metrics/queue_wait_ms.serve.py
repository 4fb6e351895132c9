"""Mean queue wait (ms): the program's ``engine:queue`` spans (submit to
admission into a batch slot) of the requests submitted in the traced
window."""


def read(run):
    waits = [s["end"] - s["start"] for s in run.spans
             if s["name"] == "engine:queue" and run.t0 <= s["start"] < run.t1]
    return sum(waits) / len(waits) * 1e3 if waits else None
