"""The engine's ``engine:step`` spans laid on the device trace: the traced
window's decode steps, and the card's busy and idle time inside each
step's phases.

A step span carries its phase stamps on the clock the device trace shares
(``tracing.now()``).  A decode step is in the window when its ``[launch,
synced]`` lies inside ``[t0, t1]``.  Its phases:

- launch: ``[launch, launched]``, the host dispatching the eager step;
- device: ``[launched, synced]``, the host waiting for the token readback;
- host: ``[synced, launch of the next step]``, from the readback to the
  engine's next decode launch: emission, the step record, the loop,
  admission, the prefills' host work and the re-upload of the slot
  mirrors.

Busy time is the device trace's merged busy time (``trace.merged``); idle
time is an interval less the busy time inside it.  A program that emits no
step spans gives no steps, and the readers then find nothing.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, Dict, List, Optional, Tuple


class Busy:
    """The window's merged busy intervals, for the busy time inside any
    interval (bisection over the sorted intervals and their prefix
    sums)."""

    def __init__(self, merged: List[Tuple[float, float, str]]):
        self.starts = [s for s, _, _ in merged]
        self.ends = [e for _, e, _ in merged]
        self.cum = [0.0]
        for s, e, _ in merged:
            self.cum.append(self.cum[-1] + e - s)

    def busy(self, a: float, b: float) -> float:
        i = bisect_right(self.ends, a)   # the first interval ending past a
        j = bisect_left(self.starts, b)  # past the last starting before b
        if b <= a or i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))

    def idle(self, a: float, b: float) -> float:
        return max(0.0, b - a) - self.busy(a, b)


def busy(run) -> Busy:
    """The window's busy intervals."""
    return Busy(run.trace.merged(run.ops, run.t0, run.t1))


def decode_steps(run) -> List[Dict[str, Any]]:
    """The attributes of every decode step in the window, each engine's in
    order of launch."""
    out = []
    for s in run.spans:
        a = s.get("attrs") or {}
        if s.get("name") == "engine:step" and a.get("decoded") \
                and run.t0 <= a["launch"] and a["synced"] <= run.t1:
            out.append(a)
    out.sort(key=lambda a: (a["engine"], a["launch"]))
    return out


def host_gaps(steps: List[Dict[str, Any]]) -> List[Tuple[float, float]]:
    """``(synced, next launch)`` of each pair of consecutive decode steps
    of one engine (the next step's number one higher, so a missing span
    never joins two gaps)."""
    return [(a["synced"], b["launch"]) for a, b in zip(steps, steps[1:])
            if a["engine"] == b["engine"] and b["step"] == a["step"] + 1]


def idle_split(run) -> Optional[Dict[str, float]]:
    """Idle seconds of the window's decode steps by phase (``launch``,
    ``device``, ``host``), beside the window's own idle seconds
    (``window``) and the idle seconds before the first launch and after
    the last readback (``edges``)."""
    steps = decode_steps(run)
    if not steps or not run.ops:
        return None
    b = busy(run)
    return {
        "launch": sum(b.idle(a["launch"], a["launched"]) for a in steps),
        "device": sum(b.idle(a["launched"], a["synced"]) for a in steps),
        "host": sum(b.idle(s, e) for s, e in host_gaps(steps)),
        "window": b.idle(run.t0, run.t1),
        "edges": (b.idle(run.t0, min(a["launch"] for a in steps))
                  + b.idle(max(a["synced"] for a in steps), run.t1)),
        "steps": len(steps),
    }
