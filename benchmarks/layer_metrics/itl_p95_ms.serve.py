"""95th percentile inter-token latency (ms), nearest rank, from the
clients' clock: every gap between two consecutive tokens of one request
whose later token arrived in the window: chat's end-to-end ``itl_p95_ms``
until its runs spread too widely for any end-to-end bound."""

import math


def read(run):
    gaps = sorted(run.gaps)
    if not gaps:
        return None
    return gaps[max(0, math.ceil(0.95 * len(gaps)) - 1)] * 1e3
