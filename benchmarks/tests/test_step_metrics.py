"""The readers of the engine's step spans (``bk/steps.py`` and the four
``layer_metrics`` that use it) on synthetic spans and device operations
with answers worked by hand: the window's edges, the idle split that adds
up to the window's idle, and a program with no step spans.  On the card:
the span clock (``tracing.now()``) against the device trace's."""

import json

import numpy as np
import pytest

from conftest import ROOT

from bk import result, spec, steps, trace as tr

READERS = ("decode_device_ms.serve", "launch_idle_ms.serve",
           "step_host_idle_ms.serve", "decode_kv_live.serve")


def _step(step, launch, launched, synced, live=0, read=100,
          decoded=True, engine="e"):
    attrs = {"engine": engine, "step": step, "decoded": decoded,
             "admitted": launch - 0.05, "prefilled": launch - 0.01,
             "prefills": 0}
    if decoded:
        attrs.update(launch=launch, launched=launched, synced=synced,
                     occupancy=1, kv_live=live, kv_read=read)
    return {"trace_id": "t", "span_id": str(step), "parent_id": None,
            "name": "engine:step", "start": launch - 0.1,
            "end": (synced if decoded else launch) + 0.01, "attrs": attrs}


#: Window [0, 10].  The first step starts before the window and the last
#: ends after it: both are cut and left out.  Between them three decode
#: steps, a prefill kernel in the first host gap, two overlapping kernels
#: in the second step, and a prefill-only step and a request span that
#: the readers pass over.
SPANS = [
    _step(1, -0.5, -0.4, 0.5),
    _step(2, 1.0, 1.2, 3.0, live=10),
    _step(3, 3.5, 3.6, 5.0, live=20),
    _step(4, 5.5, 5.7, 7.0, live=30),
    _step(4, 7.5, 0, 0, decoded=False),
    _step(5, 9.0, 9.1, 10.5, live=40),
    {"trace_id": "r", "span_id": "q", "parent_id": None,
     "name": "engine:queue", "start": 2.0, "end": 4.0},
]
OPS = [("k0", -0.3, 0.8), ("k1", 1.1, 2.9), ("prefill", 3.1, 3.3),
       ("k2a", 3.55, 4.0), ("k2b", 3.9, 4.9), ("k3", 5.5, 6.8),
       ("k4", 9.05, 10.2)]


def _run(spans=SPANS, ops=OPS, t0=0.0, t1=10.0):
    return result.Run(kind="serve", config={}, mix={}, ops=list(ops),
                      t0=t0, t1=t1, spans=list(spans), steps=[])


def _read(name, run):
    return spec.layer_reader(name, ROOT)(run)


def test_decode_steps_in_the_window():
    got = [a["step"] for a in steps.decode_steps(_run())]
    assert got == [2, 3, 4]
    # Two engines keep their own order, and their own host gaps.
    other = [_step(7, 1.5, 1.6, 2.0, engine="f"),
             _step(8, 2.5, 2.6, 3.0, engine="f")]
    st = steps.decode_steps(_run(SPANS + other))
    assert [(a["engine"], a["step"]) for a in st] == [
        ("e", 2), ("e", 3), ("e", 4), ("f", 7), ("f", 8)]
    assert steps.host_gaps(st) == [(3.0, 3.5), (5.0, 5.5), (2.0, 2.5)]


@pytest.mark.parametrize("name,want", [
    # Busy inside [launch, synced]: 1.8, 1.35 (overlap merged), 1.3 s.
    ("decode_device_ms.serve", (1.8 + 1.35 + 1.3) / 3 * 1e3),
    # Idle inside [launch, launched]: 0.1, 0.05, 0 s.
    ("launch_idle_ms.serve", (0.1 + 0.05 + 0.0) / 3 * 1e3),
    # Idle from a readback to the next launch: 0.3 (a 0.2-s prefill
    # kernel in 0.5 s), 0.5 s; the last step's next one is cut.
    ("step_host_idle_ms.serve", (0.3 + 0.5) / 2 * 1e3),
    ("decode_kv_live.serve", 60 / 300 * 100),
])
def test_reader_hand_answers(name, want):
    assert _read(name, _run()) == pytest.approx(want, abs=1e-9)


def test_itl_tail_reader_takes_the_nearest_rank():
    """The clients' gaps' 95th percentile by nearest rank: of 40 gaps,
    the 38th smallest; a run without gaps reads nothing."""
    run = _run()
    run.gaps = [i / 1e3 for i in range(40, 0, -1)]
    assert _read("itl_p95_ms.serve", run) == pytest.approx(38.0)
    assert _read("itl_p95_ms.serve", _run()) is None


def test_idle_split_adds_up_to_the_window():
    """The idle inside each step's launch and readback waits, between
    steps, and before the first launch and after the last readback, is
    the window's idle, to rounding."""
    s = steps.idle_split(_run())
    assert s["steps"] == 3
    assert s["launch"] == pytest.approx(0.15)
    assert s["device"] == pytest.approx(0.1 + 0.1 + 0.2)
    assert s["host"] == pytest.approx(0.3 + 0.5)
    assert s["edges"] == pytest.approx(0.2 + 3.0 - 0.95)
    busy = tr.busy_s(OPS, 0.0, 10.0)
    assert s["window"] == pytest.approx(10.0 - busy) == pytest.approx(3.6)
    assert s["launch"] + s["device"] + s["host"] + s["edges"] \
        == pytest.approx(s["window"], abs=1e-12)


def test_a_missing_span_joins_no_gap():
    """A step whose span is missing leaves its neighbours' gap out rather
    than counting two steps' host time as one."""
    spans = [s for s in SPANS if (s.get("attrs") or {}).get("step") != 3]
    assert steps.host_gaps(steps.decode_steps(_run(spans))) == []
    assert _read("step_host_idle_ms.serve", _run(spans)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_step_spans_reads_nothing(name):
    """The parent program emits no step spans: every reader finds nothing
    and the line leaves the metric out."""
    spans = [s for s in SPANS if s["name"] != "engine:step"]
    assert _read(name, _run(spans)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_run_without_a_device_trace(name):
    """No device operations (a CPU run): the device readers read nothing;
    the live share, a count of the engine's, still reads."""
    got = _read(name, _run(ops=[]))
    if name == "decode_kv_live.serve":
        assert got == pytest.approx(20.0)
    else:
        assert got is None


@pytest.mark.parametrize("seed", range(4))
def test_busy_bisection_against_the_merge(seed):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, 10, 60))
    ops = [(f"k{i}", float(s), float(s + rng.exponential(0.2)))
           for i, s in enumerate(starts)]
    b = steps.Busy(tr.merged(ops, -1.0, 12.0))
    for a, e in rng.uniform(-1, 12, (200, 2)):
        a, e = min(a, e), max(a, e)
        assert b.busy(a, e) == pytest.approx(tr.busy_s(ops, a, e),
                                             abs=1e-12)
        assert b.idle(a, e) == pytest.approx(e - a - tr.busy_s(ops, a, e),
                                             abs=1e-12)
    assert b.busy(5.0, 5.0) == 0.0 and b.idle(6.0, 5.0) == 0.0


@pytest.mark.card
def test_span_clock_on_the_card(card):
    """``tracing.now()`` stamped around each launch of a spinning kernel
    and its synchronise, under the harness's device trace: each kernel's
    [start, end] lies inside its stamps.  Prints the offsets (kernel start
    less the stamp before the launch, stamp after the synchronise less
    the kernel's end) as one JSON line."""
    import torch

    from ray_tpu_torch.util import tracing

    spin = 10_000_000  # cycles: about 5 ms at the H100's 1.98 GHz
    torch.cuda._sleep(spin)  # the first launch's set-up stays outside
    torch.cuda.synchronize(card)
    trace = tr.DeviceTrace(card)
    trace.start()
    stamps = []
    for _ in range(20):
        before = tracing.now()
        torch.cuda._sleep(spin)
        torch.cuda.synchronize(card)
        stamps.append((before, tracing.now()))
    trace.stop(window=(stamps[0][0] - 1.0, stamps[-1][1] + 1.0))
    kernels = sorted(op for op in trace.ops if "spin" in op[0])
    assert len(kernels) == len(stamps), [op[0] for op in trace.ops][:10]
    lead = [k[1] - s[0] for k, s in zip(kernels, stamps)]
    tail = [s[1] - k[2] for k, s in zip(kernels, stamps)]
    print("span_clock " + json.dumps({
        "device": torch.cuda.get_device_name(card),
        "kernel_ms": [round((k[2] - k[1]) * 1e3, 4) for k in kernels][:3],
        "lead_us": [min(lead) * 1e6, float(np.median(lead)) * 1e6,
                    max(lead) * 1e6],
        "tail_us": [min(tail) * 1e6, float(np.median(tail)) * 1e6,
                    max(tail) * 1e6]}))
    assert min(lead) >= 0 and min(tail) >= 0
