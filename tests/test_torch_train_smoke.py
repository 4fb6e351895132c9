"""``chip_smoke.phase_train_gang`` rehearsed on the CPU (``dev="cpu"``):
the tiny model stands in for Llama-3-8B and for the 2-layer model at its
widths, and the card's tools are not reached (the card line is passed
in).  ``TorchTrainer`` runs the phase's loop on one worker: six steps
reported with their losses, milliseconds and the session's MFU; then a
worker killed after its step-2 checkpoint is replaced and its step-3 loss
equals an uninterrupted run's bit for bit.  The csrc kernels launch none
on the CPU."""

import numpy as np
import torch


def test_chip_smoke_train_gang_phase_runs_on_cpu(monkeypatch):
    import chip_smoke as cs

    # One intra-op thread in the gang's workers: the model is tiny, and
    # the suite runs other clusters beside this one.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report = {}
    cs.phase_train_gang(torch, report, 0, "cpu", dev="cpu")
    out = report["train_gang"]
    assert not any(out["launches"].values())
    assert out["steps"] == cs.GANG_STEPS == len(out["losses"])
    assert all(np.isfinite(out["losses"])) and out["step_ms"] > 0
    assert len(out["mfu_each"]) == cs.GANG_STEPS - 1 and out["mfu"] > 0
    assert out["visible"] == ""  # a CPU gang's worker is granted no card
    r = out["restore"]
    assert r["killed"] and r["processes"] == 2
    assert r["losses"] == r["uninterrupted"]
