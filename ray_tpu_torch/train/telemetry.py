"""Train goodput accounting: step time, tokens/sec, compile time, and MFU
(port of ``ray_tpu/train/telemetry.py``).

Role-equivalent to the telemetry TorchTitan treats as table stakes for LLM
training (arXiv:2410.06511 — per-step wall time, throughput in tokens/sec,
and model-flops utilization against the accelerator's peak), surfaced here
as ``ray_tpu_train_*`` gauges (flowing to the head's metrics plane) and
merged into ``train.session.report`` metrics.

MFU = (model FLOPs per step) / (step seconds) / (peak FLOP/s of the
devices the step ran on).  The JAX package asks XLA's cost model for the
FLOPs of a step; PyTorch has no such model of a step that runs
hand-written kernels (a FLOP counter of torch's dispatcher cannot see into
them), so ``flops_per_step`` returns None, as the JAX function does on a
backend without a cost model, and callers give the number:
``transformer_flops`` (6 N a token), the 6N + 6·L·S·d convention, or
``set_flops_per_step``.  CPU backends get a nominal peak so MFU stays
finite and tests run everywhere — the absolute value is meaningless
off-accelerator, the *trend* is still useful.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

#: Per-device peak dense FLOP/s (bf16) by device-kind substring, checked in
#: order (the JAX package's table; "NVIDIA H100 80GB HBM3" is ``h100``).
#: Sources: published TPU/GPU spec sheets.
PEAK_FLOPS_TABLE = (
    # JAX's device_kind spells the lite parts "TPU v5 lite" / "TPU v6 lite".
    ("v6 lite", 918e12),  # TPU v6e (Trillium)
    ("v6e", 918e12),
    ("v5 lite", 197e12),  # TPU v5e
    ("v5litepod", 197e12),
    ("v5e", 197e12),
    ("v5p", 459e12),
    ("v5", 459e12),  # bare "TPU v5" device_kind: the p part
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
    ("h100", 989e12),
    ("a100", 312e12),
)

#: Nominal per-core peak for CPU backends: keeps MFU finite in CPU-only
#: smoke runs (the stub the issue calls for); not a real utilization.
CPU_NOMINAL_PEAK_FLOPS = 1e11


def device_peak_flops(device: Optional[Any] = None) -> float:
    """Peak FLOP/s of one device: ``torch.cuda.get_device_name`` of
    ``device`` (the current card when omitted) against the table.  No card,
    or an unknown one, falls back to the CPU nominal rather than raising —
    a telemetry path must never kill a train step."""
    try:
        import torch

        if device is None and not torch.cuda.is_available():
            return CPU_NOMINAL_PEAK_FLOPS
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            return CPU_NOMINAL_PEAK_FLOPS
        kind = torch.cuda.get_device_name(dev).lower()
    except Exception:
        return CPU_NOMINAL_PEAK_FLOPS
    for sub, peak in PEAK_FLOPS_TABLE:
        if sub in kind:
            return peak
    return CPU_NOMINAL_PEAK_FLOPS


def flops_per_step(fn, *args, **kwargs) -> Optional[float]:
    """Model FLOPs of one call of ``fn(*args, **kwargs)`` from a cost model
    of the step.  The port has none (see the module docstring), so this is
    None, the JAX function's answer on a backend without one; callers fall
    back to ``transformer_flops`` or an explicit value."""
    return None


def transformer_flops(num_params: float, tokens: float) -> float:
    """Static fallback: the standard dense-transformer training estimate of
    ~6 FLOPs per parameter per token (fwd 2 + bwd 4)."""
    return 6.0 * float(num_params) * float(tokens)


class TrainTelemetry:
    """Per-process goodput recorder.  One instance per train worker (the
    session owns one); gauges flow to the head via the metrics flusher.

    ``flops_per_step`` and ``peak_flops`` may be set up front (or any time)
    so subsequent steps compute MFU; ``tokens_per_step`` likewise enables
    tokens/sec without passing tokens on every call."""

    def __init__(self, flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 num_devices: Optional[int] = None,
                 tokens_per_step: Optional[float] = None,
                 rank: Optional[int] = None):
        from ..util.metrics import get_gauge

        self.flops_per_step = flops_per_step
        self._peak_flops = peak_flops
        self._num_devices = num_devices
        self.tokens_per_step = tokens_per_step
        # Rank tag keeps each train worker's gauges a distinct series —
        # the head merges same-(name, tags) gauges last-writer-wins, so
        # untagged multi-worker gauges would flip between ranks.
        self._tags = {"rank": str(rank)} if rank is not None else None
        self.last: Dict[str, float] = {}
        self._g_step = get_gauge(
            "ray_tpu_train_step_seconds", "Wall time of the last train step",
            tag_keys=("rank",))
        self._g_tps = get_gauge(
            "ray_tpu_train_tokens_per_sec",
            "Training throughput of the last step", tag_keys=("rank",))
        self._g_mfu = get_gauge(
            "ray_tpu_train_mfu",
            "Model-flops utilization of the last step (0..1)",
            tag_keys=("rank",))
        self._g_compile = get_gauge(
            "ray_tpu_train_compile_seconds",
            "Cumulative compile/tracing seconds observed by this worker",
            tag_keys=("rank",))
        self._compile_total = 0.0

    # -- configuration ---------------------------------------------------------

    def set_flops_per_step(self, flops: Optional[float]) -> None:
        self.flops_per_step = flops

    def peak_flops_total(self) -> float:
        """Aggregate peak FLOP/s across the devices this step runs on."""
        peak = self._peak_flops
        if peak is None:
            peak = device_peak_flops()
        n = self._num_devices
        if n is None:
            try:
                import torch

                n = torch.cuda.device_count()
            except Exception:
                n = 1
        return peak * max(1, n)

    # -- recording -------------------------------------------------------------

    def record_compile(self, seconds: float) -> None:
        self._compile_total += max(0.0, seconds)
        self._g_compile.set(self._compile_total, tags=self._tags)
        self.last["compile_time_s"] = seconds

    def record_step(self, step_time_s: float,
                    tokens: Optional[float] = None,
                    flops: Optional[float] = None,
                    compile_time_s: Optional[float] = None
                    ) -> Dict[str, float]:
        """Record one finished step; returns the derived metrics
        ({step_time_s, tokens_per_sec?, mfu?, compile_time_s?})."""
        out: Dict[str, float] = {"step_time_s": float(step_time_s)}
        self._g_step.set(step_time_s, tags=self._tags)
        if compile_time_s is not None:
            self.record_compile(compile_time_s)
            out["compile_time_s"] = compile_time_s
        tokens = tokens if tokens is not None else self.tokens_per_step
        if tokens and step_time_s > 0:
            out["tokens_per_sec"] = tokens / step_time_s
            self._g_tps.set(out["tokens_per_sec"], tags=self._tags)
        flops = flops if flops is not None else self.flops_per_step
        if flops and step_time_s > 0:
            mfu = flops / step_time_s / self.peak_flops_total()
            out["mfu"] = mfu
            self._g_mfu.set(mfu, tags=self._tags)
        self.last = dict(out)
        return out

    @contextlib.contextmanager
    def step(self, tokens: Optional[float] = None,
             flops: Optional[float] = None):
        """Time a train step: ``with telemetry.step(tokens=...): ...``."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record_step(time.perf_counter() - t0,
                             tokens=tokens, flops=flops)
