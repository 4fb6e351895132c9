"""Continuous-batching LLM inference engine (port of
``ray_tpu/serve/engine.py``).

The host half is the JAX engine's, copied: a dedicated loop thread;
weighted-fair admission between decode steps with a bounded wait queue that
sheds with :class:`EngineOverloadedError`; cancel and evict at step
boundaries with pages returned to the free list; bucketed prefill; ONE
batched token readback per decode step; ``stats()``.
The device half runs the port's paged programs (``models/paged.py``) on
torch tensors: the KV pool is updated in place, the tokens, lengths and
sampling generator stay on the device between steps, and the host mirrors
are re-uploaded only when slot membership changes.

Not ported yet (ROADMAP.md, PyTorch/CUDA port, rest of serving): the radix
prefix cache (``prefix_cache=True`` raises ``NotImplementedError``), LoRA
adapters (``adapter=`` raises ``NotImplementedError``; the programs take the
zero adapter slot as data), the step flight recorder, tracing spans and the
metrics registry (plain counters on the engine stand in), and the serve
binding (``LLMServer`` / ``llm_app``) with the SLO signals its autoscaler
reads.
"""

from __future__ import annotations

import dataclasses
import math
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.paged import (PageAllocator, call_counts, init_adapter_pool,
                            init_paged_pools, paged_decode_step,
                            paged_prefill, trace_counts)

_NOT_PORTED = ("not ported yet; see ROADMAP.md, PyTorch/CUDA port: rest of "
               "serving")


class EngineOverloadedError(Exception):
    """Typed admission-control shed: the engine's wait queue is full.
    Callers see this at submit time (the request never held pages or a
    slot); clients should back off and retry."""


@dataclasses.dataclass
class EngineConfig:
    """Sizing knobs for one engine; the fields and defaults of the JAX
    ``EngineConfig``.  ``num_pages = 0`` auto-sizes the pool to
    ``batch_slots`` times the per-sequence worst case.  ``prefix_cache``
    must be set False until the prefix cache is ported; ``max_adapters``,
    ``lora_rank``, ``ttft_window``, ``step_record`` and ``step_window`` are
    read once adapters, the serve binding and the flight recorder are."""

    batch_slots: int = 8
    page_size: int = 16
    max_prompt_len: int = 64
    max_new_tokens_cap: int = 128
    num_pages: int = 0
    max_queue: int = 32
    mode: str = "continuous"      # or "whole_request" (gang admission)
    stream_timeout_s: float = 120.0
    max_adapters: int = 4
    lora_rank: int = 8
    prefix_cache: bool = True
    ttft_window: int = 64
    step_record: bool = True
    step_window: int = 256

    @property
    def pages_per_seq(self) -> int:
        # The page table must cover BOTH the worst-case sequence AND the
        # largest prefill bucket: padded prefill positions index the table.
        worst = math.ceil(
            (self.max_prompt_len + self.max_new_tokens_cap)
            / self.page_size)
        return max(worst, self.prefill_buckets()[-1] // self.page_size)

    @property
    def pool_pages(self) -> int:
        return self.num_pages or self.batch_slots * self.pages_per_seq

    def prefill_buckets(self) -> List[int]:
        """Padded prompt lengths: page-size multiples doubling up to the
        prompt cap."""
        out, b = [], self.page_size
        while b < self.max_prompt_len:
            out.append(b)
            b *= 2
        out.append(max(b, self.max_prompt_len))
        return out


class _Request:
    __slots__ = (
        "req_id", "prompt", "max_new", "temperature", "stop_token",
        "out_q", "cancelled", "pages", "page_table", "generated",
        "submit_t", "first_token_t", "slot", "tenant", "weight",
    )

    def __init__(self, req_id: int, prompt: np.ndarray, max_new: int,
                 temperature: float, stop_token: Optional[int]):
        self.req_id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.stop_token = stop_token
        self.out_q: "_queue.Queue" = _queue.Queue()
        self.cancelled = threading.Event()
        self.pages: List[int] = []
        self.page_table: Optional[np.ndarray] = None
        self.generated = 0
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.slot = -1
        self.tenant = "default"
        self.weight = 1.0


class TokenStream:
    """Per-request token iterator; the consumer side of the engine's
    emission queue.  ``cancel()`` releases the request's slot and pages at
    the next step boundary."""

    def __init__(self, engine: "InferenceEngine", req: _Request):
        self._engine = engine
        self._req = req
        self.steps: List[int] = []   # decode-step index of each token
        self.ttft_s: Optional[float] = None

    def __iter__(self):
        return self

    def __next__(self) -> int:
        try:
            kind, payload, step = self._req.out_q.get(
                timeout=self._engine.config.stream_timeout_s)
        except _queue.Empty:
            self.cancel()
            raise RuntimeError(
                "engine stream stalled past stream_timeout_s") from None
        if kind == "tok":
            if self.ttft_s is None and self._req.first_token_t is not None:
                self.ttft_s = self._req.first_token_t - self._req.submit_t
            self.steps.append(step)
            return int(payload)
        if kind == "err":
            raise payload
        raise StopIteration  # ("done", reason)

    def cancel(self) -> None:
        self._engine.cancel(self._req)


class InferenceEngine:
    """One engine's decode loop: the host-side sequence/slot state machine
    around the paged programs.  The loop runs on a dedicated daemon
    thread; ``submit()`` may be called from any thread and only touches the
    wait queue under the lock: pools, allocator and slot arrays belong to
    the loop thread alone.  Runs on ``device`` (the card unless
    ``device="cpu"``), where ``params`` must already live."""

    def __init__(self, model_config, params, config: EngineConfig,
                 seed: int = 0, device: DeviceLike = None):
        if config.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True: the radix prefix cache is " + _NOT_PORTED)
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self.model_config = model_config
        self.params = params
        self.config = config
        cfg = config
        self.maxp = cfg.pages_per_seq
        self.scratch = cfg.pool_pages  # scratch page index
        self.pools = init_paged_pools(model_config, cfg.pool_pages,
                                      cfg.page_size, device=self.device)
        self.allocator = PageAllocator(cfg.pool_pages)
        # Only the zero adapter slot until the adapter pool is ported.
        self.adapters = init_adapter_pool(model_config, 0, cfg.lora_rank,
                                          device=self.device)
        self.zero_slot = 0
        # ONE device generator threads through every prefill and decode
        # call: sampling is seeded per ENGINE, not per request.
        self._d_key = torch.Generator(device=self.device).manual_seed(seed)
        b = cfg.batch_slots
        self.slots: List[Optional[_Request]] = [None] * b
        # Host mirrors are the rebuild source; the device copies are what
        # decode consumes.  Admission/eviction/prefill mutate the mirrors
        # and mark them dirty; steady-state decode advances tokens/lengths
        # ON DEVICE and never re-uploads.
        self._page_tables = np.full((b, self.maxp), self.scratch, np.int32)
        self._seq_lens = np.zeros((b,), np.int32)
        self._tokens = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        self._temps = np.zeros((b,), np.float32)
        self._adapter_slots = np.full((b,), self.zero_slot, np.int32)
        self._dirty = True
        self._d_tokens = self._d_page_tables = None
        self._d_seq_lens = self._d_active = self._d_temps = None
        self._d_adapter_slots = None
        self.step_count = 0
        self._req_counter = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # Weighted-fair admission: one FIFO per tenant, picked by lowest
        # virtual finish time (a tenant's vtime advances by cost/weight per
        # admitted request, clamped to the global vclock).
        self._queues: Dict[str, List[_Request]] = {}
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._stop = False
        self.completed = 0
        self.shed = 0
        self.cancelled_count = 0
        self.tokens_emitted = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0  # loop seconds spent in prefill (stalling decode)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------- client API

    def submit(self, prompt_tokens, max_new_tokens: int = 16,
               temperature: float = 0.0,
               stop_token: Optional[int] = None,
               adapter: Optional[str] = None,
               tenant: str = "default",
               weight: float = 1.0) -> TokenStream:
        """Queue one sequence; returns its token stream.

        ``tenant``/``weight`` place the request in weighted-fair admission.
        Overload sheds the HEAVIEST tenant's newest queued request with
        :class:`EngineOverloadedError`: when that is the submitter itself
        the error raises here, otherwise it lands on the victim's stream."""
        if adapter is not None:
            raise NotImplementedError("adapter=: LoRA adapters are "
                                      + _NOT_PORTED)
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size > self.config.max_prompt_len:
            raise ValueError(
                f"prompt length {prompt.size} outside (0, "
                f"{self.config.max_prompt_len}]")
        max_new = min(int(max_new_tokens), self.config.max_new_tokens_cap)
        if max_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        need = math.ceil((prompt.size + max_new) / self.config.page_size)
        if need > self.allocator.total:
            raise ValueError(
                f"request needs {need} KV pages but the pool holds only "
                f"{self.allocator.total}; raise EngineConfig.num_pages")
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._req_counter += 1
            req = _Request(self._req_counter, prompt, max_new,
                           float(temperature), stop_token)
            req.tenant = tenant
            req.weight = float(weight)
            rec = self._tenant_rec(tenant)
            rec["weight"] = float(weight)
            rec["submitted"] += 1
            self._queues.setdefault(tenant, []).append(req)
            victim: Optional[_Request] = None
            if self._queued_total() > self.config.max_queue:
                victim = self._shed_locked()
            self._wake.notify()
            if victim is req:
                raise EngineOverloadedError(
                    f"engine queue full ({self.config.max_queue} "
                    f"waiting); tenant {tenant!r} is the heaviest")
            if victim is not None:
                victim.out_q.put((
                    "err", EngineOverloadedError(
                        f"shed by weighted-fair admission (tenant "
                        f"{victim.tenant!r} heaviest at overload)"),
                    self.step_count))
        return TokenStream(self, req)

    def _tenant_rec(self, tenant: str) -> Dict[str, Any]:
        rec = self._tenants.get(tenant)
        if rec is None:
            rec = self._tenants[tenant] = {
                "submitted": 0, "completed": 0, "shed": 0,
                "cancelled": 0, "weight": 1.0,
            }
        return rec

    def _queued_total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @staticmethod
    def _req_cost(req: _Request) -> float:
        # Token work (prefill + worst-case decode) as the fair-share unit.
        return float(req.prompt.size + req.max_new)

    def _shed_locked(self) -> _Request:
        """The tenant with the largest queued work per unit weight loses
        its NEWEST queued request (tail drop)."""
        heaviest, load = None, -1.0
        for t, q in self._queues.items():
            if not q:
                continue
            w = max(self._tenants[t]["weight"], 1e-9)
            l = sum(self._req_cost(r) for r in q) / w
            if l > load:
                heaviest, load = t, l
        victim = self._queues[heaviest].pop()
        self._tenants[heaviest]["shed"] += 1
        self.shed += 1
        return victim

    def cancel(self, req: _Request) -> None:
        """Idempotent; a finished request is a no-op.  Pages return to
        the free list at the loop's next step boundary."""
        req.cancelled.set()
        with self._lock:
            self._wake.notify()

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=10)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            queued = self._queued_total()
            tenants = {
                t: dict(rec, queued=len(self._queues.get(t, [])))
                for t, rec in self._tenants.items()
            }
        traces, calls = trace_counts(), call_counts()
        return {
            "steps": self.step_count,
            "active_seqs": sum(1 for s in self.slots if s is not None),
            "queued": queued,
            "free_pages": self.allocator.free_count,
            "total_pages": self.allocator.total,
            "shared_pages": self.allocator.shared_count,
            "completed": self.completed,
            "shed": self.shed,
            "cancelled": self.cancelled_count,
            "decode_traces": traces["decode"],
            "prefill_traces": traces["prefill"],
            "prefill_prefix_traces": traces["prefill_prefix"],
            "mode": self.config.mode,
            "tenants": tenants,
            "prefix_cache": None,  # the prefix cache is not ported yet
            "tokens": self.tokens_emitted,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_calls": calls["decode"],
            "prefill_calls": calls["prefill"],
        }

    def warmup(self) -> None:
        """Run the decode program and every prefill bucket once (one dummy
        sequence per bucket): builds the CUDA kernels and warms the
        libraries before serving traffic."""
        for _ in self.submit([1], max_new_tokens=2):
            pass
        for bucket in self.config.prefill_buckets()[1:]:
            n = min(bucket, self.config.max_prompt_len)
            for _ in self.submit(np.ones((n,), np.int32), max_new_tokens=1):
                pass

    # ---------------------------------------------------------------- loop

    def _bucket_len(self, n: int) -> int:
        for b in self.config.prefill_buckets():
            if b >= n:
                return b
        return self.config.prefill_buckets()[-1]

    def _pick_tenant_locked(self) -> Optional[str]:
        """Lowest-virtual-time tenant with queued work (WFQ pick)."""
        best, best_v = None, None
        for t, q in self._queues.items():
            if not q:
                continue
            v = max(self._vtime.get(t, 0.0), self._vclock)
            if best_v is None or v < best_v:
                best, best_v = t, v
        return best

    def _admit_locked(self) -> List[_Request]:
        """Move queued requests into free slots (called under the lock).
        Continuous mode admits whenever a slot AND pages are free;
        whole-request mode admits a full gang only into an EMPTY batch.
        Tenants are drained in weighted-fair order."""
        admitted: List[_Request] = []
        whole = self.config.mode == "whole_request"
        if whole and any(s is not None for s in self.slots):
            return admitted
        for slot in range(self.config.batch_slots):
            if self.slots[slot] is not None:
                continue
            tenant = self._pick_tenant_locked()
            if tenant is None:
                continue
            req = self._queues[tenant][0]
            need_total = math.ceil((req.prompt.size + req.max_new)
                                   / self.config.page_size)
            pages = self.allocator.alloc(need_total)
            if pages is None:
                break  # pool pressure: leave queued, retry next step
            self._queues[tenant].pop(0)
            v_start = max(self._vtime.get(tenant, 0.0), self._vclock)
            w = max(req.weight, 1e-9)
            self._vtime[tenant] = v_start + self._req_cost(req) / w
            self._vclock = v_start
            req.pages = pages
            pt = np.full((self.maxp,), self.scratch, np.int32)
            pt[:need_total] = pages
            req.page_table = pt
            req.slot = slot
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    def _evict(self, slot: int, reason: str) -> None:
        req = self.slots[slot]
        assert req is not None
        self.allocator.free(req.pages)
        req.pages = []
        self.slots[slot] = None
        self._page_tables[slot, :] = self.scratch
        self._seq_lens[slot] = 0
        self._tokens[slot] = 0
        self._active[slot] = False
        self._temps[slot] = 0.0
        self._adapter_slots[slot] = self.zero_slot
        self._dirty = True
        rec = self._tenant_rec(req.tenant)
        if reason == "cancelled":
            self.cancelled_count += 1
            rec["cancelled"] += 1
        elif reason in ("complete", "stop"):
            self.completed += 1
            rec["completed"] += 1
        if reason == "shutdown":
            # Loudly: a truncated generation must not look complete.
            req.out_q.put(("err", RuntimeError(
                "engine shut down mid-generation"), self.step_count))
        else:
            req.out_q.put(("done", reason, self.step_count))

    def _prefill(self, req: _Request) -> None:
        """Run one admitted sequence's prompt through the bucketed prefill
        program and emit its first token (TTFT point)."""
        n = req.prompt.size
        s_pad = self._bucket_len(n)
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :n] = req.prompt
        dev = self.device
        first, self._d_key, self.pools = paged_prefill(
            self.model_config, self.params, self.pools, self.adapters,
            torch.tensor(toks, device=dev), n,
            torch.tensor(req.page_table, device=dev), self.zero_slot,
            torch.tensor(req.temperature, dtype=torch.float32, device=dev),
            self._d_key)
        self.prefill_tokens += n
        first = int(first)  # THE prefill readback: the first token streams
        req.first_token_t = time.perf_counter()
        slot = req.slot
        self._page_tables[slot] = req.page_table
        self._seq_lens[slot] = n
        self._tokens[slot] = first
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._adapter_slots[slot] = self.zero_slot
        self._dirty = True
        self._emit_token(req, first)

    def _emit_token(self, req: _Request, token: int) -> None:
        req.generated += 1
        self.tokens_emitted += 1
        req.out_q.put(("tok", token, self.step_count))
        if req.stop_token is not None and token == req.stop_token:
            self._evict(req.slot, "stop")
        elif req.generated >= req.max_new:
            self._evict(req.slot, "complete")

    def _fail_inflight(self, exc: BaseException) -> None:
        """A model-call failure must not kill the loop thread silently:
        every in-flight request gets the error on its stream, pages return
        to the free list, and the pools are rebuilt (a failed in-place
        call may have left them half written).  Queued requests stay
        queued and retry against the fresh pool."""
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.allocator.free(req.pages)
            req.pages = []
            self.slots[slot] = None
            req.out_q.put(("err", exc, self.step_count))
        self._page_tables[:] = self.scratch
        self._seq_lens[:] = 0
        self._tokens[:] = 0
        self._active[:] = False
        self._temps[:] = 0.0
        self._adapter_slots[:] = self.zero_slot
        self._dirty = True
        self.pools = init_paged_pools(
            self.model_config, self.config.pool_pages,
            self.config.page_size, device=self.device)

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    break
                # Reap cancellations first: queued cancels just drop,
                # in-flight cancels free pages before admission looks at
                # the pool.
                for q in self._queues.values():
                    keep = []
                    for r in q:
                        if r.cancelled.is_set():
                            self.cancelled_count += 1
                            self._tenant_rec(r.tenant)["cancelled"] += 1
                            r.out_q.put(
                                ("done", "cancelled", self.step_count))
                        else:
                            keep.append(r)
                    q[:] = keep
                for slot, req in enumerate(self.slots):
                    if req is not None and req.cancelled.is_set():
                        self._evict(slot, "cancelled")
                admitted = self._admit_locked()
                active = sum(1 for s in self.slots if s is not None)
                if not admitted and active == 0:
                    self._wake.wait(timeout=0.05)
                    continue
            # Model work runs OUTSIDE the lock: pools/slot arrays belong
            # to this thread; submit() only appends to the wait queue.
            try:
                self._run_step(admitted)
            except Exception as e:  # noqa: BLE001: fail streams, not
                self._fail_inflight(e)  # the loop thread
        # Shutdown: fail queued + in-flight requests loudly.
        with self._lock:
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for req in pending:
            req.out_q.put(("err", RuntimeError(
                "engine shut down before admission"), self.step_count))
        for slot, req in enumerate(self.slots):
            if req is not None:
                self._evict(slot, "shutdown")

    def _run_step(self, admitted: List[_Request]) -> None:
        for req in admitted:
            pf0 = time.perf_counter()
            self._prefill(req)
            self.prefill_s += time.perf_counter() - pf0
        if not any(s is not None for s in self.slots):
            return
        self.step_count += 1
        dev = self.device
        if self._dirty:
            # Membership changed since the last step: re-upload the host
            # mirrors.  Steady-state decode skips this: tokens, lengths
            # and the generator advance on device.
            self._d_tokens = torch.tensor(self._tokens, device=dev)
            self._d_page_tables = torch.tensor(self._page_tables,
                                                  device=dev)
            self._d_seq_lens = torch.tensor(self._seq_lens, device=dev)
            self._d_active = torch.tensor(self._active, device=dev)
            self._d_temps = torch.tensor(self._temps, device=dev)
            self._d_adapter_slots = torch.tensor(self._adapter_slots,
                                                    device=dev)
            self._dirty = False
        (self._d_tokens, self._d_seq_lens, self._d_key,
         self.pools) = paged_decode_step(
            self.model_config, self.params, self.pools, self.adapters,
            self._d_tokens, self._d_page_tables, self._d_seq_lens,
            self._d_active, self._d_temps, self._d_adapter_slots,
            self._d_key)
        toks = self._d_tokens.cpu().numpy()  # THE decode-step readback
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self._seq_lens[slot] += 1
            self._tokens[slot] = toks[slot]
            self._emit_token(req, int(toks[slot]))
