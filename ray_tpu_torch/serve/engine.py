"""Continuous-batching LLM inference engine (port of
``ray_tpu/serve/engine.py``).

The host half is the JAX engine's, copied: a dedicated loop thread;
weighted-fair admission between decode steps with a bounded wait queue that
sheds with :class:`EngineOverloadedError`; cancel and evict at step
boundaries with pages returned to the free list; bucketed prefill; ONE
batched token readback per decode step; ``stats()`` and ``slo_signals()``.
The device half runs the port's paged programs (``models/paged.py``) on
torch tensors: the KV pool is updated in place, the tokens, lengths and
sampling generator stay on the device between steps, and the host mirrors
are re-uploaded only when slot membership changes.

The multi-tenant plane is the JAX engine's too.  A radix prefix cache
(``serve/prefix_cache.py``, on by default) shares the KV pages of
page-aligned prompt prefixes between sequences: a hit claims the cached
pages, copies a page that diverges mid-page (``copy_page``) and prefills
only the suffix (``paged_prefill_prefix``, kernel K1 at ``q_offset =
prefix_len`` on the card).  A LoRA adapter pool (``serve/adapter_pool.py``)
holds ``max_adapters`` device slots: ``register_adapter`` names an adapter,
``submit(adapter=...)`` decodes with it, and requests on different adapters
share one batch and one decode signature.  Control ops (adapter
registration, cache clear, warmup's direct program calls) run on the loop
thread, which owns the pools.

Observability is the JAX engine's too, through the port's own
``util``/``devtools`` modules:

- a step flight recorder (``util/steprec.py``): one fixed-size record per
  step (the JAX engine's 17 fields, host counters only, no device sync),
  into a bounded per-process ring, when ``EngineConfig.step_record`` is on;
  each engine's records carry ``engine_id`` (``"<pid>.<seq>"``);
- the ``ray_tpu_*`` instruments of the JAX engine (``util/metrics.py``),
  same names, descriptions, tags and histogram boundaries, updated at the
  same points;
- per-request ``engine:queue`` / ``engine:prefill`` / ``engine:decode``
  spans (``util/tracing.py``, stamped on ``tracing.now()``, the device
  trace's clock), parented to the submitter's trace context when
  ``submit`` ran inside a sampled trace;
- one ``engine:step`` span a step while a traced request is admitted or
  holds a slot (``_emit_step_span``): the step's phase stamps (admission
  done, prefills done, decode launch, launch returned, tokens read back)
  and host counters (slots decoded, KV positions attended against those
  the gather reads), all in one trace of the engine's own with no parent,
  so no request's trace holds them.  Untraced traffic pays one integer
  comparison a step;
- device-memory pools (``util/devmem.py``): ``model_weights``, ``kv_pool``
  and ``adapter_pool``, registered while the engine lives;
- the recompile sentinel (``devtools/jitguard.py``): ``warmup()`` arms it
  last, so under ``RT_DEBUG_JIT=1`` a program signature first met after
  warmup raises ``RecompileError`` on the failing request's stream.  A
  step that meets a new signature is attributed with
  ``devmem.record_compile``: on the port that is a program's first run
  with a signature, which on the card may include a kernel's build at
  first use.

The serve binding is the JAX module's too: ``LLMServer`` is the
deployment callable (one engine per replica, tokens streamed one item
each) and ``llm_app`` builds its application.  Both take ``device``: a
replica builds its weights on the card it was granted
(``llm_app`` asks for ``num_gpus=1`` a replica) unless it is given
``device="cpu"``; a replica granted no card sees none and raises.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import os
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..devtools import jitguard
from ..models.llama import Lora, _normal_, lora_init
from ..models.paged import (PAGED_PROGRAMS, PageAllocator, call_counts,
                            copy_page, init_paged_pools, paged_decode_step,
                            paged_prefill, paged_prefill_prefix, trace_count)
from ..util import devmem, steprec, tracing
from ..util.metrics import get_counter, get_gauge, get_histogram
from .adapter_pool import AdapterPool
from .prefix_cache import RadixPrefixCache

#: Engine identity within one process: step records carry
#: ``"<pid>.<seq>"`` so records of several engines in one process (tests,
#: harnesses) stay apart.
_ENGINE_SEQ = itertools.count()


class EngineOverloadedError(Exception):
    """Typed admission-control shed: the engine's wait queue is full.
    Callers see this at submit time (the request never held pages or a
    slot); clients should back off and retry."""


@dataclasses.dataclass
class EngineConfig:
    """Sizing knobs for one engine; the fields and defaults of the JAX
    ``EngineConfig``.  ``num_pages = 0`` auto-sizes the pool to
    ``batch_slots`` times the per-sequence worst case.  ``max_adapters``
    and ``lora_rank`` shape the device adapter pool (part of every program
    signature); ``prefix_cache`` turns the radix tree over the paged KV on;
    ``ttft_window`` sizes the recent-TTFT ring.  ``step_record`` turns on
    the flight recorder (one record per step into ``util/steprec.py``'s
    ring, host counters only) and the step-wall and stall rings behind
    ``slo_signals()``, which ``step_window`` sizes."""

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
        "submit_t", "first_token_t", "last_token_t", "itl_sum", "itl_n",
        "slot",
        "trace_ctx", "submit_wall", "admit_wall", "first_wall",
        "tenant", "weight", "adapter", "adapter_slot", "match", "cow_ref",
        "cache_hit_len",
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
        self.last_token_t: Optional[float] = None
        # Engine-side inter-token latencies, summed for a traced request
        # only (its decode span's ``mean_itl_s``): measured at emission, so
        # they reflect decode cadence, not consumer scheduling.
        self.itl_sum = 0.0
        self.itl_n = 0
        self.slot = -1
        # Tracing: the submitter's span context (None when the request
        # arrived untraced/unsampled: then the engine emits nothing) plus
        # ``tracing.now()`` stamps for the queue/prefill/decode spans
        # (submit_t/first_token_t are perf_counter and can't be shared with
        # wall-clocked spans from other threads or processes).
        self.trace_ctx: Optional[Dict[str, str]] = None
        self.submit_wall = 0.0
        self.admit_wall = 0.0
        self.first_wall = 0.0
        self.tenant = "default"
        self.weight = 1.0
        # Multi-tenant plane: the adapter this sequence decodes with (None
        # = base model), and the prefix-cache plan pinned at admission (the
        # match, plus the extra copy-on-write source ref held until the
        # page is copied).
        self.adapter: Optional[str] = None
        self.adapter_slot = -1
        self.match = None
        self.cow_ref: Optional[int] = None
        self.cache_hit_len = 0


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
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        # A fresh engine means fresh geometry: re-registering stands the
        # paged programs' armed baselines down (recompile sentinel) until
        # this engine's own warmup() re-arms: an un-warmed engine's first
        # signatures are a compile phase, not hot-path recompiles.
        for prog in PAGED_PROGRAMS:
            jitguard.register_program(prog)
        self.model_config = model_config
        self.params = params
        self.config = config
        cfg = config
        self.maxp = cfg.pages_per_seq
        self.scratch = cfg.pool_pages  # scratch page index
        self.pools = init_paged_pools(model_config, cfg.pool_pages,
                                      cfg.page_size, device=self.device)
        self.allocator = PageAllocator(cfg.pool_pages)
        # Multi-tenant plane: device-resident LoRA slots and the radix
        # prefix tree over the page pool, owned by the loop thread like the
        # allocator.
        self.adapter_pool = AdapterPool(
            model_config, max_adapters=cfg.max_adapters, rank=cfg.lora_rank,
            device=self.device)
        self._cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(cfg.page_size) if cfg.prefix_cache else None)
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
        self._adapter_slots = np.full((b,), self.adapter_pool.zero_slot,
                                      np.int32)
        self._dirty = True
        self._d_tokens = self._d_page_tables = None
        self._d_seq_lens = self._d_active = self._d_temps = None
        self._d_adapter_slots = None
        self.step_count = 0
        # Step spans: traced requests holding a slot (the O(1) gate, changed
        # at admission and eviction) and the engine's own trace id.
        self._traced_slots = 0
        self._step_trace = tracing.new_id()
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
        # Control ops (adapter registration, cache clear) marshalled onto
        # the loop thread: it owns the pools the ops touch.
        self._control: List[Any] = []
        self._stop = False
        self.completed = 0
        self.shed = 0
        self.cancelled_count = 0
        self.tokens_emitted = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0  # loop seconds spent in prefill (stalling decode)
        self.prefix_hits = 0  # prefills that reused cached prefix pages
        self._evicted_total = 0
        self._adapter_evictions_seen = 0
        # Instruments hoisted off the request path (registry lock).
        self._m_tokens = get_counter(
            "ray_tpu_gen_tokens_total",
            "Decoded tokens emitted by the inference engine")
        self._m_prefill = get_counter(
            "ray_tpu_gen_prefill_tokens_total",
            "Prompt tokens prefilled into the paged KV cache")
        self._m_pages = get_gauge(
            "ray_tpu_gen_kv_pages_in_use",
            "KV cache pages currently allocated to sequences",
            tag_keys=("pid",))
        self._m_queue = get_gauge(
            "ray_tpu_serve_engine_queue_depth",
            "Requests waiting for a batch slot", tag_keys=("pid",))
        self._m_active = get_gauge(
            "ray_tpu_serve_engine_active_seqs",
            "Sequences decoding in batch slots", tag_keys=("pid",))
        self._m_shed = get_counter(
            "ray_tpu_serve_engine_shed_total",
            "Requests rejected by admission control (overload)")
        self._m_completed = get_counter(
            "ray_tpu_serve_engine_completed_total",
            "Requests decoded to completion")
        self._m_cancelled = get_counter(
            "ray_tpu_serve_engine_cancelled_total",
            "Requests cancelled mid-flight (pages reclaimed)")
        self._m_ttft = get_histogram(
            "ray_tpu_serve_engine_ttft_seconds",
            "Submit-to-first-token latency",
            boundaries=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10))
        self._m_itl = get_histogram(
            "ray_tpu_serve_engine_itl_seconds",
            "Inter-token latency during decode",
            boundaries=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 1))
        self._m_pc_hits = get_counter(
            "ray_tpu_serve_prefix_cache_hits_total",
            "Prompts whose prefill reused cached KV prefix pages")
        self._m_pc_shared = get_gauge(
            "ray_tpu_serve_prefix_cache_pages_shared",
            "KV pages currently held by more than one owner",
            tag_keys=("pid",))
        self._m_adapter_evict = get_counter(
            "ray_tpu_serve_adapter_evictions_total",
            "LoRA adapters evicted from the device-resident pool")
        self._m_tenant_shed = get_counter(
            "ray_tpu_serve_tenant_shed_total",
            "Requests shed by weighted-fair admission, by tenant",
            tag_keys=("tenant",))
        self._m_stall = get_counter(
            "ray_tpu_engine_stall_seconds_total",
            "Decode-loop seconds spent stalled on admission prefills")
        self._pid_tags = {"pid": str(os.getpid())}
        # Flight recorder: engine identity, plus the recent TTFTs,
        # decode-step walls and admission stalls ((wall_time, stall_s))
        # that slo_signals() reads.
        self.engine_id = f"{os.getpid()}.{next(_ENGINE_SEQ)}"
        self._ttft_recent: "collections.deque" = collections.deque(
            maxlen=cfg.ttft_window)
        self._step_walls: "collections.deque" = collections.deque(
            maxlen=max(16, cfg.step_window))
        self._stall_events: "collections.deque" = collections.deque(
            maxlen=max(16, cfg.step_window))
        # Device-memory attribution: the engine owns the big allocations,
        # so it names them for util/devmem snapshots.  The weights' bytes
        # are static; the pool/adapter lambdas read the live tensors.
        self._weights_bytes = sum(p.nbytes for p in params.parameters())
        devmem.register_pool("model_weights", lambda: self._weights_bytes)
        devmem.register_pool("kv_pool", lambda: sum(
            a.nbytes for a in self.pools.values()))
        devmem.register_pool("adapter_pool", lambda: sum(
            a.nbytes for a in self.adapter_pool.arrays.values()))
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

        ``adapter`` names a registered LoRA (None = base model; an
        unregistered name raises ``KeyError``); ``tenant``/``weight`` place
        the request in weighted-fair admission.  Overload sheds the
        HEAVIEST tenant's newest queued request with
        :class:`EngineOverloadedError`: when that is the submitter itself
        the error raises here, otherwise it lands on the victim's stream."""
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
        if adapter is not None and not self.adapter_pool.has(adapter):
            raise KeyError(f"adapter {adapter!r} is not registered")
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
            req.adapter = adapter
            rec = self._tenant_rec(tenant)
            rec["weight"] = float(weight)
            rec["submitted"] += 1
            # Capture the submitter's trace context: the loop thread emits
            # this request's queue/prefill/decode spans against it.
            req.trace_ctx = tracing.context_for_submit()
            req.submit_wall = tracing.now()
            self._queues.setdefault(tenant, []).append(req)
            victim: Optional[_Request] = None
            if self._queued_total() > self.config.max_queue:
                victim = self._shed_locked()
            self._m_queue.set(self._queued_total(), tags=self._pid_tags)
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
        self._m_shed.inc(1)
        self._m_tenant_shed.inc(1, tags={"tenant": heaviest})
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
        for name in ("model_weights", "kv_pool", "adapter_pool"):
            devmem.unregister_pool(name)
        steprec.dump_black_box(force=True)  # graceful exits get a fresh box

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            queued = self._queued_total()
            tenants = {
                t: dict(rec, queued=len(self._queues.get(t, [])))
                for t, rec in self._tenants.items()
            }
        calls = call_counts()
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
            "decode_traces": trace_count("decode"),
            "prefill_traces": trace_count("prefill"),
            "prefill_prefix_traces": trace_count("prefill_prefix"),
            "mode": self.config.mode,
            "tenants": tenants,
            "prefix_cache": (self._cache.stats()
                             if self._cache is not None else None),
            "adapters": self.adapter_pool.stats(),
            "tokens": self.tokens_emitted,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "prefix_hits": self.prefix_hits,
            "decode_calls": calls["decode"],
            "prefill_calls": calls["prefill"],
            "prefill_prefix_calls": calls["prefill_prefix"],
        }

    #: Window over which admission-stall seconds are summed for the
    #: autoscaler's stall-pressure signal.
    STALL_WINDOW_S = 30.0

    def slo_signals(self) -> Dict[str, Any]:
        """Queue-depth / TTFT snapshot for SLO-driven autoscaling (host
        counters plus a small sort), with the stall and jitter signals:
        seconds the decode loop spent stalled on admission prefills inside
        the last ``STALL_WINDOW_S``, and decode-step p99 jitter (p99 - p50
        step wall)."""
        ttfts = sorted(self._ttft_recent)

        def pct(vals: List[float], p: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        with self._lock:
            queued = self._queued_total()
            tenant_queues = {t: len(q)
                             for t, q in self._queues.items() if q}
        now = time.time()
        stall_s = sum(s for (t, s) in list(self._stall_events)
                      if now - t <= self.STALL_WINDOW_S)
        walls = sorted(self._step_walls)
        p50, p99 = pct(walls, 0.50), pct(walls, 0.99)
        return {
            "queue_depth": queued,
            "active_seqs": sum(1 for s in self.slots if s is not None),
            "batch_slots": self.config.batch_slots,
            "ttft_p50_s": pct(ttfts, 0.50),
            "ttft_p90_s": pct(ttfts, 0.90),
            "ttft_count": len(ttfts),
            "completed": self.completed,
            "shed": self.shed,
            "stall_s_window": stall_s,
            "stall_window_s": self.STALL_WINDOW_S,
            "stall_frac": min(1.0, stall_s / self.STALL_WINDOW_S),
            "step_p50_s": p50,
            "step_p99_s": p99,
            "step_jitter_p99_s": max(0.0, p99 - p50),
            "tenant_queues": tenant_queues,
        }

    def _run_on_loop(self, fn, timeout: float = 30.0):
        """Run ``fn`` on the loop thread (it owns pools, cache and
        adapters) and return its result.  Raises what ``fn`` raised."""
        done = threading.Event()
        box: Dict[str, Any] = {}

        def task():
            try:
                box["r"] = fn()
            except BaseException as e:  # noqa: BLE001: re-raised below
                box["e"] = e
            finally:
                done.set()

        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._control.append(task)
            self._wake.notify()
        if not done.wait(timeout):
            raise TimeoutError("engine loop did not run control op")
        if "e" in box:
            raise box["e"]
        return box.get("r")

    def register_adapter(self, name: str, source: Any) -> None:
        """Register (or replace) a LoRA adapter: packed tensors
        (``pack_lora``), a ``Lora``, a numpy tree in the JAX layout, or a
        zero-argument callable returning one.  Replacement drops any
        resident copy AND the adapter's prefix-cache tree: its cached V
        deltas are stale."""

        def do():
            self.adapter_pool.register(name, source)
            if self._cache is not None:
                self._cache.drop_adapter(name, self.allocator)

        self._run_on_loop(do)

    def clear_prefix_cache(self) -> int:
        """Release every cache-held page ref (drain to a balanced free
        list); returns the pages released."""
        if self._cache is None:
            return 0
        return self._run_on_loop(
            lambda: self._cache.clear(self.allocator))

    def warmup(self) -> None:
        """Run every program once before serving traffic: the decode step,
        every prefill bucket (one dummy sequence each), every suffix bucket
        of the cached-prefix prefill, one page copy and one adapter load.
        Builds the CUDA kernels and records each program's signatures, so
        serving adds none; under ``RT_DEBUG_JIT=1`` it then arms the
        recompile sentinel, so a signature first met later raises
        ``RecompileError``."""
        # A fresh engine's warmup is a legitimate compile phase: stand the
        # sentinel down while it runs (a previous engine in this process
        # may have armed with other geometry), re-arm at the end.
        jitguard.disarm()
        # max_new_tokens=2: the first token comes from the prefill; the
        # decode program runs only once a second token is needed.
        for _ in self.submit([1], max_new_tokens=2):
            pass
        for bucket in self.config.prefill_buckets()[1:]:
            n = min(bucket, self.config.max_prompt_len)
            if self._cache is not None:
                # The previous bucket's ones-prompt cached its pages; a hit
                # here would take the suffix path and skip this bucket.
                self.clear_prefix_cache()
            for _ in self.submit(np.ones((n,), np.int32), max_new_tokens=1):
                pass
        if self._cache is not None \
                and self.config.max_prompt_len >= self.config.page_size:
            # Re-run the largest prompt: it hits the pages just cached and
            # takes the copy-on-write and suffix-prefill path.
            n = self.config.max_prompt_len
            for _ in self.submit(np.ones((n,), np.int32), max_new_tokens=1):
                pass
            self.clear_prefix_cache()
            # That run reached one suffix bucket; run every bucket and the
            # page copy directly (dummy tokens into the scratch page; page 0
            # onto itself).
            self._run_on_loop(self._warm_prefix_path)
        self._run_on_loop(self.adapter_pool.warmup_compile)
        # Freeze every program's trace count: decode, each prefill bucket,
        # the copy-on-write/suffix path, adapter loads.  No-op unless
        # RT_DEBUG_JIT is set.
        jitguard.arm()

    def _warm_prefix_path(self) -> None:
        dev = self.device
        pt = torch.full((self.maxp,), self.scratch, dtype=torch.int32,
                        device=dev)
        temp = torch.tensor(0.0, dtype=torch.float32, device=dev)
        for b in self.config.prefill_buckets():
            _, self._d_key, self.pools = paged_prefill_prefix(
                self.model_config, self.params, self.pools,
                self.adapter_pool.arrays,
                torch.zeros((1, b), dtype=torch.int32, device=dev), 0, 1, pt,
                0, temp, self._d_key)
        self.pools = copy_page(self.pools, 0, 0)

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
        Tenants are drained in weighted-fair order; each admission pins
        its prefix-cache match (refcounted shares) and allocates only the
        pages the cache can't cover, evicting cold cache leaves first when
        the pool runs dry."""
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
            if not self.adapter_pool.can_acquire(req.adapter):
                break  # every adapter slot pinned: wait for an eviction
            need_total = math.ceil((req.prompt.size + req.max_new)
                                   / self.config.page_size)
            match = None
            shared: List[int] = []
            if self._cache is not None:
                match = self._cache.lookup(req.adapter, req.prompt)
                shared = match.pages
                # Pin the match BEFORE any cache eviction below can free
                # the very pages it names.
                self._cache.claim(match, self.allocator)  # rt-owns: prefix_claim
            need = need_total - len(shared)
            pages = self.allocator.alloc(need)
            if pages is None and self._cache is not None:
                deficit = need - self.allocator.free_count
                if self._cache.evict_leaves(deficit, self.allocator):
                    pages = self.allocator.alloc(need)
            if pages is None:
                if match is not None:  # roll the claim back
                    held = list(shared)
                    if match.cow_src is not None:
                        held.append(match.cow_src)
                    if held:
                        self.allocator.free(held)
                break  # pool pressure: leave queued, retry next step
            self._queues[tenant].pop(0)
            # Reserve (pin) the adapter slot now, host-only: requests
            # admitted in this same round must see each other's pins, or a
            # wave of distinct adapters could over-commit the slots the
            # can_acquire check saw free.  Weights load at prefill.
            req.adapter_slot = self.adapter_pool.reserve(req.adapter)
            v_start = max(self._vtime.get(tenant, 0.0), self._vclock)
            w = max(req.weight, 1e-9)
            self._vtime[tenant] = v_start + self._req_cost(req) / w
            self._vclock = v_start
            req.admit_wall = tracing.now()
            if req.trace_ctx is not None:
                self._traced_slots += 1
            req.pages = shared + pages
            req.match = match
            if match is not None and match.cow_src is not None:
                req.cow_ref = match.cow_src
            req.cache_hit_len = match.prefix_len if match else 0
            pt = np.full((self.maxp,), self.scratch, np.int32)
            pt[:need_total] = req.pages
            req.page_table = pt
            req.slot = slot
            self.slots[slot] = req
            admitted.append(req)
        if admitted:
            self._m_queue.set(self._queued_total(), tags=self._pid_tags)
        return admitted

    def _emit_req_span(self, req: _Request, name: str, start: float,
                       end: float, **attrs) -> None:
        """One request-stage span (queue / prefill / decode), parented to
        the submitter's context; buffered emission (util/tracing's ring)."""
        if req.trace_ctx is None or start <= 0:
            return
        tracing.emit_span(
            tracing.make_span(req.trace_ctx, name, start, end, **attrs))

    def _evict(self, slot: int, reason: str) -> None:
        req = self.slots[slot]
        assert req is not None
        # Decode-lifetime span: first token -> eviction.  Token count, TTFT
        # and mean ITL ride as attrs, so per-request latency attribution is
        # derivable from the span tree alone.
        self._emit_req_span(
            req, "engine:decode", req.first_wall or req.admit_wall,
            tracing.now(), tokens=req.generated, reason=reason,
            ttft_s=round(req.first_token_t - req.submit_t, 6)
            if req.first_token_t is not None else None,
            mean_itl_s=round(req.itl_sum / req.itl_n, 6)
            if req.itl_n else None)
        if req.trace_ctx is not None:
            self._traced_slots -= 1
        self._release(req)
        self._evicted_total += 1
        self.slots[slot] = None
        self._page_tables[slot, :] = self.scratch
        self._seq_lens[slot] = 0
        self._tokens[slot] = 0
        self._active[slot] = False
        self._temps[slot] = 0.0
        self._adapter_slots[slot] = self.adapter_pool.zero_slot
        self._dirty = True
        rec = self._tenant_rec(req.tenant)
        if reason == "cancelled":
            self.cancelled_count += 1
            rec["cancelled"] += 1
            self._m_cancelled.inc(1)
        elif reason in ("complete", "stop"):
            self.completed += 1
            rec["completed"] += 1
            self._m_completed.inc(1)
        if reason == "shutdown":
            # Loudly: a truncated generation must not look complete.
            req.out_q.put(("err", RuntimeError(
                "engine shut down mid-generation"), self.step_count))
        else:
            req.out_q.put(("done", reason, self.step_count))

    def _release(self, req: _Request) -> None:
        """Return what an admitted request holds: its page refs (shared
        prefix pages may stay cached), the copy-on-write source ref if the
        copy never ran, and its adapter pin."""
        self.allocator.free(req.pages)
        req.pages = []
        if req.cow_ref is not None:
            self.allocator.free([req.cow_ref])
            req.cow_ref = None
        if req.adapter_slot >= 0:
            self.adapter_pool.release(req.adapter)
            req.adapter_slot = -1

    def _prefill(self, req: _Request) -> None:
        """Run one admitted sequence's prompt through the bucketed prefill
        program and emit its first token (TTFT point).  A prefix-cache hit
        copies the copy-on-write page (mid-page divergence) and prefills
        only the uncached suffix."""
        # Admission reserved (pinned) the slot; load the weights if this is
        # the adapter's first use since eviction.
        self.adapter_pool.ensure_loaded(req.adapter)
        ev = self.adapter_pool.evictions
        if ev > self._adapter_evictions_seen:
            self._m_adapter_evict.inc(ev - self._adapter_evictions_seen)
            self._adapter_evictions_seen = ev
        n = req.prompt.size
        # Queue-wait span (submit -> admission into a batch slot).
        self._emit_req_span(req, "engine:queue", req.submit_wall,
                            req.admit_wall or req.submit_wall,
                            prompt_len=int(n))
        pf_start = tracing.now()
        dev = self.device
        prefix_len = req.cache_hit_len
        adapters = self.adapter_pool.arrays
        page_table = torch.tensor(req.page_table, device=dev)
        temp = torch.tensor(req.temperature, dtype=torch.float32, device=dev)
        if prefix_len > 0:
            match = req.match
            if match.cow_src is not None:
                # Private copy of the divergent page, then drop the claim's
                # extra ref on the source.
                dest = int(req.page_table[len(match.pages)])
                self.pools = copy_page(self.pools, match.cow_src, dest)
                self.allocator.free([req.cow_ref])
                req.cow_ref = None
            suffix = req.prompt[prefix_len:]
            s_pad = self._bucket_len(suffix.size)
            toks = np.zeros((1, s_pad), np.int32)
            toks[0, :suffix.size] = suffix
            first, self._d_key, self.pools = paged_prefill_prefix(
                self.model_config, self.params, self.pools, adapters,
                torch.tensor(toks, device=dev), prefix_len, n, page_table,
                req.adapter_slot, temp, self._d_key)
            self.prefix_hits += 1
            self._m_pc_hits.inc(1)
            self.prefill_tokens += suffix.size  # only the work done
            self._m_prefill.inc(suffix.size)
        else:
            s_pad = self._bucket_len(n)
            toks = np.zeros((1, s_pad), np.int32)
            toks[0, :n] = req.prompt
            first, self._d_key, self.pools = paged_prefill(
                self.model_config, self.params, self.pools, adapters,
                torch.tensor(toks, device=dev), n, page_table,
                req.adapter_slot, temp, self._d_key)
            self.prefill_tokens += n
            self._m_prefill.inc(n)
        first = int(first)  # rt-sync-ok: THE prefill readback — the first token must reach the host to stream it
        # Cache every fully frozen prompt page (decode appends past the
        # prompt, so pages wholly inside it never change again).
        if self._cache is not None:
            full = n // self.config.page_size
            if full > 0:
                self._cache.insert(
                    req.adapter, req.prompt[:full * self.config.page_size],
                    [int(p) for p in req.page_table[:full]], self.allocator)
            self._m_pc_shared.set(self.allocator.shared_count,
                                  tags=self._pid_tags)
        now = time.perf_counter()
        req.first_token_t = now
        req.last_token_t = now
        req.first_wall = tracing.now()
        # Prefill span: bucket and cached-prefix attrs make padding waste
        # and cache effectiveness readable straight off the trace.
        self._emit_req_span(req, "engine:prefill", pf_start, req.first_wall,
                            bucket=int(s_pad), prompt_len=int(n),
                            cached_prefix=int(prefix_len))
        ttft = now - req.submit_t
        self._m_ttft.observe(ttft)
        self._ttft_recent.append(ttft)
        slot = req.slot
        self._page_tables[slot] = req.page_table
        self._seq_lens[slot] = n
        self._tokens[slot] = first
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._adapter_slots[slot] = req.adapter_slot
        self._dirty = True
        self._emit_token(req, first)

    def _emit_token(self, req: _Request, token: int) -> None:
        req.generated += 1
        self.tokens_emitted += 1
        self._m_tokens.inc(1)
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
        queued and retry against the fresh pool.  The streams get the
        error once the engine is rebuilt."""
        failed = [req for req in self.slots if req is not None]
        now_wall = tracing.now()
        for req in failed:
            self._emit_req_span(
                req, "engine:decode",
                req.first_wall or req.admit_wall or req.submit_wall,
                now_wall, tokens=req.generated, reason="error",
                error=repr(exc)[:200])
            self._release(req)
        self.slots = [None] * self.config.batch_slots
        self._traced_slots = 0
        # The pools are rebuilt below, so every cached KV page and every
        # resident adapter slot is garbage: drop the tree's refs and reset
        # the adapter pool (the registry survives; adapters reload on next
        # acquire).
        if self._cache is not None:
            self._cache.clear(self.allocator)
        self.adapter_pool.reset()
        self._page_tables[:] = self.scratch
        self._seq_lens[:] = 0
        self._tokens[:] = 0
        self._active[:] = False
        self._temps[:] = 0.0
        self._adapter_slots[:] = self.adapter_pool.zero_slot
        self._dirty = True
        self.pools = init_paged_pools(
            self.model_config, self.config.pool_pages,
            self.config.page_size, device=self.device)
        for req in failed:
            req.out_q.put(("err", exc, self.step_count))

    def _loop(self) -> None:
        while True:
            # The step span's start, stamped only while a traced request
            # holds a slot: untraced traffic pays this comparison alone.
            start = tracing.now() if self._traced_slots else 0.0
            with self._lock:
                if self._stop:
                    break
                control, self._control = self._control, []
                # Reap cancellations first: queued cancels just drop,
                # in-flight cancels free pages before admission looks at
                # the pool.
                reaped = False
                for q in self._queues.values():
                    keep = []
                    for r in q:
                        if r.cancelled.is_set():
                            self.cancelled_count += 1
                            self._tenant_rec(r.tenant)["cancelled"] += 1
                            self._m_cancelled.inc(1)
                            r.out_q.put(
                                ("done", "cancelled", self.step_count))
                            reaped = True
                        else:
                            keep.append(r)
                    q[:] = keep
                if reaped:
                    self._m_queue.set(self._queued_total(),
                                      tags=self._pid_tags)
                for slot, req in enumerate(self.slots):
                    if req is not None and req.cancelled.is_set():
                        self._evict(slot, "cancelled")
                admitted = self._admit_locked()
                active = sum(1 for s in self.slots if s is not None)
                if not admitted and active == 0 and not control:
                    self._m_active.set(0, tags=self._pid_tags)
                    self._m_pages.set(self.allocator.used_count,
                                      tags=self._pid_tags)
                    self._wake.wait(timeout=0.05)
                    continue
            span = None
            if self._traced_slots:
                # A step that admits the first traced request starts at
                # that admission.
                span = {"start": start or min(
                    r.admit_wall for r in admitted if r.trace_ctx is not None),
                    "admitted": tracing.now(), "prefills": len(admitted)}
            # Model work runs OUTSIDE the lock: pools/slot arrays belong
            # to this thread; submit() only appends to the wait queue.
            # Control ops run here for the same reason.
            for task in control:
                task()
            try:
                decoded = self._run_step(admitted, span)
            except Exception as e:  # noqa: BLE001: fail streams, not
                self._fail_inflight(e)  # the loop thread
                continue
            if span is not None:
                self._emit_step_span(span, decoded)
        # Shutdown: fail queued + in-flight requests loudly, and unblock any
        # control-op waiters.
        with self._lock:
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            control, self._control = self._control, []
            self._m_queue.set(0, tags=self._pid_tags)
        for task in control:
            task()
        for req in pending:
            req.out_q.put(("err", RuntimeError(
                "engine shut down before admission"), self.step_count))
        for slot, req in enumerate(self.slots):
            if req is not None:
                self._evict(slot, "shutdown")

    def _run_step(self, admitted: List[_Request],
                  span: Optional[Dict[str, Any]] = None) -> bool:
        """Prefill the admitted requests, then run one decode step over
        the busy slots; returns whether it decoded.  ``span`` (a traced
        step) takes the step's phase stamps and host counters."""
        # Flight recorder entry state: step wall, admission-stall span and
        # per-step deltas come from host counters only: no device sync, no
        # lock beyond what the loop already holds.
        rec_on = self.config.step_record
        t0 = time.perf_counter()
        stall_s = 0.0
        evicted0 = self._evicted_total
        shed0 = self.shed
        pc_hits0 = self.prefix_hits
        traces0 = jitguard.total() if rec_on else None
        for req in admitted:
            pf0 = time.perf_counter()
            self._prefill(req)
            stall_s += time.perf_counter() - pf0
        self.prefill_s += stall_s
        if span is not None:
            span["prefilled"] = tracing.now()
        if not any(s is not None for s in self.slots):
            if rec_on and admitted:
                self._record_step(t0, stall_s, len(admitted), evicted0,
                                  shed0, pc_hits0, traces0, decoded=False)
            return False
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
        if span is not None:
            busy = int(self._active.sum())
            span["occupancy"] = busy
            # Positions attended (each busy slot's cache and the new
            # token) against those the page-table gather reads.
            span["kv_live"] = int(self._seq_lens[self._active].sum()) + busy
            span["kv_read"] = (self.config.batch_slots * self.maxp
                               * self.config.page_size)
            span["launch"] = tracing.now()
        (self._d_tokens, self._d_seq_lens, self._d_key,
         self.pools) = paged_decode_step(
            self.model_config, self.params, self.pools,
            self.adapter_pool.arrays,
            self._d_tokens, self._d_page_tables, self._d_seq_lens,
            self._d_active, self._d_temps, self._d_adapter_slots,
            self._d_key)
        if span is not None:
            span["launched"] = tracing.now()
        toks = self._d_tokens.cpu().numpy()  # rt-sync-ok: THE decode-step readback — one batched token fetch per step
        if span is not None:
            span["synced"] = tracing.now()
        now = time.perf_counter()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self._seq_lens[slot] += 1
            self._tokens[slot] = toks[slot]
            if req.last_token_t is not None:
                itl = now - req.last_token_t
                if req.trace_ctx is not None:
                    req.itl_sum += itl
                    req.itl_n += 1
                self._m_itl.observe(itl)
            req.last_token_t = now
            self._emit_token(req, int(toks[slot]))
        self._m_active.set(sum(1 for s in self.slots if s is not None),
                           tags=self._pid_tags)
        self._m_pages.set(self.allocator.used_count, tags=self._pid_tags)
        if rec_on:
            self._record_step(t0, stall_s, len(admitted), evicted0,
                              shed0, pc_hits0, traces0, decoded=True)
        return True

    def _emit_step_span(self, span: Dict[str, Any], decoded: bool) -> None:
        """The ``engine:step`` span of the step that just ran, from the
        loop iteration's start to now: ``engine`` and ``step`` join it to
        the step's record; the phase stamps are ``tracing.now()`` walls,
        unrounded.  Into the engine's own trace, with no parent."""
        start = span.pop("start")
        tracing.emit_span(tracing.make_span(
            {"trace_id": self._step_trace}, "engine:step", start,
            tracing.now(), engine=self.engine_id, step=self.step_count,
            decoded=decoded, **span))

    def _record_step(self, t0: float, stall_s: float, admitted: int,
                     evicted0: int, shed0: int, pc_hits0: int,
                     traces0: Optional[int], decoded: bool) -> None:
        """Append one flight-recorder record for the step that just ran.
        Called on the loop thread; everything here is host bookkeeping
        (the decode result was already read back for token emission)."""
        wall_s = time.perf_counter() - t0
        now = time.time()
        if decoded:
            self._step_walls.append(wall_s)
        if stall_s > 0:
            self._stall_events.append((now, stall_s))
            self._m_stall.inc(stall_s)
        # Compile observability: a trace-count bump inside this step means
        # this step's wall paid a program's first run with a new signature
        # (on the card, possibly a kernel's build): attribute it.
        if traces0 is not None and jitguard.total() > traces0:
            for prog in dict.fromkeys(jitguard.traced_since(traces0)):
                devmem.record_compile(prog, wall_s)
        with self._lock:
            queued = self._queued_total()
            tenants = {t: len(q) for t, q in self._queues.items() if q}
        steprec.record_step({
            "t": round(now, 3),
            "engine": self.engine_id,
            "step": self.step_count,
            "wall_s": round(wall_s, 6),
            "stall_s": round(stall_s, 6),
            "occupancy": sum(1 for s in self.slots if s is not None),
            "slots": self.config.batch_slots,
            "admitted": admitted,
            "evicted": self._evicted_total - evicted0,
            "shed": self.shed - shed0,
            "queued": queued,
            "pages_used": self.allocator.used_count,
            "pages_free": self.allocator.free_count,
            "pages_shared": self.allocator.shared_count,
            "prefix_hits": self.prefix_hits - pc_hits0,
            "adapter_pins": self.adapter_pool.pinned_count,
            "tenants": tenants,
        })


def random_lora(model_config, seed: int, rank: int = 8, alpha: float = 16.0,
                device: DeviceLike = None) -> Lora:
    """A deterministic nonzero LoRA for tests, benchmarks and demo
    adapters (``lora_init`` zeroes the B matrices, which would make every
    adapter a no-op): ``lora_init`` from a ``torch.Generator`` seeded with
    ``seed``, then both B matrices of every layer drawn at 0.05 N(0, 1).
    The values differ from the JAX ``random_lora``'s for the same seed (the
    RNGs differ); carry a JAX adapter across with ``lora_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lora = lora_init(model_config, gen, rank=rank, alpha=alpha, device=dev)
    with torch.no_grad():
        for layer in lora.layers:
            _normal_(layer.wq_lora_b, 0.05, gen)
            _normal_(layer.wv_lora_b, 0.05, gen)
    return lora


# ------------------------------------------------------------ serve binding


_MODEL_BUILDERS = {
    "tiny": lambda: _tiny_config(),
    "b1": lambda: _b1_config(),
}


def _tiny_config():
    from ..models.llama import LlamaConfig

    return LlamaConfig.tiny(remat=False, dtype=torch.float32)


def _b1_config():
    from ..models.llama import LlamaConfig

    return LlamaConfig.b1(remat=False, dtype=torch.bfloat16)


def _kernel_launches() -> Dict[str, int]:
    """This process's launch count of each kernel wrapper (``ops``)."""
    from ..ops import attention, norms

    return {"flash_fwd": attention.flash_attention_fwd.launches,
            "flash_bwd_dq": attention.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": attention.flash_attention_bwd_dkv.launches,
            "rms_norm": norms.rms_norm_cuda.launches,
            "rms_norm_bwd": norms.rms_norm_bwd.launches}


class LLMServer:
    """The deployment callable: one engine per replica, tokens streamed
    through serve's per-item streaming path (handle iterators, HTTP SSE,
    gRPC server-streaming).  A consumer that disconnects mid-stream
    closes the generator, which cancels the request and frees its pages.

    Multi-tenant: ``adapter=`` picks a registered LoRA (defaulting to the
    ambient multiplexed model id, so ``multiplexed_model_id`` routing
    composes with the engine's batched adapters), ``tenant``/``weight``
    feed weighted-fair admission.

    The weights are ``llama_init``'s from a ``torch.Generator`` seeded
    with ``seed``, built on ``device``: the card unless ``device="cpu"``
    (with no card visible, as in a replica granted none, that raises)."""

    def __init__(self, model: str = "tiny",
                 engine: Optional[dict] = None, seed: int = 0,
                 warmup: bool = False,
                 adapters: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        from ..models.llama import llama_init

        cfg = _MODEL_BUILDERS[model]()
        dev = resolve_device(device)
        params = llama_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                            dev)
        self.engine = InferenceEngine(
            cfg, params, EngineConfig(**(engine or {})), seed=seed,
            device=dev)
        for name, spec in (adapters or {}).items():
            self.load_adapter(name, spec)
        if warmup:
            self.engine.warmup()

    def load_adapter(self, name: str, source: Any = None) -> str:
        """Register a LoRA adapter on this replica's engine.  ``source``
        is packed tensors / a ``Lora`` / a numpy tree / an object-store
        ref / a zero-arg builder, or an int seed (a deterministic random
        adapter, ``random_lora`` on the engine's device: handy for tests
        and benchmarks)."""
        if isinstance(source, int):
            seed = source
            cfg = self.engine.model_config
            rank = self.engine.config.lora_rank
            dev = self.engine.device
            source = lambda: random_lora(cfg, seed, rank=rank,  # noqa: E731
                                         device=dev)
        self.engine.register_adapter(name, source)
        return name

    def __call__(self, prompt_tokens, max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 stop_token: Optional[int] = None,
                 adapter: Optional[str] = None,
                 tenant: str = "default", weight: float = 1.0):
        if adapter is None:
            # serve.multiplexed routing: the handle's multiplexed_model_id
            # arrives via the replica's contextvar.
            from .multiplex import get_multiplexed_model_id

            adapter = get_multiplexed_model_id() or None
        stream = self.engine.submit(
            prompt_tokens, max_new_tokens=max_new_tokens,
            temperature=temperature, stop_token=stop_token,
            adapter=adapter, tenant=tenant, weight=weight)
        try:
            for tok in stream:
                yield tok
        finally:
            # Reached on completion AND on GeneratorExit (client gone,
            # task cancelled): idempotent, frees pages mid-flight.
            stream.cancel()

    def stats(self) -> Dict[str, Any]:
        """The engine's ``stats()`` plus ``kernel_launches``: this replica
        process's launch count of each CUDA kernel wrapper, so a client
        can see which kernels its requests ran on the card."""
        return dict(self.engine.stats(), kernel_launches=_kernel_launches())

    def engine_metrics(self) -> Dict[str, Any]:
        """SLO signal snapshot for the controller's autoscaler."""
        return self.engine.slo_signals()

    def weight_checksums(self) -> Dict[str, float]:
        """The fp64 sum of each weight tensor, by name: lets a client check
        that a replica built the weights it expects from the seed."""
        return {n: float(p.double().sum())
                for n, p in self.engine.params.named_parameters()}


def llm_app(model: str = "tiny", engine: Optional[dict] = None,
            num_replicas: int = 1, name: str = "llm", seed: int = 0,
            warmup: bool = False,
            adapters: Optional[Dict[str, Any]] = None,
            device: DeviceLike = None):
    """Build a servable LLM application:
    ``serve.run(llm_app(...))`` then stream tokens via
    ``handle.options(stream=True).remote([1, 2, 3], 16)`` or POST with
    ``Accept: text/event-stream``.  ``adapters`` maps adapter name to an
    int seed (random adapter) or weight source, registered on every
    replica at startup.  Each replica is granted one card
    (``ray_actor_options={"num_gpus": 1}``) and runs on it, unless
    ``device="cpu"``: then it asks for none and runs on the CPU."""
    from .api import Deployment

    on_cpu = device is not None and torch.device(device).type == "cpu"
    dep = Deployment(LLMServer, name, num_replicas=num_replicas,
                     ray_actor_options=None if on_cpu else {"num_gpus": 1})
    return dep.bind(model=model, engine=engine, seed=seed, warmup=warmup,
                    adapters=adapters, device=device)

