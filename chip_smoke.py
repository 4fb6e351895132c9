#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. card: ``nvidia-smi`` name and power limit.
2. build: compile every kernel under ``ray_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together); print ptxas's
   registers and spills, and fail if the bf16 K2 or K3 kernels or any K4
   kernel spill.
3. K4 (``csrc/rms_norm.cu``): the forward against ``_rms_ref`` (fp32 and
   bf16, d 4096, 4100 and 128, 8 to 2048 rows), timed at [8, 512, 1000,
   2048] x 4096 bf16 beside the plain version and ``F.rms_norm``; the
   backward (dx and dw) against ``_rms_bwd_ref`` on the same cases and
   with w frozen, dw bit-identical over two calls, timed at [2048, 4096]
   bf16 beside the plain version and ``F.rms_norm``'s autograd backward.
4. K1 (``csrc/flash_fwd.cu``) against ``flash_attention_ref`` (out and
   lse) over Llama-3-8B shapes, GQA groups, head dims, offsets, ragged
   lengths, the bf16 kernel's block edges, transposed [B, S, H, D] views,
   the cached-prefix prefill's suffix buckets at q_offset = prefix_len over
   the gathered page table, and both dtypes (head_dim 32 in both), lse
   bit-equal on rows that see no key; timed beside the plain version and
   SDPA.
5. K2 and K3 (``csrc/flash_bwd.cu``) against ``flash_attention_bwd_ref``
   (dQ, dK, dV) over K1's first cases and 32/8 heads (head_dim 32 in both
   dtypes), Sq > Sk, and fed by K1's own (out, lse) at negative offsets;
   timed at the training shape (S = 512 and 2048) beside the plain
   version and SDPA's backward, with the SM clock sampled before and
   after each timed loop.
6. tiny serve: the tiny model (head_dim 32, ``llm_app``'s default model)
   served on the card by ``InferenceEngine``, in fp32 (its greedy tokens
   must equal the same engine's on the CPU from the same parameters) and
   in bf16, its default dtype (its prefill logits held against the fp32
   forward of the same parameters on the CPU).
7. forward: ``llama_apply`` on full Llama-3-8B (32 layers, random weights
   from a seed) at B=1, S=2048, then a 2-layer full-width model against the
   same weights in fp32 on the CPU through the plain path.
8. serve: ``InferenceEngine`` on full Llama-3-8B answers 12 requests (8 at
   once, 4 admitted while those decode); checks counts, page balance and
   greedy agreement with ``generate``; then a warm 8-request window under
   the profiler: wall, prefill and device busy time of that one window.
9. observe: serving observability on the same model.  A default-built
   engine (recording and prefix cache on), warmed under RT_DEBUG_JIT=1 so
   the recompile sentinel is armed, serves the serve phase's mix in one
   forced root trace: no RecompileError and no new program signature;
   three stage spans per request under the root, the decode spans' tokens
   equal to those streamed, TTFT from the spans within 10 ms of the
   engine's, the stage breakdown printed; 17-field step records admitting
   every request, none dropped, the last one's pages adding up to the
   pool; the token, prefill-token, completion and TTFT metric deltas equal
   to the engine's counts, every engine metric in the Prometheus text;
   devmem pools summing to the allocator's live bytes, the weights' and
   the KV pool's bytes exact, the limit the card's memory; one
   ``device_trace`` window over 8 decode steps, which must write its trace
   file (its idle share beside the serve-profile window's; up to three
   windows, "not measured" if CUPTI records no device activity in any);
   then the same mix with ``step_record`` on, off, off, on (tokens/s,
   the p50 inter-token latency and the host time of each record).
10. multitenant: the radix prefix cache and the LoRA adapter pool.  (a)
   The tiny model in fp32 (prefix cache on, 2 adapters): a 48-token
   shared prefix with six tails and a fork inside its second page, over
   the base model and both adapters, served twice; greedy tokens equal to
   the same engine's on the CPU, >= 5 prefix hits, one decode signature,
   the free list balanced after ``clear_prefix_cache()``.  (b) Full
   Llama-3-8B in bf16 (4 adapter slots, 2 adapters from ``random_lora``):
   a 384-token system prompt cached under each, then 12 requests (tails
   of 16-100 tokens, one forking at token 200) x 32 greedy tokens at
   once, every one a prefix hit whose suffix prefill launches K1 and K4;
   no decode signature added; the designated base and adapter requests'
   first tokens equal to the same prompts served cold; TTFT of each
   prompt served alone from the cache and cold.  K1 is timed at a suffix
   shape (Sq 64, Sk 576, q_offset 384) beside the plain version and SDPA
   with an explicit boolean mask.
11. runtime: the port's runtime core and its libraries on the card.
   ``rt.init(num_cpus=4, include_dashboard=True)`` in this process (the object
   store sized to half of ``/dev/shm``'s free space, at most 4 GiB) must
   autodetect ``GPU: 1``.  An ungranted task sees ``CUDA_VISIBLE_DEVICES=""``
   and its ``resolve_device()`` raises. Layer 0 of the 8B model (a CPU
   ``Block``, 218.1 M parameters, 436 MB of bf16) and a seeded [1, 2048, 4096]
   activation go through ``put``; a ``num_gpus=1`` task gets both by
   ``ObjectRef``, runs ``_block`` on the card (K1 once, K4 twice) and returns
   a CUDA tensor, whose ``get`` must be a CPU tensor bit-identical to
   ``_block`` run here (put and get GB/s printed).  The serve phase's 12
   prompts are served greedily one at a time in process, then by a
   ``num_gpus=1`` actor that builds the same 8B weights from the seed (fp64
   checksums equal to this process's) and an engine of the serve phase's
   config: tokens equal token for token. Both sides then serve the prompts
   once more, by one function in each process (1 token each), and report the
   engine's own TTFT split into its queue wait and its prefill, for the first
   pass (the actor's process is cold) and the warm one; the first token
   through an actor call, and the task and actor round trips.  The actor's
   step records (17 fields), spans and devmem pools must reach the head's
   ``list_state``.  The actor's start is printed by stage (spawn to its first
   line, ``import torch`` and the OS threads it leaves, the CUDA context, the
   8B build, the engine).  Then, while the actor holds the card: the 12
   prompts through actor calls (8 greedy tokens each, as on the DAG, timed);
   (a) a compiled DAG ``encode -> greedy -> collect`` (the actor is
   ``enable_compiled_dags``; the outer stages are CPU actors granted no card,
   a token list to an int64 tensor and back) serves the 12 prompts one
   ``execute`` at a time, then pipelined through ``execute_async`` (submitted
   from a thread, results taken in order), each equal token for token to the
   in-process engine's; a prompt longer than ``max_prompt_len`` raises the
   engine's ``ValueError`` at ``execute`` and the next execution serves; a
   three-stage no-op DAG's round trip is printed beside three chained actor
   calls; after ``teardown()`` the actor answers a call and no CPU stage
   initialised CUDA; (b) during the pipelined pass ``python -m ray_tpu_torch``
   in subprocesses: ``status`` shows ``GPU: 1/1 used``, ``list actors`` the
   engine actor ALIVE, ``stack`` its thread in the DAG exec loop, and
   ``profile --seconds 3`` replies and writes its trace, whose kernels must
   include K1's and K4's (up to three windows; "not measured" if CUPTI records
   none); (c) the dashboard's ``/api/status`` shows the card held (GPU 0
   available of 1) and ``/metrics`` the engine's ``ray_tpu_gen_tokens_total``.
   While the actor holds the card a second ``num_gpus=1`` task stays pending,
   and runs on the card once the actor is killed. ``nvidia-smi`` may list no
   more compute processes than this one and the granted workers; in a
   container whose ``nvidia-smi`` reports pids of another namespace that is a
   count only, since those pids cannot be told apart (the ungranted probe is
   what proves isolation).  Then (d) a durable workflow ``act -> layer ->
   digest`` (the seeded activation; ``_rt_block_task`` submitted with
   ``num_gpus=1`` from inside the ``layer`` step on layer 0 from the object
   store; a digest that fails its first attempt): the first ``workflow.run``
   raises, a second run of the same ``workflow_id`` loads ``layer`` from
   storage, so the GPU task runs once in all (a KV counter), and the digest
   equals ``_block`` here bit for bit; (e) a job: ``JobSubmissionClient`` runs
   ``python job_entry.py``, which joins the cluster and runs K4 in a
   ``num_gpus=1`` task on a seeded [2048, 4096] bf16 input; it must end
   SUCCEEDED with its result line in its logs, the output equal to K4 here bit
   for bit, one K4 launch, the job listed by ``/api/jobs`` and the card free
   again in ``/api/status``.  Each of these paths prints its seconds.
12. autoscale: a GPU node added on demand.  ``rt.init(num_cpus=1,
   num_gpus=0)``: a head with no card.  An ``Autoscaler`` (``max_nodes=1``,
   idle timeout 3 s, poll 0.25 s) over ``GpuSliceNodeProvider`` with the
   1-host, 1-card shape ``a3-highgpu-1g`` and the in-memory Compute Engine
   stand-in; a ``num_gpus=1`` task gets layer 0 of the 8B model and a
   seeded [1, 2048, 4096] bf16 activation from the object store and runs
   ``_rt_block_task`` (K4, K1, K4).  The demand must make exactly one
   create, the task run on the added node with a non-empty
   ``CUDA_VISIBLE_DEVICES``, launch K1 once and K4 twice, and return
   ``_block``'s output here bit for bit; after the idle timeout the slice
   must get exactly one delete of the same id, the instance's history be
   ``QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING -> TERMINATING ->
   TERMINATED``, and the card's free memory after shutdown come back
   within 1 GiB of what it was before the phase.  Submit to result is
   printed split into scale-up, worker start and task, then the
   scale-down, each with the card's name and power limit; the phase must
   end within 60 s.
13. serve front: the port's serving front on the card, with its own
   ``rt.init(num_cpus=4)`` (the GPU count from NVML).  (a) The b1 app
   through ``serve.run(serve.llm_app(model="b1", engine=dict(
   batch_slots=8, page_size=16, max_prompt_len=512), adapters={"a1": 1,
   "a2": 2}))``: one replica granted the card builds b1 at its full
   widths (d_model 2048, 20 layers, 16 heads of 128, d_ff 5632, vocab
   32000, bf16, 1.16 B parameters) from the seed; its fp64 weight
   checksums must equal the driver's.  The serving cell's 12 prompts (8,
   then 4 while those decode, 32 greedy tokens each), half through
   ``handle.options(stream=True)`` and half as HTTP SSE from
   ``start_http()``, one by ``multiplexed_model_id`` and one by
   ``adapter=``, one cancelled after 4 tokens; then an adapter put in the
   object store and registered by its ``ObjectRef``, whose tokens must
   equal the same adapter registered directly; then the mix again on
   fresh prompts (a warm pass).  Every stream's tokens must equal an
   in-process engine's from the same seed, served one at a time, and the
   replica's pages must balance (free plus cached, none shared).  (b)
   With the b1 app deleted, a ``serve.deployment`` with
   ``ray_actor_options={"num_gpus": 1}`` builds Llama-3-8B from
   ``phase_forward``'s seed and the serve phase's ``EngineConfig``; the
   serving mix, greedy, through the streaming handle, twice: the tokens
   must equal the runtime phase's in-process engine's and the serve
   phase's greedy requests'; then the same mix inside the replica with
   no front.  Each request is traced (a forced root at the handle,
   ``X-RT-Force-Trace`` over SSE), so its engine TTFT and inter-token gap
   come from its ``engine:decode`` span at the head; printed beside the
   client's TTFT (submission to the first item) and gap, their
   difference (the front's added latency, per request and per token),
   tokens/s at the client and each replica's start time, with the card's
   name and power limit.  gRPC is not driven on the card (the CPU tests
   hold it against the JAX package).
14. train: the serving model is freed; ``make_train_step(llama_loss)``
   with ``default_optimizer(lr=1e-4)`` on full Llama-3-8B (random weights
   from a seed, remat full) at B=1, S=2048: 2 warm and 5 timed AdamW
   steps (step time, tokens/s, MFU under bench.py's convention, peak
   memory; loss and grad norm finite, the loss falling), then one step
   under the profiler (idle share, time by kernel kind).
15. remat: on the same model and optimizer state, ``full`` (the others'
   reference in this phase), then each of ``save_attn``, ``save_dots``,
   ``save_dots_no_batch`` and ``xla_cse``: its peak reckoned first (a
   policy that would not fit runs last on a fresh model at the deepest
   depth that fits), then 1 warm and 3 timed steps (step time, MFU, peak
   memory, allocator retries, SM clock) and one step under the profiler
   (idle share, time by kernel kind).
16. train check: a 2-layer full-width model's loss and every gradient in
   bf16 (K4's backward included) against the same weights in fp32 on the
   CPU through the plain path (B=1, S=256); then under each of the six
   remat policies a 2-layer model's loss and gradients at S=2048 against
   ``full``'s on the card (bit-identical, or within 2^-8).
17. moe: ``MoEConfig.mixtral_8x7b(n_layers=4)`` (Mixtral-8x7B's widths,
   6.07 B parameters, bf16, router fp32, remat full) at B=1, S=2048: a
   ``moe_apply`` forward, 2 warm and 5 timed
   ``make_train_step(moe_loss)`` steps (step time, tokens/s, MFU with N
   the active parameters, peak memory; the loss falling), one step's idle
   share and one step's time by kind (expert GEMMs, dense GEMMs, dispatch
   and combine apart from other glue); then a 1-layer full-width model's
   loss and every gradient in bf16 against fp32 on the CPU (B=1, S=256),
   and the tokens each expert kept, card against CPU, with the router
   margins of tokens whose choice differs.
18. mlp: the MNIST MLP built with no device (so on the card), 20 AdamW
   steps; the loss must fall by half.
19. rllib: the learners, models and in-process env runners of
   ``ray_tpu_torch.rllib`` on the card in fp32, none given a device.  (a)
   The main path: PPO on CartPole at ``PPOConfig``'s defaults (two
   ``EnvRunner``s of 8 envs x 64 steps, GAE, ``update_from_batch`` of 10
   epochs x minibatch 256, weights synced back), 5 iterations and one
   more under the profiler: env steps/s, learn time an iteration, idle
   share.  (b) ``PPOLearner`` on ``CNNModel`` at the Nature-DQN widths
   (84 x 84 x 4 frames, convs 32/64/64 of 8/4/3 by strides 4/2/1, dense
   512) with the PPO paper's Atari settings: one ``update_from_batch`` of
   1,024 seeded synthetic frames (3 epochs x minibatch 256), wall and
   device time, frames/s, one minibatch step, the host-to-device copy,
   peak memory, idle share.  (c) DQN (a replay buffer filled by
   ``sample_transitions``, 64 updates of 64, ``sync_target``), IMPALA (two
   ``ImpalaEnvRunner`` fragments of 64 x 8 an update), SAC on Pendulum
   (hidden 256, batch 256) and BC (on a dataset ``collect_offline_dataset``
   writes): the time of an update.  Each learner's update is held to the
   same update on the CPU from the same weights (SAC with the same
   noise): losses within 1e-4 relative (+1e-6), the gradients within 1e-4
   relative norm, the parameters within Adam's bound (``_rl_gate``).  (d)
   Two ranks on the one card over gloo: PPO's ``update_from_batch`` at
   ``mesh=`` dp 2 against the one-process update.
20. train gang: the training library on the card, its own
   ``rt.init(num_cpus=4)`` (``GPU: 1`` from NVML), started once the
   driver has emptied its cache (its reserved bytes printed first).
   ``TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1,
   use_gpu=True))``: the one worker, granted the card, builds full
   Llama-3-8B (not cut) from the train phase's seed and runs the train
   phase's configuration (B=1, S=2048, remat full,
   ``default_optimizer(lr=1e-4)``), 1 warm and 5 timed steps, each
   reported with its loss and milliseconds; the session's
   ``TrainTelemetry`` adds the MFU from ``set_flops_per_step`` (6N +
   6·L·S·d a token, against 989 TFLOP/s).  The worker's own launch counts
   must equal six steps' (``_train_launches``), its first loss the train
   phase's (within 1e-3), and its median step at most 1.5x the train
   phase's in this call (printed beside it with the MFU).  Then a 1-layer
   model at the 8B widths: 3 steps uninterrupted, and 3 steps with a
   checkpoint (the whole ``TrainState``) reported at step 2 and the worker
   SIGKILLed right after; under ``FailureConfig(max_failures=1)`` a new
   worker restores it, and its step-3 loss must equal the uninterrupted
   run's bit for bit.
21. data tune: ``ray_tpu_torch.data`` and ``tune`` on the card, with
   their own ``rt.init(num_cpus=6)``.  (a) 8 seeded rows of S = 2048
   int64 tokens through ``data.from_numpy``, ``map_batches`` (targets
   rolled by one), ``streaming_split(1)`` and ``iter_batches(
   batch_size=1, device="cuda")``: every batch on the card equal bit for
   bit to its host rows, its staging tensors pinned and its copies on a
   stream other than the consumer's (``DataContext``'s
   ``last_prefetch_stats``); the copy GB/s (CUDA events on the copy
   stream) and the consumer's wait per batch printed.  (b) ``Tuner(
   TorchTrainer(loop, datasets={"train": ds}, scaling_config=
   ScalingConfig(num_workers=1)), param_space={"train_loop_config":
   {"lr": grid_search([1e-4, 3e-4])}}, tune_config=TuneConfig(
   metric="loss", mode="min"))``: each trial's one worker, granted the
   card, builds full Llama-3-8B (not cut) from the train phase's seed and
   takes 4 AdamW steps at B=1, S=2048, one batch a step from its shard
   (``iter_batches(batch_size=1, device="cuda")``; ``ds`` holds the
   train phase's tokens, then three seeded rows).  Both trials must end
   TERMINATED, each worker granted the card, each first loss equal bit
   for bit to the train gang's, the step-2 losses differing (the lr
   reached the loop), ``get_best_result()`` naming the trial with the
   lower final loss, and each worker's launches exactly 4 steps' worth;
   each trial's median step after two warm steps (as the train phase
   times its steps) at most 1.5x the train phase's, printed beside it
   with every step's time, the session's data wait a round and each
   step's host numbers (the loop thread's CPU time, garbage collection,
   the allocator's retries and new segments, other processes' CPU time;
   the train gang prints them too).
22. rllib drivers: ``rt.init(num_cpus=6)``, every runner an actor granted
   no card (``device="cpu"``), every learner in this process on the card.
   (a) ``PPO`` on CartPole at ``PPOConfig``'s defaults, 3 iterations,
   against the same driver with ``device="cpu"``: env steps and returns
   equal, the losses within the rllib phase's 1e-4 relative (+1e-6); (b)
   one iteration of ``PPO`` at the Nature-CNN widths and the PPO paper's
   Atari settings on seeded 84 x 84 x 4 frames; (c) one iteration each of
   ``DQN`` (updates from the first iteration), ``Impala``, ``SAC`` (no
   warmup) and ``MultiAgentPPO`` (two policies): finite losses from a
   learner on the card.  No csrc kernel launches on these paths.
23. parallel: four ranks spawned on the one card (NCCL refuses two ranks
   on one device, so they join a gloo group through a FileStore, gloo
   carrying CUDA tensors through pinned host memory; the ranks load the
   kernels phase 2 built and never run nvcc), each sub-step against its
   unsharded reference computed first on the card by this process, at
   Llama-3-8B's widths (``llama3_8b(max_seq=8192)``, bf16, random weights
   from the seed), depth cut because four ranks share one card: (a) ring:
   ``ring_attention`` forward and backward at B 1, H 32, Hkv 8, D 128,
   causal, S 8192 over sp 4, out/dQ/dK/dV by chunk against
   ``flash_attention`` over the whole sequence (relative norm error
   <= 2^-7, the K2/K3 phase's bf16 bound); (b) sharded: 1 layer,
   ``MeshConfig(fsdp=2, tp=2)``, B 2, S 2048, one ``make_train_step(
   llama_loss)`` step: its loss and grad norm and every parameter after
   it, and a local wq shard a quarter of the global one; (c)
   seq-sharded: 1 layer, ``MeshConfig(fsdp=1, sp=4)``, ``sp_shard_seq``,
   B 1, S 8192, one step (the ring in the layer); (d)
   pipeline: 4 layers, ``make_pp_loss`` over pp 4, 4 microbatches of B 4,
   S 2048: the loss and every gradient; (e) moe-ep:
   ``MoEConfig.mixtral_8x7b(n_layers=1)``, ``MeshConfig(fsdp=1, tp=2,
   ep=2)``, B 1, S 2048, one step, with the tokens whose experts differ
   from the reference's and their router margins.  Each rank's step time
   is printed beside the card's name and power limit: four ranks share
   one card, so the times are no scaling figure.

Kernel launch counters are zeroed just before the tiny serve, the
forward, the serve, the observe mix, the multitenant, the train, each
remat policy's, the moe, the rllib and the rllib drivers' paths run and
read just after (the rllib paths launch none of the csrc kernels).  The
train gang's worker zeroes its own process's counts before its first
step and reports them with its last: six steps' worth; each data-tune
trial's worker does the same, four steps' worth, and the path's count is
the two trials' sum.  The autoscale path's task zeroes its own
process's counts just before its ``_block`` and returns them after it
(K1 once, K4 twice).  On the runtime path the
GPU task and the engine actor zero their own process's counters just
before their main path and return them after it: the task must launch K1
once and K4 twice, the actor K1 and K4's forward.  The runtime phase's
library paths count in their own processes too: the engine actor zeroes
its counts before the compiled DAG is compiled and reads them after its
teardown (the dag path: K1 and K4's forward, never K2, K3 or K4's
backward), the workflow's GPU task reads its own (K1 once, K4 twice) and
the job's task reports its own (K4 once).  On the serve-front path each
replica reads its own process's counts through a method of
its deployment (``stats()["kernel_launches"]``) just before the main
path and just after it (the b1 replica is fresh, its counts 0); the
replicas together must launch K1 and K4's forward, and never K2, K3 or
K4's backward.  K1 and K4's
forward must have launched on the tiny serve, forward, serve and observe
paths (K4's backward never), on the multitenant path K1 once a layer per
prefill and K4's forward once a norm per program call.  Per layer and step a train step
with remat full (Llama's and MoE's) launches K1 and, per norm, K4's
forward twice (forward and remat recompute), K2, K3 and K4's backward
once, plus the final norm once each way; ``save_attn`` launches K1 once,
``save_dots`` and ``save_dots_no_batch`` as full, and no checkpoint
(``xla_cse``) K1 and K4's forward once (``_train_launches``).
Each rank of the parallel phase zeroes its counts just before a
sub-step's main path and reads them just after; the parent sums them
over the ranks, and each rank's must equal the path's count: per ring
step and layer, K1 forward (twice under remat) and K2 and K3 backward.
The second-to-last JSON line lists every kernel with its launches per
path, error, times and bound; the last line is the device record.
``--report PATH`` also writes every phase's numbers to PATH as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# Published H100 SXM peaks (dense), the bound's denominators.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after ``warmup`` calls; inputs stay L2-warm).  Where the
    host issues calls slower than the device runs them this is the host's
    rate; ``device_ms`` gives the kernels' own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_window(torch, fn, iters: int = 10):
    """Run ``fn`` ``iters`` times under torch.profiler and return, for that
    one window, ({CUDA kernel name: device ms per call}, wall ms per call).
    The wall time is the host clock from the first call to the end of the
    last kernel, inside the profiled window, so busy / wall is the device's
    busy share of the same window.  Only device activity is traced (no host
    op records), which keeps the profiler's own host time small.  A window
    in which the profiler saw no device activity is profiled again, up to
    three times in all (CUPTI dropped a whole window's records on the
    H100 machine, twice in a row once); raises if none saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
        if by_name:
            return by_name, wall_ms
        print("[profile] torch.profiler saw no device activity; profiling "
              "the window again", flush=True)
    raise PhaseError("torch.profiler saw no device activity")


def device_ms(torch, fn, iters: int = 10) -> float:
    """Summed per-call device time (ms) of ``fn``'s kernels, after one warm
    call."""
    fn()
    return sum(profile_window(torch, fn, iters)[0].values())


def backward_ms(torch, fwd_bwd, fwd, attempts: int = 3):
    """Device time of a backward: ``fwd_bwd`` (forward and backward)
    less ``fwd`` (the forward alone), as ``(ms, how)``.  CUPTI has dropped
    part of a window's records on the H100 machine, which once made the
    difference negative: a difference that is not positive is measured
    again, up to ``attempts`` times, and then taken from CUDA events over
    back-to-back calls instead of the profiler."""
    for _ in range(attempts):
        ms = device_ms(torch, fwd_bwd) - device_ms(torch, fwd)
        if ms > 0:
            return ms, "profiler"
        print(f"[profile] forward and backward less the forward read "
              f"{ms:.4f} ms; measuring again", flush=True)
    return time_ms(torch, fwd_bwd) - time_ms(torch, fwd), "cuda events"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def within(torch, got, ref, atol: float, rtol: float):
    """(max_abs_err, ok) for |got - ref| <= atol + rtol * |ref|."""
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - r).abs()
    return float(diff.max()), bool((diff <= atol + rtol * r.abs()).all())


# ------------------------------------------------------------------ phases


def ptxas_report(log: str):
    """[(kernel, registers, spilled bytes stored + loaded)] for each entry
    function in nvcc's ``-Xptxas -v`` output; a kernel template
    ``name<T, N, ...>`` of integer or bool arguments reads as
    ``name<bf16|f32, N, ...>``."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)"
                          r"((?:L[ib]\d+E)*)E", m.group(1))
            name = (f"{t[1]}<" + ", ".join(
                ["f32" if t[2] == "f" else "bf16"]
                + re.findall(r"L[ib](\d+)E", t[3])) + ">"
                    if t else m.group(1))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m[1]), spill))
            name = None
    return out


def phase_build(report):
    from ray_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    for name, log in _build.build_logs.items():
        kernels = ptxas_report(log)
        report["ptxas"][name] = kernels
        print(f"[build] {name}.cu ptxas: " + "; ".join(
            f"{k} {regs} registers, {spill} B spilled"
            for k, regs, spill in kernels))
    print(f"[build] kernels built in {report['build_s']:.1f} s")
    # The wgmma kernels of K2 and K3 (bf16, head_dim 64 and 128).
    spills = [(k, spill) for k, _, spill in report["ptxas"]["flash_bwd"]
              if k.startswith(("flash_bwd_dq_kernel<bf16",
                               "flash_bwd_dkv_kernel<bf16"))]
    check(len(spills) == 4 and not any(sp for _, sp in spills),
          f"the bf16 K2/K3 kernels spill (or were not found): {spills}")
    # K4 holds rows in registers: a spill would put them in local memory.
    k4 = report["ptxas"]["rms_norm"]
    check(len(k4) > 0 and not any(sp for _, _, sp in k4),
          f"a K4 kernel spills (or none was found): {k4}")


def phase_rms(torch, report):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import norms

    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(11)
    tol = {torch.bfloat16: (1e-6, 2.0 ** -7), torch.float32: (1e-6, 1e-5)}
    cases = [(512, 4096, torch.bfloat16), (8, 4096, torch.bfloat16),
             (1000, 4096, torch.bfloat16), (512, 4096, torch.float32),
             (37, 4100, torch.bfloat16), (2048, 4096, torch.bfloat16),
             (99, 128, torch.bfloat16), (99, 128, torch.float32)]
    rows_out = []
    timed = {}
    for rows, d, dt in cases:
        x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        out = norms.rms_norm_cuda(x, w, eps)
        ref = norms._rms_ref(x, w, eps)
        atol, rtol = tol[dt]
        err, ok = within(torch, out, ref, atol, rtol)
        check(ok, f"K4 [{rows}, {d}] {dt}: max err {err} beyond atol "
                  f"{atol} + rtol {rtol}")
        rec = {"shape": [rows, d], "dtype": str(dt), "max_abs_err": err,
               "atol": atol, "rtol": rtol}
        if dt == torch.bfloat16 and d == 4096:
            nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
            flops = 4 * rows * d
            kern = lambda: norms.rms_norm_cuda(x, w, eps)  # noqa: E731
            plain = lambda: norms._rms_ref(x, w, eps)  # noqa: E731
            lib = lambda: F.rms_norm(x, (d,), w, eps)  # noqa: E731
            rec.update(
                call_ms=time_ms(torch, kern),
                plain_call_ms=time_ms(torch, plain),
                library_call_ms=time_ms(torch, lib),
                ms=device_ms(torch, kern),
                plain_ms=device_ms(torch, plain),
                library_ms=device_ms(torch, lib),
                **_bound(nbytes, flops))
            timed[rows] = rec
        rows_out.append(rec)
        print("[K4] " + json.dumps(rec))
    bwd = _phase_rms_bwd(torch, norms, F, g, eps)
    report["rms_norm"] = {"cases": rows_out, "main": timed[512],
                          "train_shape": timed[2048], "bwd": bwd}


def _bound(nbytes: float, flops: float):
    """The least time of a function that moves ``nbytes`` and does
    ``flops`` fp32 operations on the card."""
    by_bytes, by_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "mbytes": nbytes / 1e6}


def _phase_rms_bwd(torch, norms, F, g, eps):
    """K4's backward against ``_rms_bwd_ref`` on the same inputs, dw
    bit-identical over two calls, then timed at the training shape
    [2048, 4096] bf16 beside the plain version and ``F.rms_norm``'s
    autograd backward.

    Tolerance: both compute in fp32 and round once; they differ in the
    order of the row sums (sum x^2 and sum g*x, relative error ~1e-7 on
    the card) and of dw's sum over rows, so per element
    |got - ref| <= rtol |ref| + 1e-5 * m + 1e-6, where m is the size of
    what was summed: |r g| + |x| r^3 mean(|g x|) for dx and
    sum_rows |dy x r| for dw.  rtol is one bf16 ulp (2^-7: both sides
    may round to neighbours) or 1e-5 in fp32."""
    rtol = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
    cases = [(2048, 4096, torch.bfloat16, True),
             (2048, 4096, torch.bfloat16, False),  # w frozen: no dw
             (512, 4096, torch.float32, True), (8, 4096, torch.bfloat16, True),
             (1000, 4096, torch.bfloat16, True),
             (37, 4100, torch.bfloat16, True), (37, 4100, torch.float32, True),
             (99, 128, torch.bfloat16, True), (99, 128, torch.float32, True)]
    out = []
    main = None
    for rows, d, dt, need_dw in cases:
        x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        dy = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        dx, dw = norms.rms_norm_bwd(x, w, dy, eps, need_dw=need_dw)
        torch.cuda.synchronize()
        rdx, rdw = norms._rms_bwd_ref(x, w, dy, eps)
        xf, dyf = x.float(), dy.float()
        gf = dyf * w.float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        m_dx = (r * gf).abs() + xf.abs() * r ** 3 * (gf * xf).abs().mean(
            -1, keepdim=True)
        m_dw = (dyf * xf * r).abs().sum(0)
        name = f"K4 backward [{rows}, {d}] {dt}" + ("" if need_dw
                                                    else " (w frozen)")
        rec = {"shape": [rows, d], "dtype": str(dt), "dw": need_dw,
               "rtol": rtol[dt]}
        for what, got, ref, m in (("dx", dx, rdx, m_dx), ("dw", dw, rdw, m_dw)):
            if what == "dw" and not need_dw:
                check(dw is None, f"{name}: dw computed though not asked")
                continue
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name}: {what} is not finite")
            diff = (got.float() - ref.float()).abs()
            lim = rtol[dt] * ref.float().abs() + 1e-5 * m + 1e-6
            rec[f"{what}_max_abs_err"] = float(diff.max())
            rec[f"{what}_worst_share_of_tol"] = float((diff / lim).max())
            check(bool((diff <= lim).all()),
                  f"{name}: {what} max err {float(diff.max())}, "
                  f"{float((diff / lim).max()):.3g} of its tolerance")
        rec["max_abs_err"] = max(rec["dx_max_abs_err"],
                                 rec.get("dw_max_abs_err", 0.0))
        if need_dw:
            dx2, dw2 = norms.rms_norm_bwd(x, w, dy, eps)
            check(torch.equal(dw, dw2) and torch.equal(dx, dx2),
                  f"{name}: two calls differ (dw must be bit-identical)")
            rec["bit_identical"] = True
            aligned = int(d % (16 // x.element_size()) == 0)
            rec["partial_rows"] = norms._kernels()[2](
                norms._DTYPES[dt], rows, d, aligned)
        if (rows, d, dt, need_dw) == (2048, 4096, torch.bfloat16, True):
            rec.update(_time_rms_bwd(torch, norms, F, x, w, dy, eps))
            main = rec
        out.append(rec)
        print("[K4 bwd] " + json.dumps(rec))
    return {"cases": out, "main": main}


def _time_rms_bwd(torch, norms, F, x, w, dy, eps):
    rows, d = x.shape
    kern = lambda: norms.rms_norm_bwd(x, w, dy, eps)  # noqa: E731
    plain = lambda: norms._rms_bwd_ref(x, w, dy, eps)  # noqa: E731
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))

    def lib_fwd():
        return F.rms_norm(xr, (d,), wr, eps)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (xr, wr), dy)

    def k4_fwd_bwd():
        torch.autograd.grad(norms.rms_norm(xr, wr, eps), (xr, wr), dy)

    library_ms, library_timing = backward_ms(torch, lib_fwd_bwd, lib_fwd)
    by_name, _ = profile_window(torch, kern)
    # Bytes: x and dy read, dx written ([rows, d] each), w read and dw
    # written; about 12 flops an element (two sums, dx, dw).
    nbytes = 3 * rows * d * x.element_size() + 2 * d * w.element_size()
    return {
        "call_ms": time_ms(torch, kern), "ms": device_ms(torch, kern),
        # The row kernel (dx and the partial dw rows) and the dw sum.
        "row_kernel_ms": sum(t for n, t in by_name.items()
                             if "rms_norm_bwd_kernel" in n),
        "dw_kernel_ms": sum(t for n, t in by_name.items()
                            if "rms_norm_dw_kernel" in n),
        "plain_call_ms": time_ms(torch, plain),
        "plain_ms": device_ms(torch, plain, iters=3),
        # F.rms_norm's backward: its forward and backward under autograd
        # less its forward.
        "library_ms": library_ms, "library_timing": library_timing,
        "library_fwd_bwd_ms": device_ms(torch, lib_fwd_bwd),
        "k4_fwd_bwd_ms": device_ms(torch, k4_fwd_bwd),
        **_bound(nbytes, 12 * rows * d)}


def _attn_inputs(torch, g, B, H, Hkv, Sq, Sk, D, dt):
    q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dt)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dt)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dt)
    return q, k, v


def _flash_cases(torch):
    """K1's case grid: the main-path shapes; the first port's grid (both
    dtypes, GQA groups, head dims, offsets, ragged lengths); head_dim 32
    in both dtypes; the bf16 wgmma kernel's block edges (128-row blocks
    made of two 64-row visiting tiles, 64-key tiles); and q/k/v as
    transposed [B, S, H, D] views, as the model passes them."""
    cases = [dict(B=1, H=32, Hkv=8, Sq=s, Sk=s, D=128, causal=True, off=0,
                  dt=torch.bfloat16) for s in (512, 2048)]
    for dt in (torch.bfloat16, torch.float32):
        for H, Hkv in ((4, 4), (8, 2)):
            for D in (64, 128):
                for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0, dt=dt))
                    for off in (-64, 0, 256, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off, dt=dt))
    # head_dim 32 (the tiny model's), both dtypes.
    for dt in (torch.float32, torch.bfloat16):
        for H, Hkv in ((4, 4), (8, 2)):
            for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                  causal=False, off=0, dt=dt))
                for off in (-64, 0, 256, Sk + 64):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                      causal=True, off=off, dt=dt))
    for H, Hkv in ((4, 4), (8, 2), (32, 8)):
        for D in (64, 128):
            for Sq in (1, 65, 127, 129, 200):
                for Sk in (1, 64, 65, 129, 300):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0,
                                      dt=torch.bfloat16))
                    for off in (-65, -64, -63, 0, 1, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off,
                                          dt=torch.bfloat16))
    for D in (64, 128):
        for S, off in ((200, 0), (1000, 0), (1000, -63)):
            cases.append(dict(B=2, H=32, Hkv=8, Sq=S, Sk=S, D=D, causal=True,
                              off=off, dt=torch.bfloat16, bshd=True))
    # The cached-prefix prefill: a suffix bucket at q_offset = prefix_len
    # (mid-page too) over the whole gathered table (Sk = MAXP x 16), the
    # bucket running past the table's end, with q as the model's
    # [S, H, D] view.
    for Sq, off in ((64, 384), (16, 17), (512, 200), (128, 463), (32, 560)):
        for bshd in (False, True):
            cases.append(dict(B=1, H=32, Hkv=8, Sq=Sq, Sk=576, D=128,
                              causal=True, off=off, dt=torch.bfloat16,
                              bshd=bshd))
    for Sq, off in ((16, 48), (64, 20), (128, 100)):
        cases.append(dict(B=1, H=4, Hkv=2, Sq=Sq, Sk=144, D=32, causal=True,
                          off=off, dt=torch.float32))
    # b1's paged prefill (``llm_app(model="b1")``, the serve-front phase):
    # 16 heads in groups of 1, head_dim 128, bf16, each prefill bucket up
    # to 512, as the model's [S, H, D] views.
    for S in (16, 32, 64, 128, 256, 512):
        cases.append(dict(B=1, H=16, Hkv=16, Sq=S, Sk=S, D=128, causal=True,
                          off=0, dt=torch.bfloat16, bshd=True))
    return cases


def _case_inputs(torch, g, c):
    if not c.get("bshd"):
        return _attn_inputs(torch, g, c["B"], c["H"], c["Hkv"], c["Sq"],
                            c["Sk"], c["D"], c["dt"])
    q, k, v = _attn_inputs(torch, g, c["B"], c["Sq"], c["Sk"], c["H"],
                           c["Hkv"], c["D"], c["dt"])
    # [B, S, H, D] storage viewed as [B, H, S, D]: seq stride H * D.
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def phase_flash(torch, report):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(12)
    # Per element, |out - ref| <= a * spread + atol + rtol * |ref|, where
    # spread = sum_j p_j |v_j| / l (the same attention over |v|, fp32).
    # bf16: the kernel rounds p to bf16 (unit roundoff U = 2^-8) before the
    # p.v product, which moves an output element by at most U * spread, and
    # both sides round the output to bf16 (at most 2U |ref| apart).  fp32:
    # exact products, sums in another order than the reference.  "fro"
    # bounds ||out - ref|| / ||ref|| over the whole output; "lse" is
    # (atol, rtol).  On rows whose largest score is NEG_INF (every visited
    # key masked) or that visit no key tile, lse must equal the plain
    # version's bit for bit: K2/K3 take p = exp(s - lse) there, and one ulp
    # at -1e30 (7.6e22) overflows p.
    U = 2.0 ** -8
    tol = {torch.bfloat16: {"out": (U, 1e-5, 2 * U), "fro": 2 * U,
                            "lse": (1e-3, 1e-5)},
           torch.float32: {"out": (0.0, 1e-4, 1e-4), "fro": 1e-5,
                           "lse": (1e-4, 1e-5)}}
    cases = _flash_cases(torch)
    worst = {}
    masked_rows = 0
    for c in cases:
        q, k, v = _case_inputs(torch, g, c)
        out, lse = att.flash_attention_fwd(q, k, v, causal=c["causal"],
                                           q_offset=c["off"])
        ref_out, ref_lse = att.flash_attention_ref(
            q, k, v, causal=c["causal"], q_offset=c["off"])
        t = tol[c["dt"]]
        a, atol, rtol = t["out"]
        if a:
            spread = att.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal=c["causal"],
                q_offset=c["off"])[0]
            atol = a * spread + atol
        e_out, ok_out = within(torch, out, ref_out, atol, rtol)
        e_lse, ok_lse = within(torch, lse, ref_lse, *t["lse"])
        trap = ref_lse <= att.NEG_INF / 2
        masked_rows += int(trap.sum())
        lse_bits = bool(torch.equal(lse[trap], ref_lse[trap]))
        d_norm = float((out.float() - ref_out.float()).norm())
        r_norm = float(ref_out.float().norm())
        fro = d_norm / r_norm if r_norm > 0 else d_norm
        tag = (f"B{c['B']} H{c['H']}/{c['Hkv']} Sq{c['Sq']} Sk{c['Sk']} "
               f"D{c['D']} causal={c['causal']} off={c['off']} {c['dt']}"
               + (" [B,S,H,D] view" if c.get("bshd") else ""))
        check(ok_out and ok_lse and fro <= t["fro"] and lse_bits,
              f"K1 {tag}: out err {e_out} (tol {t['out']}), relative "
              f"norm err {fro} (tol {t['fro']}), lse err {e_lse} (tol "
              f"{t['lse']}), lse bit-equal on NEG_INF rows {lse_bits}")
        w = worst.setdefault(str(c["dt"]), {"out": 0.0, "fro": 0.0})
        w["out"], w["fro"] = max(w["out"], e_out), max(w["fro"], fro)
    check(masked_rows > 0, "no case had a row that sees no key")
    tol_s = json.dumps({str(k): v for k, v in tol.items()})
    print(f"[K1] {len(cases)} cases within tolerance; worst out err and "
          f"relative norm err by dtype {json.dumps(worst)}; lse bit-equal "
          f"to the plain version's on all {masked_rows} rows whose "
          f"largest score is NEG_INF or that visit no tile; tolerances "
          f"{tol_s}")

    timed = []
    for S in (512, 2048):
        B, H, Hkv, D = 1, 32, 8, 128
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, S, S, D, torch.bfloat16)
        out, lse = att.flash_attention_fwd(q, k, v, causal=True)
        ref_out, ref_lse = att.flash_attention_ref(q, k, v, causal=True)
        err = float((out.float() - ref_out.float()).abs().max())
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
        lib = lib_fn()
        kern = lambda: att.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=True)
        plain = lambda: att.flash_attention_ref(  # noqa: E731
            q, k, v, causal=True)
        pairs = S * (S + 1) // 2  # causal (q, k) pairs per head
        flops = 4 * B * H * D * pairs
        nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * 2 + B * H * S * 4
        rec = {
            "shape": dict(B=B, H=H, Hkv=Hkv, S=S, D=D, causal=True,
                          dtype="bfloat16"),
            "max_abs_err": err,
            "sdpa_max_abs_diff": float((lib.float() - ref_out.float())
                                       .abs().max()),
            "call_ms": time_ms(torch, kern),
            "plain_call_ms": time_ms(torch, plain, iters=5),
            "library_call_ms": time_ms(torch, lib_fn),
            "ms": device_ms(torch, kern),
            "plain_ms": device_ms(torch, plain, iters=3),
            "library_ms": device_ms(torch, lib_fn),
            "bound_ms": max(flops / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                         >= nbytes / PEAK_HBM_BYTES else "bytes"),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        timed.append(rec)
        print("[K1] " + json.dumps(rec))
    report["flash_fwd"] = {"cases": len(cases), "worst_out_err": worst,
                           "neg_inf_rows_bit_equal": masked_rows,
                           "timed": timed, "main": timed[-1]}


def _bwd_case(torch, att, g, c):
    """Inputs of one backward case: q, k, v, dO in the case's dtype, the
    plain forward's lse and delta = rowsum(dO * O)."""
    q, k, v = _attn_inputs(torch, g, c["B"], c["H"], c["Hkv"], c["Sq"],
                           c["Sk"], c["D"], c["dt"])
    do = torch.randn(q.shape, generator=g, device="cuda").to(c["dt"])
    out, lse = att.flash_attention_ref(q, k, v, causal=c["causal"],
                                       q_offset=c["off"])
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse, delta):
    """K2 and K3 on one case against ``flash_attention_bwd_ref`` on the
    same inputs; raises beyond the tolerance, updates ``worst``."""
    kw = dict(causal=c["causal"], q_offset=c["off"])
    dq = att.flash_attention_bwd_dq(q, k, v, lse, delta, do, **kw)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
    refs = att.flash_attention_bwd_ref(q, k, v, lse, delta, do, **kw)
    t = tol[c["dt"]]
    a, atol, rtol = t["elem"]
    if a:
        p, ds = att._bwd_probs(q, k, v, lse, delta, do, sm_scale=None,
                               **kw)
        ads, Hkv = ds.abs(), c["Hkv"]
        spreads = (
            torch.einsum("bhqk,bhkd->bhqd", ads,
                         att._repeat_kv(k, c["H"]).float().abs()),
            att._sum_groups(torch.einsum(
                "bhqk,bhqd->bhkd", ads, q.float().abs()), Hkv),
            att._sum_groups(torch.einsum(
                "bhqk,bhqd->bhkd", p, do.float().abs()), Hkv))
        del p, ds, ads
    else:
        spreads = (0.0, 0.0, 0.0)
    tag = (f"B{c['B']} H{c['H']}/{c['Hkv']} Sq{c['Sq']} Sk{c['Sk']} "
           f"D{c['D']} causal={c['causal']} off={c['off']} {c['dt']}"
           + (" fed by K1" if c.get("fed_by_k1") else ""))
    w = worst.setdefault(str(c["dt"]), {})
    for name, got, ref, spread in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      refs, spreads):
        err, ok = within(torch, got, ref, a * spread + atol, rtol)
        d_norm = float((got.float() - ref.float()).norm())
        r_norm = float(ref.float().norm())
        fro = d_norm / r_norm if r_norm > 0 else d_norm
        check(ok and fro <= t["fro"],
              f"K2/K3 {name} {tag}: max err {err} (tol {t['elem']}), "
              f"relative norm err {fro} (tol {t['fro']})")
        e = w.setdefault(name, {"err": 0.0, "fro": 0.0})
        e["err"], e["fro"] = max(e["err"], err), max(e["fro"], fro)


def phase_flash_bwd(torch, report):
    """K2 and K3 against ``flash_attention_bwd_ref`` over K1's case grid
    (and 32/8 heads), then timed at the training shape."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(14)
    # Per element, |got - ref| <= a * spread + atol + rtol * |ref|.  bf16:
    # the kernels round p (for dV) and ds (for dQ, dK) to bf16 (unit
    # roundoff U = 2^-8) before their products, which moves an element by
    # at most U times the same product over absolute values (spread: |ds|
    # . |k| for dQ, |ds|^T . |q| for dK, p^T . |dO| for dV, summed over the
    # GQA group, fp32), and both sides round the output to bf16 (at most
    # 2U |ref| apart).  fp32: exact products, sums in another order than
    # the reference.  "fro" bounds ||got - ref|| / ||ref|| per gradient.
    U = 2.0 ** -8
    tol = {torch.bfloat16: {"elem": (U, 1e-5, 2 * U), "fro": 2 * U},
           torch.float32: {"elem": (0.0, 1e-4, 1e-4), "fro": 1e-5}}
    cases = [dict(B=1, H=32, Hkv=8, Sq=s, Sk=s, D=128, causal=True, off=0,
                  dt=torch.bfloat16) for s in (512, 2048)]
    for dt in (torch.bfloat16, torch.float32):
        for H, Hkv in ((4, 4), (8, 2), (32, 8)):
            for D in (64, 128):
                for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D,
                                      causal=False, off=0, dt=dt))
                    for off in (-64, 0, 256, Sk + 64):
                        cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk,
                                          D=D, causal=True, off=off, dt=dt))
    # head_dim 32 (the tiny model's), both dtypes.
    for dt in (torch.float32, torch.bfloat16):
        for H, Hkv in ((4, 4), (8, 2), (32, 8)):
            for Sq, Sk in ((1000, 1000), (256, 1000), (64, 512)):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                  causal=False, off=0, dt=dt))
                for off in (-64, 0, 256, Sk + 64):
                    cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=32,
                                      causal=True, off=off, dt=dt))
    # Sq > Sk: K3's ragged q tail, and many more (q head, q tile)
    # iterations than the ring has stages.
    for H, Hkv in ((8, 2), (32, 8)):
        for D in (64, 128):
            for off in (0, -64):
                cases.append(dict(B=2, H=H, Hkv=Hkv, Sq=1000, Sk=256, D=D,
                                  causal=True, off=off, dt=torch.bfloat16))
    worst = {}
    for c in cases:
        q, k, v, do, lse, delta = _bwd_case(torch, att, g, c)
        _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse, delta)
    # K1 feeding K2/K3 as in training: K1's own out and lse, delta from
    # K1's out, dO zero on rows that see no key.  off -64: the first
    # 64-row tile visits nothing; off -63: its rows but the last see no key
    # inside a visited tile, so lse = NEG_INF there must be exact or p
    # overflows.
    chained = 0
    for off in (-64, -63):
        for H, Hkv in ((8, 2), (32, 8)):
            for D in (64, 128):
                c = dict(B=2, H=H, Hkv=Hkv, Sq=300, Sk=300, D=D, causal=True,
                         off=off, dt=torch.bfloat16, fed_by_k1=True)
                q, k, v = _attn_inputs(torch, g, 2, H, Hkv, 300, 300, D,
                                       c["dt"])
                out, lse = att.flash_attention_fwd(q, k, v, causal=True,
                                                   q_offset=off)
                sees = torch.arange(300, device="cuda") + off >= 0
                do = (torch.randn(q.shape, generator=g, device="cuda")
                      * sees[:, None]).to(c["dt"])
                delta = (do.float() * out.float()).sum(-1)
                _check_bwd(torch, att, c, tol, worst, q, k, v, do, lse,
                           delta)
                chained += 1
    tol_s = json.dumps({str(k): v for k, v in tol.items()})
    print(f"[K2/K3] {len(cases)} cases and {chained} fed by K1 within "
          f"tolerance; worst element err "
          f"and relative norm err by dtype {json.dumps(worst)}; tolerances "
          f"{tol_s}")

    # The training shape: B=1, H=32, Hkv=8, D=128, causal, bf16, at S =
    # 2048 (the main path's) and 512.
    timed = {}
    for S in (512, 2048):
        timed[S] = _time_bwd(torch, att, F, g, S)
    main = timed[2048]
    report["flash_bwd"] = {"cases": len(cases), "fed_by_k1": chained,
                           "worst": worst, "main": main,
                           "s512": timed[512]}


def _time_bwd(torch, att, F, g, S):
    """K2 and K3 at [1, 32, S, 128], Hkv 8, causal, bf16: error against the
    plain version, device and per-call time, the plain version's and SDPA's
    backward's time, the bound, and the SM clock before and after each
    kernel's timed loops."""
    B, H, Hkv, D = 1, 32, 8, 128
    c = dict(B=B, H=H, Hkv=Hkv, Sq=S, Sk=S, D=D, causal=True, off=0,
             dt=torch.bfloat16)
    q, k, v, do, lse, delta = _bwd_case(torch, att, g, c)
    ref = att.flash_attention_bwd_ref(q, k, v, lse, delta, do)
    dq = att.flash_attention_bwd_dq(q, k, v, lse, delta, do)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    errs = [float((x.float() - r.float()).abs().max())
            for x, r in zip((dq, dk, dv), ref)]
    del ref
    # Library yardstick for the pair: the device time of SDPA's backward,
    # i.e. one forward and backward less the forward alone.
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_route = "enable_gqa"

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=kr.shape[1] != H)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

    try:
        sdpa_fwd_bwd()
    except RuntimeError as e:
        print(f"[K2/K3] SDPA backward refused GQA ({e}); K/V repeated to "
              f"{H} heads")
        lib_route = "K/V repeated to H heads"
        kr, vr = (att._repeat_kv(t, H).detach().requires_grad_(True)
                  for t in (k, v))
    library_ms, library_timing = backward_ms(torch, sdpa_fwd_bwd, sdpa_fwd)
    library_call_ms = time_ms(torch, sdpa_fwd_bwd)
    plain = lambda: att.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, lse, delta, do)
    plain_ms = device_ms(torch, plain, iters=3)
    plain_call_ms = time_ms(torch, plain, iters=5)
    pairs = S * (S + 1) // 2  # causal (q, key) pairs per head
    lse_bytes = 2 * B * H * S * 4  # lse and delta
    work = {
        "flash_bwd_dq": (6 * B * H * D * pairs,
                         (3 * B * H * S * D + 2 * B * Hkv * S * D) * 2
                         + lse_bytes,
                         lambda: att.flash_attention_bwd_dq(
                             q, k, v, lse, delta, do), errs[0]),
        "flash_bwd_dkv": (8 * B * H * D * pairs,
                          (2 * B * H * S * D + 4 * B * Hkv * S * D) * 2
                          + lse_bytes,
                          lambda: att.flash_attention_bwd_dkv(
                              q, k, v, lse, delta, do), max(errs[1:])),
    }
    out = {}
    for name, (flops, nbytes, kern, err) in work.items():
        clocks_before = clocks_line()
        call_ms = time_ms(torch, kern)
        ms = device_ms(torch, kern)
        clocks_after = clocks_line()
        rec = {
            "shape": dict(B=B, H=H, Hkv=Hkv, S=S, D=D, causal=True,
                          dtype="bfloat16"),
            "max_abs_err": err,
            "call_ms": call_ms, "ms": ms,
            # SM clock, max SM clock (nvidia-smi) around the timed loops.
            "clocks_before": clocks_before, "clocks_after": clocks_after,
            # The plain version and the library call compute K2 and K3
            # together: their times are the pair's.
            "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "library_route": lib_route, "library_timing": library_timing,
            "bound_ms": max(flops / PEAK_BF16_FLOPS,
                            nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                         >= nbytes / PEAK_HBM_BYTES else "bytes"),
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        out[name] = rec
        print(f"[{name}] S={S} " + json.dumps(rec))
    return out


def _counters():
    """{kernel name: its wrapper, which carries the launch count}."""
    from ray_tpu_torch.ops import attention, norms

    return {"flash_fwd": attention.flash_attention_fwd,
            "flash_bwd_dq": attention.flash_attention_bwd_dq,
            "flash_bwd_dkv": attention.flash_attention_bwd_dkv,
            "rms_norm": norms.rms_norm_cuda,
            "rms_norm_bwd": norms.rms_norm_bwd}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def phase_tiny_serve(torch, report, seed: int):
    """The tiny model (d_model 128, 4 heads: head_dim 32, as ``llm_app``'s
    default model) served on the card: 6 requests through an
    ``InferenceEngine``, greedy, and K1 and K4 must have launched.  In
    fp32 the tokens must equal those of the same engine built on the CPU
    from the same parameters (plain versions of the kernels there).  In
    bf16, the model's default dtype, the prefill forward's logits of the
    same prompts are held against the fp32 forward of the same parameters
    on the CPU, under the forward phase's rule."""
    from ray_tpu_torch.models.llama import (Llama, LlamaConfig, llama_apply,
                                            llama_init)
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(batch_slots=4, page_size=16, max_prompt_len=128,
                        max_new_tokens_cap=32, prefix_cache=False)
    rng = np.random.default_rng(seed + 4)
    lengths = (5, 40, 77, 128, 17, 64)
    new = 16

    def serve(cfg, p, device, prompts):
        engine = InferenceEngine(cfg, p, ecfg, seed=seed, device=device)
        try:
            streams = [engine.submit(t, max_new_tokens=new) for t in prompts]
            return [list(st) for st in streams], engine.stats()
        finally:
            engine.shutdown()

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = LlamaConfig.tiny(dtype=dt)
        name = str(dt).split(".")[-1]
        params = llama_init(cfg, torch.Generator(device="cuda")
                            .manual_seed(seed + 4))
        cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
        cpu_params = Llama(cpu_cfg, torch.device("cpu"))
        cpu_params.load_state_dict(params.state_dict())
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lengths]
        _reset_counts()
        got, stats = serve(cfg, params, None, prompts)
        torch.cuda.synchronize()
        counts = _read_counts()
        check(all(len(t) == new for t in got),
              f"tiny serve ({name}) lost tokens")
        check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0
              and counts["rms_norm_bwd"] == 0,
              f"tiny serve ({name}) did not launch K1 and K4's forward "
              f"(and K4's backward never): {counts}")
        rec = {"head_dim": cfg.head_dim, "requests": len(prompts),
               "launches": counts}
        if dt == torch.float32:
            want, _ = serve(cpu_cfg, cpu_params, "cpu", prompts)
            same = sum(int(a == b) for g, w in zip(got, want)
                       for a, b in zip(g, w))
            msg = (f"{same}/{len(prompts) * new} equal to the CPU "
                   f"engine's")
            check(got == want, f"tiny serve on the card differs from the "
                               f"CPU: {got} vs {want}")
            rec["tokens_equal"] = same
        else:
            # The prompts' prefill forward on the card (K1 at head_dim 32
            # in bf16, K4) against fp32 on the CPU, as the forward phase.
            with torch.no_grad():
                logits = torch.cat([llama_apply(
                    cfg, params, torch.from_numpy(t).long()[None].cuda())[0]
                    .float().cpu() for t in prompts])
                ref = torch.cat([llama_apply(
                    cpu_cfg, cpu_params, torch.from_numpy(t).long()[None])[0]
                    for t in prompts])
            rel = float((logits - ref).norm() / ref.norm())
            top1 = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
            rel_tol, top1_min = 5e-2, 0.75
            msg = (f"prefill logits vs fp32 CPU: rel err {rel:.4g} (tol "
                   f"{rel_tol}), top-1 agreement {top1:.4f} (min "
                   f"{top1_min})")
            check(rel <= rel_tol and top1 >= top1_min,
                  f"tiny bf16 prefill disagrees with the fp32 CPU "
                  f"forward: rel {rel}, top-1 {top1}")
            rec.update(rel_err=rel, top1=top1, rel_tol=rel_tol,
                       top1_min=top1_min)
        print(f"[tiny-serve] tiny model {name} (head_dim {cfg.head_dim}) on "
              f"the card: {len(prompts)} requests x {new} greedy tokens, "
              f"{msg}; {stats['decode_traces']} decode / "
              f"{stats['prefill_traces']} prefill traces; launches {counts}")
        out[name] = rec
    report["tiny_serve"] = out
    # The launch counts of the serving path are the two runs' together.
    report["tiny_serve"]["launches"] = {
        k: sum(r["launches"][k] for r in out.values())
        for k in out["float32"]["launches"]}


def phase_forward(torch, report, seed: int):
    with torch.no_grad():  # serving: no autograd, K4 on every norm
        return _forward(torch, report, seed)


def _forward(torch, report, seed: int):
    from ray_tpu_torch.models.llama import (Llama, LlamaConfig, llama_apply,
                                            llama_init)

    cfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = llama_init(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    logits = llama_apply(cfg, params, tokens)  # warm (cuBLAS heuristics)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    logits = llama_apply(cfg, params, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    kernels, prof_wall_ms = profile_window(
        torch, lambda: llama_apply(cfg, params, tokens), iters=2)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[forward] profiled window: device busy {busy_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall per call (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}); top kernels (ms per call): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    check(tuple(logits.shape) == (1, 2048, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    print(f"[forward] Llama-3-8B {n_params / 1e9:.2f}B params "
          f"({cfg.n_layers} layers, bf16) init {init_s:.1f} s; llama_apply "
          f"B=1 S=2048 wall {wall * 1e3:.1f} ms; launches {counts}")
    check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0
          and counts["rms_norm_bwd"] == 0,
          f"forward path did not launch K1 and K4's forward (and K4's "
          f"backward never): {counts}")
    del logits

    # Two layers at full width against the same weights in fp32 on the CPU
    # through the plain path (the kernels' plain versions).
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = llama_init(cfg2, torch.Generator(device="cuda")
                         .manual_seed(seed + 1))
    tok2 = tokens[:, :512]
    got = llama_apply(cfg2, params2, tok2).cpu()
    cpu = Llama(dataclasses.replace(cfg2, dtype=torch.float32),
                torch.device("cpu"))
    cpu.load_state_dict(params2.state_dict())
    del params2
    t0 = time.perf_counter()
    ref = llama_apply(cpu.config, cpu, tok2.cpu())
    cpu_s = time.perf_counter() - t0
    rel = float((got - ref).norm() / ref.norm())
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # bf16 weights/activations vs fp32: ~1% relative logit error; top-1
    # flips only where the fp32 top-2 margin is inside that error.
    rel_tol, top1_min = 5e-2, 0.75
    print(f"[forward] 2-layer full-width S=512 vs fp32 CPU plain path "
          f"({cpu_s:.1f} s): rel err {rel:.4g} (tol {rel_tol}), top-1 "
          f"agreement {top1:.4f} (min {top1_min})")
    check(rel <= rel_tol and top1 >= top1_min,
          f"forward disagrees with the fp32 CPU reference: rel {rel}, "
          f"top-1 {top1}")
    del cpu
    report["forward"] = {"params_b": n_params / 1e9, "init_s": init_s,
                         "wall_ms": wall * 1e3, "launches": counts,
                         "profiled_wall_ms": prof_wall_ms,
                         "device_busy_ms": busy_ms,
                         "top_kernels_ms": dict(top),
                         "rel_err_2layer": rel, "top1_2layer": top1,
                         "rel_tol": rel_tol, "top1_min": top1_min}
    return cfg, params


def _serve_mix_prompts(cfg, seed: int):
    """The serving cell's mix (``PERF.md`` section 4): 8 prompts of 16-512
    tokens, then 4 more that arrive while those decode; as (prompts,
    temperatures, how many come first)."""
    rng = np.random.default_rng(seed)
    first = [(16, 0.0), (40, 0.8), (77, 0.0), (128, 0.8), (200, 0.0),
             (256, 0.0), (380, 0.8), (512, 0.0)]
    late = [(24, 0.8), (96, 0.0), (300, 0.8), (512, 0.0)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in first + late]
    return prompts, [t for _, t in first + late], len(first)


def _serve_mix(engine, prompts, temps, n_first: int, new: int):
    """Submit the first ``n_first`` requests, then the rest once those all
    decode, each consumed on its own thread; every stream must finish with
    ``new`` tokens in the vocabulary.  Returns ([(tokens, ttft_s, stream,
    gaps_s)] in submit order, where ``gaps_s`` are the seconds between
    consecutive tokens as the consumer took them, wall seconds, active
    slots when the late requests arrived)."""
    vocab = engine.model_config.vocab_size
    results = [None] * len(prompts)
    errors = []
    started = threading.Event()

    def consume(i, stream):
        try:
            toks, times = [], []
            for tok in stream:
                times.append(time.perf_counter())
                toks.append(tok)
                started.set()
            results[i] = (toks, stream.ttft_s, stream,
                          np.diff(times).tolist())
        except Exception as e:  # noqa: BLE001: reported below
            errors.append((i, repr(e)))
            started.set()

    t0 = time.perf_counter()
    threads = []

    def submit(i):
        s = engine.submit(prompts[i], max_new_tokens=new,
                          temperature=temps[i])
        threads.append(threading.Thread(target=consume, args=(i, s)))
        threads[-1].start()

    for i in range(n_first):
        submit(i)
    check(started.wait(600), "no token within 600 s")
    deadline = time.time() + 600
    while (engine.stats()["active_seqs"] < n_first and not errors
           and time.time() < deadline):
        time.sleep(0.005)
    active_at_late = engine.stats()["active_seqs"]
    for i in range(n_first, len(prompts)):
        submit(i)
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "a stream did not finish in 600 s")
    wall = time.perf_counter() - t0
    check(not errors, f"stream errors: {errors}")
    for i, (toks, *_) in enumerate(results):
        check(len(toks) == new, f"request {i}: {len(toks)} tokens, "
                                f"expected {new}")
        check(all(0 <= t < vocab for t in toks),
              f"request {i}: token out of range")
    return results, wall, active_at_late


def phase_serve(torch, report, cfg, params, seed: int):
    from ray_tpu_torch.models.generate import generate
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(batch_slots=8, page_size=16, max_prompt_len=512,
                        max_new_tokens_cap=64, prefix_cache=False)
    engine = InferenceEngine(cfg, params, ecfg, seed=seed)
    new = 32
    check_idx = 5  # 256 tokens = a prefill bucket, greedy
    prompts, temps, n_first = _serve_mix_prompts(cfg, seed)
    try:
        _reset_counts()
        results, wall, active_at_late = _serve_mix(engine, prompts, temps,
                                                   n_first, new)
        counts = _read_counts()
        deadline = time.time() + 10
        while (engine.allocator.free_count != engine.allocator.total
               and time.time() < deadline):
            time.sleep(0.05)
        check(engine.allocator.free_count == engine.allocator.total,
              f"pages leaked: {engine.allocator.free_count} free of "
              f"{engine.allocator.total}")
        stats = engine.stats()
    finally:
        engine.shutdown()
    check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0
          and counts["rms_norm_bwd"] == 0,
          f"serve path did not launch K1 and K4's forward (and K4's "
          f"backward never): {counts}")
    ttfts = sorted(r[1] for r in results)
    total = sum(len(r[0]) for r in results)
    itls = sorted(sum(r[3]) / len(r[3]) for r in results)
    ref = generate(cfg, params, prompts[check_idx][None],
                   max_new_tokens=new)[0, -new:].cpu().tolist()
    got = results[check_idx][0]
    agree = sum(int(a == b) for a, b in zip(got, ref))
    prefix = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                  new)
    print(f"[serve] 12 requests x {new} tokens on Llama-3-8B: wall "
          f"{wall:.2f} s, {total / wall:.1f} tokens/s, TTFT p50 "
          f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} "
          f"ms, inter-token p50 {itls[len(itls) // 2] * 1e3:.1f} ms, "
          f"{stats['steps']} decode steps, active when late requests "
          f"arrived {active_at_late}; launches {counts}")
    print(f"[serve] greedy request ({len(prompts[check_idx])}-token prompt) "
          f"vs generate: first token {got[0]} vs {ref[0]}, {agree}/{new} "
          f"tokens agree, identical prefix {prefix}")
    check(got[0] == ref[0], "engine's first greedy token differs from "
                            "generate's")
    report["serve"] = {
        "wall_s": wall, "tokens": total, "tokens_per_s": total / wall,
        "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
        "ttft_max_ms": ttfts[-1] * 1e3, "steps": stats["steps"],
        # Each request's mean inter-token gap, as its consumer took the
        # tokens, p50.
        "itl_p50_ms": itls[len(itls) // 2] * 1e3,
        "launches": counts, "greedy_agree": agree,
        "greedy_prefix": prefix,
        # Each request's tokens and temperature, for the serve-front phase.
        "tokens": [r[0] for r in results], "temperatures": temps}


def phase_serve_profile(torch, report, cfg, params, seed: int):
    """A warm serving window: 8 requests x 8 tokens through a fresh engine
    of the same geometry, after a warm window and an unprofiled timed one,
    under torch.profiler: wall time, prefill time, device busy time and the
    top kernels, all of that one window."""
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(
        cfg, params, EngineConfig(batch_slots=8, page_size=16,
                                  max_prompt_len=512, max_new_tokens_cap=64,
                                  prefix_cache=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 40, 77, 128, 200, 256, 380, 512)]

    def run():
        streams = [engine.submit(p, max_new_tokens=8) for p in prompts]
        return [list(s) for s in streams]

    outs = []
    try:
        run()  # warm
        # The same window unprofiled: only to show what the profiler costs.
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        steps0, prefill0 = engine.step_count, engine.prefill_s
        kernels, wall_ms = profile_window(
            torch, lambda: outs.append(run()), iters=1)
        steps = engine.step_count - steps0
        prefill_s = engine.prefill_s - prefill0
    finally:
        engine.shutdown()
    check(all(len(t) == 8 for t in outs[0]), "profiled window lost tokens")
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[serve-profile] 8 requests x 8 tokens, profiled window: wall "
          f"{wall_ms:.1f} ms ({prefill_s * 1e3:.1f} ms in prefill, {steps} "
          f"decode steps); device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall_ms:.3f}; unprofiled, the window took "
          f"{unprofiled_ms:.1f} ms); top kernels (ms): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    report["serve_profile"] = {"wall_ms": wall_ms,
                               "unprofiled_wall_ms": unprofiled_ms,
                               "prefill_ms": prefill_s * 1e3,
                               "decode_steps": steps, "device_busy_ms": busy,
                               "idle_share": 1 - busy / wall_ms,
                               "top_kernels_ms": dict(top)}


def _trace_busy(log_dir: str):
    """(device busy ms, kernels) of the Chrome trace that
    ``profiling.device_trace`` wrote into ``log_dir``: the summed duration
    of its kernel, memcpy and memset events."""
    paths = glob.glob(f"{log_dir}/*.pt.trace.json")
    check(len(paths) == 1, f"device_trace wrote {paths} into {log_dir}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sum(e["dur"] for e in dev) / 1e3, sum(
        e.get("cat") == "kernel" for e in dev)


def _observe_mix(engine, prompts, temps, n_first, new):
    """One run of the serving mix; (tokens/s, p50 of the inter-token gaps
    in ms as the consumers took the tokens, which is one decode step's wall
    as each token saw it, admission prefills included where they fall)."""
    results, wall, _ = _serve_mix(engine, prompts, temps, n_first, new)
    itls = sorted(x for r in results for x in r[3])
    return sum(len(r[0]) for r in results) / wall, \
        itls[len(itls) // 2] * 1e3


def phase_observe(torch, report, cfg, params, seed: int):
    """Serving observability on full Llama-3-8B: a default-built engine
    (recording on, prefix cache on) serves the serving mix with the
    recompile sentinel armed, under one forced root trace; its spans, step
    records, metric deltas, device-memory pools and one device_trace
    window are held to the engine; then the recorder's cost, on and off in
    turns on the same engine."""
    from ray_tpu_torch.devtools import jitguard
    from ray_tpu_torch.models import paged
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from ray_tpu_torch.util import (devmem, metrics, profiling, steprec,
                                    trace_analysis, tracing)

    ecfg = EngineConfig(batch_slots=8, page_size=16, max_prompt_len=512,
                        max_new_tokens_cap=64)
    check(ecfg.prefix_cache and ecfg.step_record,
          "the default EngineConfig records and caches")
    new = 32
    prompts, temps, n_first = _serve_mix_prompts(cfg, seed)
    counted = ("ray_tpu_gen_tokens_total",
               "ray_tpu_gen_prefill_tokens_total",
               "ray_tpu_serve_engine_completed_total")

    def totals():
        out = {n: sum(r["value"] for r in metrics.get_counter(n)._snapshot())
               for n in counted}
        out["ttft_count"] = sum(r["count"] for r in metrics.get_histogram(
            "ray_tpu_serve_engine_ttft_seconds")._snapshot())
        return out

    os.environ[jitguard.ENV_FLAG] = "1"
    log_dir = ""
    engine = InferenceEngine(cfg, params, ecfg, seed=seed)
    out = {}
    try:
        t0 = time.perf_counter()
        engine.warmup()
        out["warmup_s"] = time.perf_counter() - t0
        check(jitguard.armed(), "warmup did not arm the recompile sentinel")
        traces0 = paged.trace_counts()
        steprec.drain_buffered()
        tracing.drain_buffered()
        dropped0 = steprec.dropped_total()
        m0, prefill0 = totals(), engine.prefill_tokens
        _reset_counts()
        # Any signature first met from here raises RecompileError on the
        # stream that met it, which _serve_mix fails on.
        with tracing.trace("chip:observe", force=True) as root:
            results, wall, _ = _serve_mix(engine, prompts, temps, n_first,
                                          new)
        engine._run_on_loop(lambda: None)  # the last step has recorded
        counts = _read_counts()
        m1 = totals()
        traces1 = paged.trace_counts()
        check(traces1 == traces0, f"a program met a new signature after "
                                  f"warmup: {traces0} -> {traces1}")
        check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0
              and counts["rms_norm_bwd"] == 0,
              f"observe path did not launch K1 and K4's forward (and K4's "
              f"backward never): {counts}")
        print(f"[observe] 12 requests x {new} tokens under RT_DEBUG_JIT=1: "
              f"no RecompileError; wall {wall:.2f} s; trace_counts "
              f"{traces1}; compile_stats {devmem.compile_stats()}; "
              f"launches {counts}")

        # Spans: three stages per request, parented to the root.
        spans = [sp for sp in tracing.drain_buffered()
                 if sp["trace_id"] == root["trace_id"]]
        stages = {n: sorted((sp for sp in spans if sp["name"] == n),
                            key=lambda sp: (sp["attrs"]["prompt_len"]
                                            if "prompt_len" in sp["attrs"]
                                            else 0, sp["start"]))
                  for n in ("engine:queue", "engine:prefill",
                            "engine:decode")}
        for name, group in stages.items():
            check(len(group) == len(prompts),
                  f"{len(group)} {name} spans for {len(prompts)} requests")
            check(all(sp["parent_id"] == root["span_id"] for sp in group),
                  f"a {name} span is not parented to the root")
        streamed = sum(len(r[0]) for r in results)
        check(all(sp["attrs"]["tokens"] == new
                  for sp in stages["engine:decode"])
              and sum(sp["attrs"]["tokens"] for sp in stages[
                  "engine:decode"]) == streamed,
              "decode spans' tokens differ from the tokens streamed")
        # Pair each request with its queue and prefill spans by prompt
        # length, then submit order (two prompts have 512 tokens).
        order = sorted(range(len(prompts)),
                       key=lambda i: (len(prompts[i]), i))
        dev_ms = []
        for i, q, pf in zip(order, stages["engine:queue"],
                            stages["engine:prefill"]):
            check(q["attrs"]["prompt_len"] == pf["attrs"]["prompt_len"]
                  == len(prompts[i]), "spans do not pair with requests")
            dev_ms.append(abs(pf["end"] - q["start"] - results[i][1]) * 1e3)
        ttft_tol_ms = 10.0
        check(max(dev_ms) <= ttft_tol_ms,
              f"TTFT from spans differs from the engine's by "
              f"{max(dev_ms):.3f} ms (tolerance {ttft_tol_ms} ms)")
        breakdown = trace_analysis.stage_breakdown(spans)
        req_s = sum(breakdown.get(k, 0.0)
                    for k in ("queue", "prefill", "decode"))
        shares = {k: breakdown.get(k, 0.0) / req_s
                  for k in ("queue", "prefill", "decode")}
        print(f"[observe] spans: 3 x {len(prompts)} stage spans under the "
              f"root; TTFT from spans vs the engine's: max |diff| "
              f"{max(dev_ms):.3f} ms; stage breakdown (request-seconds) "
              + ", ".join(f"{k} {breakdown.get(k, 0.0):.3f} s "
                          f"({shares[k]:.3f})" for k in shares))

        # Step records.
        recs = [r for r in steprec.drain_buffered()
                if r["engine"] == engine.engine_id]
        fields = {"t", "engine", "step", "wall_s", "stall_s", "occupancy",
                  "slots", "admitted", "evicted", "shed", "queued",
                  "pages_used", "pages_free", "pages_shared", "prefix_hits",
                  "adapter_pins", "tenants"}
        check(recs and all(set(r) == fields for r in recs),
              "step records miss fields")
        check(sum(r["admitted"] for r in recs) == len(prompts),
              f"records admitted {sum(r['admitted'] for r in recs)} of "
              f"{len(prompts)}")
        check(steprec.dropped_total() == dropped0, "step records dropped")
        check(recs[-1]["pages_used"] + recs[-1]["pages_free"]
              == engine.allocator.total, f"last record's pages do not add "
                                         f"up to the pool: {recs[-1]}")
        walls = sorted(r["wall_s"] for r in recs if r["occupancy"] > 0)
        print(f"[observe] {len(recs)} step records, 17 fields each, "
              f"admitted {len(prompts)}, none dropped; decode-step wall "
              f"p50 {walls[len(walls) // 2] * 1e3:.2f} ms")

        # Metrics against the engine.
        d = {k: m1[k] - m0[k] for k in m1}
        prefilled = engine.prefill_tokens - prefill0
        check(prefilled == sum(
            sp["attrs"]["prompt_len"] - sp["attrs"]["cached_prefix"]
            for sp in stages["engine:prefill"]),
            "prefill tokens differ from the prefill spans'")
        check(d["ray_tpu_gen_tokens_total"] == streamed
              and d["ray_tpu_gen_prefill_tokens_total"] == prefilled
              and d["ray_tpu_serve_engine_completed_total"] == len(prompts)
              and d["ttft_count"] == len(prompts),
              f"metric deltas {d} disagree with the engine (tokens "
              f"{streamed}, prefilled {prefilled}, requests "
              f"{len(prompts)})")
        text = metrics.prometheus_text(metrics.snapshot_rows())
        names = counted + ("ray_tpu_serve_engine_ttft_seconds",
                           "ray_tpu_serve_engine_itl_seconds",
                           "ray_tpu_engine_stall_seconds_total",
                           "ray_tpu_gen_kv_pages_in_use",
                           "ray_tpu_serve_engine_queue_depth",
                           "ray_tpu_serve_engine_active_seqs")
        missing = [n for n in names if f"# TYPE {n} " not in text]
        check(not missing, f"prometheus text lacks {missing}")
        print(f"[observe] metric deltas {d}; prometheus text "
              f"{len(text.splitlines())} lines")

        # Device memory.
        snap = devmem.snapshot()
        pools = snap["pools"]
        weights = sum(p.nbytes for p in params.parameters())
        c = cfg
        kv = (2 * c.n_layers * (engine.allocator.total + 1) * c.n_kv_heads
              * ecfg.page_size * c.head_dim * c.dtype.itemsize)
        limit = torch.cuda.get_device_properties(0).total_memory
        check(sum(pools.values()) == snap["live_bytes"],
              "pools do not sum to live_bytes")
        check(pools["model_weights"] == weights,
              f"model_weights {pools['model_weights']} != {weights}")
        check(pools["kv_pool"] == kv, f"kv_pool {pools['kv_pool']} != {kv}")
        check(snap["devices"][0]["bytes_limit"] == limit,
              f"bytes_limit {snap['devices'][0]} != {limit}")
        peak = snap["devices"][0]["peak_bytes_in_use"]
        print(f"[observe] devmem: live {snap['live_bytes'] / 1e9:.3f} GB = "
              + " + ".join(f"{k} {v / 1e9:.4f}" for k, v in pools.items())
              + f" GB; peak {peak / 1e9:.3f} GB of {limit / 1e9:.2f} GB")

        # One device_trace window over 8 decode steps.  It must write its
        # trace file.  CUPTI has recorded no device activity in a whole
        # process's windows on the H100 machine (three in a row, while the
        # same windows held ~17,000 kernels in two other processes): then
        # the busy and idle share are not measured, and the run says so.
        log_dir = tempfile.mkdtemp(prefix="observe_trace_")
        busy_ms, n_kernels, attempts = 0.0, 0, 0
        while attempts < 3 and not n_kernels:
            attempts += 1
            streams = [engine.submit(p, max_new_tokens=64)
                       for p in prompts[:8]]
            firsts = [next(st) for st in streams]
            check(len(firsts) == 8, "profiled requests did not start")
            while engine.stats()["active_seqs"] < 8:
                time.sleep(0.001)
            dir_a = os.path.join(log_dir, str(attempts))
            with profiling.device_trace(dir_a):
                torch.cuda.synchronize()
                tw = time.perf_counter()
                s0 = engine.step_count
                while engine.step_count < s0 + 8:
                    time.sleep(0.0005)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - tw) * 1e3
                steps = engine.step_count - s0
            for st in streams:
                list(st)
            busy_ms, n_kernels = _trace_busy(dir_a)
            if not n_kernels:
                print("[observe] the trace holds no kernel; tracing again",
                      flush=True)
        idle = 1 - busy_ms / window_ms if n_kernels else None
        what = (f"{n_kernels} kernels, device busy {busy_ms:.1f} ms of "
                f"{window_ms:.1f} ms (idle share {idle:.3f})" if n_kernels
                else "CUPTI recorded no device activity, so busy and idle "
                     "share are not measured")
        print(f"[observe] device_trace over {steps} decode steps wrote its "
              f"trace ({attempts} window(s)): {what}; the serve-profile "
              f"window's idle share "
              f"{report['serve_profile']['idle_share']:.3f}")
        out.update(
            requests=len(prompts), wall_s=wall, launches=counts,
            trace_counts=traces1, compile_stats=devmem.compile_stats(),
            stage_s={k: breakdown.get(k, 0.0) for k in shares},
            stage_shares=shares, ttft_span_diff_ms_max=max(dev_ms),
            records=len(recs), step_wall_p50_ms=walls[len(walls) // 2] * 1e3,
            metric_deltas=d, prefilled=prefilled,
            devmem={"live_bytes": snap["live_bytes"], "pools": pools,
                    "device": snap["devices"][0]},
            trace_window={"steps": steps, "wall_ms": window_ms,
                          "windows": attempts, "kernels": n_kernels,
                          "device_busy_ms": busy_ms if n_kernels else None,
                          "idle_share": idle})

        # The recorder's cost: the same mix, recording on and off in turns
        # (one round of on, off, off, on) on this engine, each run from a
        # cold prefix cache; in the runs with recording on, the host time
        # of each _record_step call is read too.
        cost = []
        spent = []
        record_step = engine._record_step

        def timed_record(*a, **kw):
            t = time.perf_counter()
            record_step(*a, **kw)
            spent.append(time.perf_counter() - t)

        engine._record_step = timed_record
        for on in (True, False, False, True):
            check(_balanced(engine), "pages leaked between runs")
            engine.config.step_record = on
            steprec.drain_buffered()
            spent.clear()
            tps, itl_p50 = _observe_mix(engine, prompts, temps, n_first, new)
            engine._run_on_loop(lambda: None)
            n_rec = sum(r["engine"] == engine.engine_id
                        for r in steprec.drain_buffered())
            check((n_rec > 0) == on and len(spent) == n_rec,
                  f"step_record={on} but {n_rec} records, {len(spent)} "
                  f"calls")
            rec_us = sum(spent) / len(spent) * 1e6 if spent else 0.0
            cost.append({"step_record": on, "tokens_per_s": tps,
                         "itl_p50_ms": itl_p50, "records": n_rec,
                         "record_us": rec_us})
            print(f"[observe] step_record={on}: {tps:.2f} tokens/s, decode "
                  f"step p50 {itl_p50:.3f} ms, {n_rec} records"
                  + (f" at {rec_us:.1f} us of host time each" if on
                     else ""))
        engine.config.step_record = True
        del engine._record_step
        out["recorder_cost"] = cost
        mean = {on: np.mean([c["tokens_per_s"] for c in cost
                             if c["step_record"] == on])
                for on in (True, False)}
        on_runs = [c for c in cost if c["step_record"]]
        rec_share = np.mean([c["record_us"] / (c["itl_p50_ms"] * 1e3)
                             for c in on_runs])
        print(f"[observe] recorder cost: {mean[True]:.2f} tokens/s on vs "
              f"{mean[False]:.2f} off ({mean[True] / mean[False] - 1:+.4f}); "
              f"a record's host time is {rec_share:.5f} of the p50 step")
        out["recorder_share_of_step"] = rec_share
    finally:
        engine.shutdown()
        if log_dir:
            shutil.rmtree(log_dir, ignore_errors=True)
        os.environ.pop(jitguard.ENV_FLAG, None)
        jitguard.disarm()
    report["observe"] = out


# ---------------------------------------------------------------- runtime
#
# The port's runtime core on the card: a cluster started by ``rt.init`` in
# this process, a GPU task that runs layer 0 of the 8B model from the
# object store, and an 8B engine actor, each on a worker granted the card
# (``num_gpus=1``).  Kernel launch counts are read in those processes and
# returned.  Every check is fatal: the phase catches nothing.

#: The JAX engine's step record fields (``ray_tpu/serve/engine.py``).
_STEP_FIELDS = {
    "t", "engine", "step", "wall_s", "stall_s", "occupancy", "slots",
    "admitted", "evicted", "shed", "queued", "pages_used", "pages_free",
    "pages_shared", "prefix_hits", "adapter_pins", "tenants",
}


def _rt_block_task(cfg, layer, x, dev=None):
    """The GPU task's body: layer 0 on the card through ``_block`` (K4 on
    both norms, K1 in between); the output stays a CUDA tensor.  ``dev``
    "cpu" rehearses it on the CPU."""
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models.llama import _block
    from ray_tpu_torch.ops.rotary import rope_frequencies

    dev = resolve_device(dev)
    layer, x = layer.to(dev), x.to(dev)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=dev)
    _reset_counts()
    with torch.no_grad():
        out = _block(cfg, x, layer, cos, sin)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (out, _read_counts(), os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.getpid())


def _rt_probe_task():
    """An ungranted or granted task's view of the card."""
    import torch

    from ray_tpu_torch import resolve_device

    try:
        dev = str(resolve_device())
    except RuntimeError as e:
        dev = f"RuntimeError: {e}"
    return {"pid": os.getpid(), "cuda_available": torch.cuda.is_available(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "resolve_device": dev}


def _os_threads() -> int:
    """This process's OS threads (a fork copies only the caller's)."""
    return len(os.listdir("/proc/self/task"))


#: New tokens a request on the compiled DAG's engine stage (``greedy``)
#: and on the actor-call pass it is compared with: a request at B=1 costs
#: about 45 ms a token on the host-bound engine, so three passes of 12 x 32
#: tokens would take a minute.
_DAG_NEW = 8


class _RtEngineActor:
    """An 8B ``InferenceEngine`` in its own process on a granted card.  Its
    start is timed by stage from ``t_submit`` (the driver's wall clock at
    ``.remote()``): spawn to this method's first line, ``import torch``
    (and the OS threads it leaves), the CUDA context, the 8B build and the
    engine's.  ``greedy`` is its compiled-DAG step."""

    def __init__(self, seed: int, ecfg: dict, t_submit: float = None):
        t_first = time.time()
        preloaded = "torch" in sys.modules
        threads_before = _os_threads()
        import torch

        t_torch = time.time()
        threads_torch = _os_threads()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t_cuda = time.time()
        from ray_tpu_torch.models.llama import LlamaConfig, llama_init
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        self.cfg = LlamaConfig.llama3_8b()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = llama_init(self.cfg, gen)
        torch.cuda.synchronize()
        t_build = time.time()
        self.engine = InferenceEngine(self.cfg, self.params,
                                      EngineConfig(**ecfg), seed=seed)
        t_engine = time.time()
        self.start = {
            "spawn_to_first_line_s": (t_first - t_submit
                                      if t_submit is not None else None),
            "import_torch_s": t_torch - t_first,
            "cuda_context_s": t_cuda - t_torch,
            "build_8b_s": t_build - t_cuda, "engine_s": t_engine - t_build,
            "torch_preloaded": preloaded,
            "os_threads_before_torch": threads_before,
            "os_threads_after_torch": threads_torch}

    def info(self):
        import torch

        return {"pid": os.getpid(), "engine_id": self.engine.engine_id,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(), "start": self.start}

    def greedy(self, prompt):
        """The compiled DAG's engine stage: a prompt as an int64 tensor in,
        its ``_DAG_NEW`` greedy tokens out as an int64 tensor on the card
        (it crosses the edge as a CPU tensor)."""
        import torch

        stream = self.engine.submit(prompt.tolist(), max_new_tokens=_DAG_NEW)
        return torch.tensor(list(stream), dtype=torch.int64,
                            device=self.engine.device)

    def checksums(self):
        return _rt_checksums(self.params)

    def reset_counts(self):
        _reset_counts()

    def read_counts(self):
        return _read_counts()

    def serve(self, prompts, new: int):
        return _rt_serve(self.engine, prompts, new)

    def threads(self):
        return _rt_threads()

    def generate(self, prompt, new: int, traced: bool = False):
        from ray_tpu_torch.util import tracing

        if traced:
            with tracing.trace("runtime-actor-request", force=True) as root:
                stream = self.engine.submit(prompt, max_new_tokens=new)
                toks = list(stream)
            return toks, stream.ttft_s, root["trace_id"]
        stream = self.engine.submit(prompt, max_new_tokens=new)
        return list(stream), stream.ttft_s, None

    def ping(self):
        return 0


class _DagEncode:
    """The compiled DAG's first stage, a CPU actor granted no card: a
    prompt's token list to an int64 tensor."""

    def run(self, prompt):
        import torch

        return torch.tensor(prompt, dtype=torch.int64)

    def cuda_initialized(self):
        import torch

        return torch.cuda.is_initialized()


class _DagCollect(_DagEncode):
    """The last stage, a CPU actor granted no card: the tokens' tensor (a
    CPU tensor after the edge) to a list."""

    def run(self, tokens):
        return tokens.tolist()


class _DagNoop:
    """A CPU stage that passes its value on: three of them time a compiled
    DAG's round trip against three chained actor calls."""

    def ident(self, x):
        return x


def _rt_serve(engine, prompts, new: int):
    """Serve ``prompts`` one at a time; per request its tokens and the
    engine's own timings: TTFT (submit to the first token's emission),
    split into the queue wait (submit to admission) and the prefill
    (admission to the first token), in seconds.  The driver and the actor
    run this same function, so both sides measure alike."""
    recs = []
    for p in prompts:
        stream = engine.submit(p, max_new_tokens=new)
        toks = list(stream)
        req = stream._req
        recs.append({"tokens": toks, "ttft_s": stream.ttft_s,
                     "queue_s": req.admit_wall - req.submit_wall,
                     "prefill_s": req.first_wall - req.admit_wall})
    return recs


def _rt_threads():
    """What could compete with an engine for this process's host: its
    Python threads, torch's intra-op threads, the CPUs it may run on and
    the interpreter's switch interval."""
    import threading

    import torch

    names = sorted(t.name for t in threading.enumerate())
    return {"python_threads": len(names), "names": names,
            "torch_threads": torch.get_num_threads(),
            "cpus": len(os.sched_getaffinity(0)),
            "switch_interval_s": sys.getswitchinterval()}


def _rt_ttft(recs):
    """p50s in ms of `_rt_serve`'s timings."""
    return {k: _rt_p50([r[k + "_s"] for r in recs]) * 1e3
            for k in ("ttft", "queue", "prefill")}


def _rt_checksums(params):
    """Per-tensor fp64 sums of a model's weights, by name."""
    return {n: float(p.double().sum()) for n, p in params.named_parameters()}


def _rt_p50(xs):
    return sorted(xs)[len(xs) // 2]


def _rt_state(rt, kind):
    from ray_tpu_torch.core.context import ctx

    return ctx.client.call("list_state", {"kind": kind})["items"]


def _digest(bits):
    """bf16 values given as their int16 bits (numpy): the bytes' SHA-256
    and the values' fp64 sum.  Equal digests are equal bits; numpy alone,
    so a workflow step digests without importing torch."""
    import hashlib

    bits = np.ascontiguousarray(bits)
    vals = (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return {"sha256": hashlib.sha256(bits.tobytes()).hexdigest(),
            "fp64_sum": float(vals.astype(np.float64).sum())}


def _bf16_bits(a):
    """fp32 numpy values rounded to bf16 (to nearest, ties to even), as
    int16 bits."""
    u = a.astype(np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u >> np.uint32(16)).astype(np.uint16).view(np.int16)


def _cli(*argv, timeout: float = 120.0):
    """``python -m ray_tpu_torch`` against this process's cluster:
    (returncode, stdout, stderr)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "--address",
         os.environ["RT_TORCH_ADDRESS"], *argv], cwd=root, env=env,
        capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def _trace_kernels(path: str):
    """{kernel name: events} of the Chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _runtime_cli(wid: str, log_dir: str, res: dict):
    """The CLI against the live cluster while the DAG serves: ``status``,
    ``list actors``, ``stack`` and ``profile`` of the engine actor's
    worker, each in a subprocess.  A profile window in which CUPTI
    recorded no kernel is taken again, up to three windows; each
    window's start is ``res["window_t0"]`` (``time.perf_counter``).  The
    other three commands run beside the profile.  Fills ``res``."""
    t = time.perf_counter()

    def others():
        for name, argv in (("status", ("status",)),
                           ("list_actors", ("list", "actors")),
                           ("stack", ("stack", wid))):
            rc, so, se = _cli(*argv)
            res[name] = {"rc": rc, "stdout": so, "stderr": se[-2000:]}

    side = threading.Thread(target=others, daemon=True)
    side.start()
    for attempt in range(1, 4):
        dir_a = os.path.join(log_dir, str(attempt))
        res["window_t0"] = time.perf_counter()
        rc, so, se = _cli("profile", wid, "--seconds", "3", "--logdir",
                          dir_a)
        traces = glob.glob(f"{dir_a}/*.pt.trace.json")
        res["profile"] = {"rc": rc, "windows": attempt, "stdout": so,
                          "stderr": se[-2000:], "traces": len(traces)}
        if rc != 0 or len(traces) != 1:
            break
        kernels = _trace_kernels(traces[0])
        res["profile"]["kernels"] = sum(kernels.values())
        res["profile"]["by_kind"] = {}
        for name, n in kernels.items():
            kind = _kind_of(name)
            res["profile"]["by_kind"][kind] = res["profile"]["by_kind"].get(
                kind, 0) + n
        if kernels:
            break
    res["profile_s"] = time.perf_counter() - t
    side.join(timeout=300)
    res["cli_s"] = time.perf_counter() - t


def _dash_get(path: str):
    import urllib.request

    from ray_tpu_torch.core.context import ctx

    with urllib.request.urlopen(ctx.dashboard.url + path,
                                timeout=30) as resp:
        return resp.read()


def _runtime_dag(rt, actor, info, prompts, expect, actor_pass_s: float,
                 dag_stages, stages_cuda):
    """(a) A compiled DAG ``encode -> greedy -> collect`` through the 8B
    engine actor: the 12 prompts one ``execute`` at a time, then pipelined
    with ``execute_async`` (a submitter thread: the channels hold at most
    seven executions, so the eighth write waits for the first result);
    results in submission order equal to ``expect``; an oversize prompt
    raises the engine's ``ValueError`` and the DAG serves on; a no-op
    three-stage DAG's round trip beside three chained actor calls.  (b)
    The CLI in subprocesses during the pipelined pass.  (c) The dashboard
    while the actor holds the card.  ``dag_stages`` are the encode and
    collect actors and ``stages_cuda`` their pending ``cuda_initialized``
    calls.  Returns the path's numbers; launches are the actor's own."""
    import queue

    from ray_tpu_torch.dag import InputNode, enable_compiled_dags

    res = {}
    noop = enable_compiled_dags(rt.remote(_DagNoop))
    stages = [noop.remote() for _ in range(3)]
    with InputNode() as inp:
        node = stages[2].ident.bind(stages[1].ident.bind(
            stages[0].ident.bind(inp)))
    g = node.experimental_compile()
    try:
        for i in range(10):
            check(g.execute(i) == i, "the no-op DAG changed its value")
        hops = []
        for i in range(100):
            t = time.perf_counter()
            g.execute(i)
            hops.append(time.perf_counter() - t)
    finally:
        g.teardown()
    # Three chained actor calls, each awaited before the next; and five
    # chains that pass each call's ObjectRef on to the next call.
    chained, by_ref = [], []
    for i in range(100):
        t = time.perf_counter()
        v = rt.get(stages[2].ident.remote(rt.get(stages[1].ident.remote(
            rt.get(stages[0].ident.remote(i))))))
        chained.append(time.perf_counter() - t)
        check(v == i, "the chained calls changed their value")
    for i in range(5):
        t = time.perf_counter()
        v = rt.get(stages[2].ident.remote(stages[1].ident.remote(
            stages[0].ident.remote(i))))
        by_ref.append(time.perf_counter() - t)
        check(v == i, "the chained calls changed their value")
    res["noop_dag_p50_ms"] = _rt_p50(hops) * 1e3
    res["chained_calls_p50_ms"] = _rt_p50(chained) * 1e3
    res["chained_refs_p50_ms"] = _rt_p50(by_ref) * 1e3

    # The CPU stages, started with the engine actor (``stages_cuda``: each
    # one's first answer, after its import of torch).
    enc, col = dag_stages
    check(rt.get(stages_cuda, timeout=300) == [False, False],
          "a CPU stage of the DAG initialised CUDA")
    rt.get(actor.reset_counts.remote())
    with InputNode() as inp:
        node = col.run.bind(actor.greedy.bind(enc.run.bind(inp)))
    g = node.experimental_compile()
    cli = {}
    try:
        t = time.perf_counter()
        seq = [g.execute(p, timeout=300) for p in prompts]
        res["sequential_s"] = time.perf_counter() - t
        bad = [i for i, (a, b) in enumerate(zip(seq, expect)) if a != b]
        check(not bad, f"the DAG's sequential pass differs from the "
                       f"in-process engine's greedy tokens on {bad}")

        workers = _rt_state(rt, "workers")
        wid = next(w["worker_id"] for w in workers
                   if w.get("pid") == info["pid"])
        log_dir = tempfile.mkdtemp(prefix="runtime_profile_")
        cli_thread = threading.Thread(target=_runtime_cli,
                                      args=(wid, log_dir, cli), daemon=True)
        futs: "queue.Queue" = queue.Queue()

        def submit():
            for p in prompts:
                futs.put(g.execute_async(p, timeout=300))

        submitter = threading.Thread(target=submit, daemon=True)
        t = time.perf_counter()
        submitter.start()
        cli_thread.start()
        piped = [futs.get(timeout=300).result(timeout=300)
                 for _ in prompts]
        res["pipelined_s"] = time.perf_counter() - t
        submitter.join(timeout=60)
        check(piped == expect, "the DAG's pipelined pass differs from the "
                               "in-process engine's greedy tokens")
        # Keep the engine busy while a profile window may be open (the
        # CLI's start, the 3-s window and a margin), then let the actor
        # export its trace alone.
        extra = 0
        while cli_thread.is_alive():
            if time.perf_counter() > cli.get("window_t0", 0.0) + 8.0:
                time.sleep(0.05)
                continue
            i = extra % len(prompts)
            check(g.execute(prompts[i], timeout=300) == expect[i],
                  "an extra DAG execution differs from the in-process "
                  "engine's greedy tokens")
            extra += 1
        cli_thread.join()
        res["extra_executions"] = extra
        long_prompt = [1] * 600
        try:
            g.execute(long_prompt, timeout=300)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "prompt length 600" in raised,
              f"an oversize prompt through the DAG raised {raised!r}")
        res["oversize_error"] = raised
        check(g.execute(prompts[0], timeout=300) == expect[0],
              "the DAG did not serve on after the oversize prompt")

        # (c) The dashboard while the actor holds the card.
        status = json.loads(_dash_get("/api/status"))
        res["dashboard_status"] = {k: status[k] for k in (
            "resources_total", "resources_available", "actors_alive")}
        check(status["resources_total"].get("GPU") == 1
              and status["resources_available"].get("GPU", 0) == 0,
              f"/api/status while the actor holds the card: {status}")
        deadline = time.time() + 30
        metric = None
        while time.time() < deadline and metric is None:
            text = _dash_get("/metrics").decode()
            metric = next((ln for ln in text.splitlines()
                           if ln.startswith("ray_tpu_gen_tokens_total")
                           and float(ln.rsplit(" ", 1)[1]) > 0), None)
            if metric is None:
                time.sleep(0.5)
        check(metric is not None,
              "/metrics holds no ray_tpu_gen_tokens_total sample")
        res["dashboard_metric"] = metric
    finally:
        g.teardown()
    counts = rt.get(actor.read_counts.remote(), timeout=60)
    res["launches"] = counts
    res["stages_cuda_initialized"] = [
        rt.get(a.cuda_initialized.remote(), timeout=60) for a in (enc, col)]
    check(res["stages_cuda_initialized"] == [False, False],
          "a CPU stage of the DAG initialised CUDA")
    for a in stages + [enc, col]:
        rt.kill(a)
    cpu_actors = {a._actor_id.hex() for a in stages + [enc, col]}
    deadline = time.time() + 30
    while time.time() < deadline and any(
            a["actor_id"] in cpu_actors and a["state"] == "ALIVE"
            for a in _rt_state(rt, "actors")):
        time.sleep(0.2)
    check(not any(a["actor_id"] in cpu_actors and a["state"] == "ALIVE"
                  for a in _rt_state(rt, "actors")),
          "the DAG's CPU actors outlived their kill")
    check(counts["flash_fwd"] > 0 and counts["rms_norm"] > 0
          and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"]
          == counts["rms_norm_bwd"] == 0,
          f"the DAG path's launches in the actor: {counts}")

    # (b) What the CLI read while the DAG served.
    for name in ("status", "list_actors", "stack"):
        check(cli.get(name, {}).get("rc") == 0,
              f"the CLI's {name} failed: {cli.get(name)}")
    check(re.search(r"GPU: 1/1 used", cli["status"]["stdout"]) is not None,
          f"`status` does not show the card held: "
          f"{cli['status']['stdout']}")
    check(any("_RtEngineActor" in ln and "ALIVE" in ln
              for ln in cli["list_actors"]["stdout"].splitlines()),
          f"`list actors` does not show the engine actor ALIVE: "
          f"{cli['list_actors']['stdout']}")
    check("_dag_exec_loop" in cli["stack"]["stdout"],
          "`stack` shows no thread in the DAG exec loop")
    prof = cli["profile"]
    check(prof["rc"] == 0 and "trace dir:" in prof["stdout"]
          and prof["traces"] == 1, f"`profile` failed: {prof}")
    kinds = prof.get("by_kind", {})
    if prof.get("kernels"):
        check(kinds.get("K1 flash_fwd", 0) > 0 and kinds.get(
            "K4 rms_norm (forward and backward)", 0) > 0,
            f"the profile's kernels hold no K1 or K4: {kinds}")
    res["cli"] = {"profile_windows": prof["windows"],
                  "profile_kernels": prof.get("kernels", 0),
                  "profile_by_kind": kinds, "profile_s": cli["profile_s"],
                  "cli_s": cli["cli_s"]}
    tokens = len(prompts) * _DAG_NEW
    res.update(tokens=tokens, actor_pass_s=actor_pass_s,
               tok_s={"actor_calls": tokens / actor_pass_s,
                      "dag_sequential": tokens / res["sequential_s"],
                      "dag_pipelined": tokens / res["pipelined_s"]})
    print(f"[runtime] compiled DAG encode -> greedy -> collect through the "
          f"8B engine actor: {len(prompts)} requests x {_DAG_NEW} tokens "
          f"equal to the in-process engine's, one at a time in "
          f"{res['sequential_s']:.2f} s and pipelined in "
          f"{res['pipelined_s']:.2f} s (tokens/s: actor calls "
          f"{res['tok_s']['actor_calls']:.1f}, DAG sequential "
          f"{res['tok_s']['dag_sequential']:.1f}, DAG pipelined "
          f"{res['tok_s']['dag_pipelined']:.1f}); oversize prompt: "
          f"ValueError, then served on; a no-op three-stage DAG round trip "
          f"{res['noop_dag_p50_ms']:.3f} ms against three chained actor "
          f"calls {res['chained_calls_p50_ms']:.3f} ms (p50 of 100; "
          f"passing each ObjectRef on, {res['chained_refs_p50_ms']:.1f} ms, "
          f"p50 of 5); "
          f"launches {counts}", flush=True)
    what = (f"{prof['kernels']} kernels in window {prof['windows']}, by "
            f"kind {kinds}" if prof.get("kernels") else
            "CUPTI recorded no device activity in three windows: the "
            "kernels are not measured")
    print(f"[runtime] CLI during the pipelined pass: status shows GPU 1/1 "
          f"used, list actors shows the engine actor ALIVE, stack shows "
          f"the DAG exec loop, profile wrote its trace ({what}); "
          f"dashboard: GPU total {status['resources_total'].get('GPU')}, "
          f"available {status['resources_available'].get('GPU', 0)}; "
          f"{metric}", flush=True)
    return res


def _wf_act(seed: int, d_model: int):
    """The workflow's first step: a seeded [1, 2048, d_model] bf16
    activation, as int16 bits in numpy.  The workflow's CPU steps run on
    pooled workers; in numpy none of them imports torch (about 8 s a fresh
    worker on the card's host)."""
    rng = np.random.default_rng(seed)
    return _bf16_bits(rng.standard_normal((1, 2048, d_model),
                                          dtype=np.float32))


def _wf_block_task(cfg, layer, bits):
    """The workflow's GPU task: ``_rt_block_task`` on the activation's bits;
    the output goes back as int16 bits too."""
    import torch

    x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    out, counts, visible, _ = _rt_block_task(cfg, layer, x)
    return out.cpu().view(torch.int16).numpy(), counts, visible


def _wf_layer(bits, refs):
    """The workflow's GPU step: a plain task that submits the block task
    with ``num_gpus=1`` on layer 0 from the object store (``refs`` holds the
    config's and the layer's ``ObjectRef``: boxed, they reach the GPU task
    unread, so this step loads no torch), and counts its runs in the
    cluster KV."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.context import ctx

    task = rt.remote(num_gpus=1)(_wf_block_task)
    out, counts, visible = rt.get(task.remote(refs[0], refs[1], bits),
                                  timeout=600)
    runs = int(ctx.client.kv_get("chip_smoke:wf_gpu_runs") or b"0") + 1
    ctx.client.kv_put("chip_smoke:wf_gpu_runs", str(runs).encode())
    return {"out": out, "launches": counts, "visible": visible}


def _wf_digest(layer_out, marker: str):
    """The workflow's last step; its first attempt fails (``marker``)."""
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("the digest step fails on its first attempt")
    return dict(_digest(layer_out["out"]), launches=layer_out["launches"],
                visible=layer_out["visible"])


def _runtime_workflow(torch, rt, cfg, params, seed: int, layer_ref):
    """(d) ``act -> layer -> digest`` as a durable workflow: the first run
    fails at ``digest``; a second run of the same ``workflow_id`` loads
    ``layer`` from storage, so its GPU task runs once in all; the digest
    equals ``_block`` in this process bit for bit."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.core.context import ctx
    from ray_tpu_torch.models.llama import _block
    from ray_tpu_torch.ops.rotary import rope_frequencies

    dev = params.layers[0].attn.wq.device
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=dev)
    x = torch.from_numpy(_wf_act(seed, cfg.d_model)).view(torch.bfloat16)
    with torch.no_grad():
        ref = _block(cfg, x.to(dev), params.layers[0], cos, sin)
    expect = _digest(ref.cpu().view(torch.int16).numpy())
    del x, ref
    store = tempfile.mkdtemp(prefix="runtime_workflow_")
    marker = os.path.join(store, "digest_failed_once")
    ctx.client.kv_del("chip_smoke:wf_gpu_runs")
    act = workflow.step(_wf_act)(seed, cfg.d_model)
    out = workflow.step(_wf_layer)(act, [rt.put(cfg), layer_ref])
    node = workflow.step(_wf_digest)(out, marker)
    t = time.perf_counter()
    try:
        workflow.run(node, workflow_id="runtime-layer", storage=store)
        first = None
    except Exception as e:  # noqa: BLE001: the step's error, as a TaskError
        first = f"{type(e).__name__}: {e}"
    first_s = time.perf_counter() - t
    check(first is not None and "first attempt" in first,
          f"the workflow's first run did not fail at digest: {first!r}")
    t = time.perf_counter()
    got = workflow.run(node, workflow_id="runtime-layer", storage=store)
    resume_s = time.perf_counter() - t
    runs = int(ctx.client.kv_get("chip_smoke:wf_gpu_runs") or b"0")
    res = {"first_run_s": first_s, "resume_s": resume_s, "gpu_runs": runs,
           "launches": got["launches"], "visible": got["visible"],
           "bit_identical": got["sha256"] == expect["sha256"],
           "fp64_sum": got["fp64_sum"]}
    print(f"[runtime] workflow act -> layer -> digest: the first run failed "
          f"at digest in {first_s:.2f} s, the resumed run loaded layer "
          f"from storage and finished in {resume_s:.2f} s; the GPU task "
          f"ran {runs} time(s) (CUDA_VISIBLE_DEVICES={got['visible']!r}, "
          f"launches {got['launches']}); digest bit-identical to this "
          f"process's _block: {res['bit_identical']}", flush=True)
    check(runs == 1, f"the workflow's GPU task ran {runs} times")
    check(got["visible"] == "0", f"the GPU task saw {got['visible']!r}")
    check(res["bit_identical"] and got["fp64_sum"] == expect["fp64_sum"],
          f"the workflow's digest {got} differs from _block's {expect}")
    check(got["launches"]["flash_fwd"] == 1
          and got["launches"]["rms_norm"] == 2
          and sum(got["launches"].values()) == 3,
          f"the workflow's GPU task did not launch K1 once and K4 twice: "
          f"{got['launches']}")
    shutil.rmtree(store, ignore_errors=True)
    return res


def _job_k4(seed: int, d: int):
    """K4 on a seeded [2048, d] bf16 input on the card: the output's digest
    and every kernel's launches in this call (the job's GPU task, and the
    reference in the driver)."""
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.ops import norms

    dev = resolve_device()
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2048, d), generator=gen).to(torch.bfloat16).to(dev)
    w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(torch.bfloat16).to(
        dev)
    before = {k: f.launches for k, f in _counters().items()}
    y = norms.rms_norm_cuda(x, w)
    torch.cuda.synchronize()
    return dict(_digest(y.cpu().view(torch.int16).numpy()),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                launches={k: f.launches - before[k]
                          for k, f in _counters().items()})


_JOB_MAIN = """

if __name__ == "__main__":
    import json
    import ray_tpu_torch as rt

    rt.init()
    out = rt.get(rt.remote(num_gpus=1)(_job_k4).remote({seed}, {d}),
                 timeout=600)
    print("JOB_RESULT " + json.dumps(out), flush=True)
    rt.shutdown()
"""


def _runtime_job(rt, seed: int, d: int):
    """(e) A job: ``JobSubmissionClient`` runs ``python job_entry.py``,
    which joins the cluster and runs K4 in a ``num_gpus=1`` task; it must
    end SUCCEEDED with its result line in its logs, K4's output equal to
    K4 in this process bit for bit and one K4 launch; ``/api/jobs`` lists
    it and ``/api/status`` shows the card free again."""
    import inspect

    from ray_tpu_torch.job_submission import JobSubmissionClient

    tmp = tempfile.mkdtemp(prefix="runtime_job_")
    entry = os.path.join(tmp, "job_entry.py")
    with open(entry, "w") as f:
        f.write("import os\n\nimport numpy as np\n\n\n" + "\n\n".join(
            inspect.getsource(fn) for fn in (_counters, _digest, _job_k4))
            + _JOB_MAIN.format(seed=seed, d=d))
    root = os.path.dirname(os.path.abspath(__file__))
    client = JobSubmissionClient()
    t = time.perf_counter()
    job_id = client.submit_job(entrypoint=f"{sys.executable} {entry}",
                               env_vars={"PYTHONPATH": root})
    status = client.wait_until_finished(job_id, timeout=600)
    wall = time.perf_counter() - t
    logs = client.get_job_logs(job_id)
    line = next((ln for ln in logs.splitlines()
                 if ln.startswith("JOB_RESULT ")), None)
    check(status == "SUCCEEDED" and line is not None,
          f"the job ended {status}; its logs:\n{logs[-3000:]}")
    got = json.loads(line.split(" ", 1)[1])
    ref = _job_k4(seed, d)
    jobs = json.loads(_dash_get("/api/jobs"))["items"]
    free = json.loads(_dash_get("/api/status"))["resources_available"]
    res = {"job_id": job_id, "status": status, "wall_s": wall,
           "launches": got["launches"], "visible": got["visible"],
           "bit_identical": got["sha256"] == ref["sha256"],
           "fp64_sum": got["fp64_sum"],
           "listed": [j for j in jobs if j["job_id"] == job_id],
           "gpu_available_after": free.get("GPU", 0)}
    print(f"[runtime] job {job_id} (python job_entry.py): {status} in "
          f"{wall:.2f} s; its num_gpus=1 task "
          f"(CUDA_VISIBLE_DEVICES={got['visible']!r}) ran K4 on [2048, "
          f"{d}] bf16, launches {got['launches']}, fp64 checksum "
          f"{got['fp64_sum']!r}, bit-identical to K4 in this process: "
          f"{res['bit_identical']}; /api/jobs {res['listed']}; GPU "
          f"available after {res['gpu_available_after']}", flush=True)
    check(res["bit_identical"] and got["fp64_sum"] == ref["fp64_sum"],
          f"the job's K4 output differs from this process's: {got} {ref}")
    check(got["launches"]["rms_norm"] == 1
          and sum(got["launches"].values()) == 1,
          f"the job's task launches: {got['launches']}")
    check(got["visible"] == "0", f"the job's task saw {got['visible']!r}")
    check(res["listed"] and res["listed"][0]["status"] == "SUCCEEDED",
          f"/api/jobs: {jobs}")
    check(res["gpu_available_after"] == 1,
          f"/api/status after the job: GPU available {free}")
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def phase_runtime(torch, report, cfg, params, seed: int, card: str):
    """The runtime core on the card (``rt.init``, a GPU task through the
    object store, an 8B engine actor, isolation); see the module
    docstring's phase list."""
    import ray_tpu_torch as rt

    out = {"card": card}
    shm = os.statvfs("/dev/shm")
    shm_bytes = shm.f_frsize * shm.f_blocks
    shm_free = shm.f_frsize * shm.f_bavail
    store = int(min(4 << 30, shm_free // 2))
    out.update(shm_bytes=shm_bytes, shm_free=shm_free,
               object_store_memory=store)
    print(f"[runtime] /dev/shm {shm_bytes / 2**30:.1f} GiB "
          f"({shm_free / 2**30:.1f} free); object_store_memory "
          f"{store / 2**30:.2f} GiB", flush=True)
    check("RT_GPUS" not in os.environ,
          "the GPU count must come from autodetection, not RT_GPUS")
    t0 = time.perf_counter()
    rt.init(num_cpus=4, object_store_memory=store, include_dashboard=True)
    try:
        out["init_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        out["resources"] = res
        check(res.get("GPU") == 1.0,
              f"autodetected GPU resource {res.get('GPU')}, expected 1")
        _runtime_paths(torch, rt, out, cfg, params, seed)
    finally:
        rt.shutdown()
    report["runtime"] = out


def _runtime_paths(torch, rt, out, cfg, params, seed):
    """``phase_runtime``'s paths on a started cluster; fills ``out``."""
    from ray_tpu_torch.core import object_store
    from ray_tpu_torch.models.llama import Block, _block
    from ray_tpu_torch.ops.rotary import rope_frequencies
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    card = out["card"]
    noop = rt.remote(lambda: 0)
    probe = rt.remote(_rt_probe_task)
    rt.get(noop.remote())  # a warm worker
    rtt = []
    for _ in range(20):
        t = time.perf_counter()
        rt.get(noop.remote())
        rtt.append(time.perf_counter() - t)
    out["task_rtt_p50_ms"] = _rt_p50(rtt) * 1e3

    # -- isolation: an ungranted task sees no card ------------------------
    seen = rt.get(probe.remote(), timeout=300)
    out["ungranted"] = seen
    print(f"[runtime] ungranted task: CUDA_VISIBLE_DEVICES="
          f"{seen['visible']!r}, torch.cuda.is_available() "
          f"{seen['cuda_available']}, resolve_device() -> "
          f"{seen['resolve_device']}", flush=True)
    check(seen["visible"] == "" and not seen["cuda_available"]
          and seen["resolve_device"].startswith("RuntimeError: CUDA is not "
                                                "available"),
          f"an ungranted task reached the card: {seen}")

    # -- layer 0 of the 8B model through the object store ----------------
    layer = Block(cfg, "cpu")
    layer.load_state_dict({k: v.cpu() for k, v
                           in params.layers[0].state_dict().items()})
    n_layer = sum(p.numel() for p in layer.parameters())
    layer_bytes = sum(p.numel() * p.element_size()
                      for p in layer.parameters())
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 2048, cfg.d_model), generator=gen).to(cfg.dtype)
    object_store.reset_put_stages()
    t = time.perf_counter()
    layer_ref = rt.put(layer)
    put_s = time.perf_counter() - t
    stages = object_store.put_stage_snapshot()
    # The same bytes as one numpy array: what a put costs without tensors.
    flat = np.ones(layer_bytes, dtype=np.uint8)
    t = time.perf_counter()
    flat_ref = rt.put(flat)
    np_put_s = time.perf_counter() - t
    del flat_ref, flat
    x_ref = rt.put(x)
    t = time.perf_counter()
    back = rt.get(layer_ref)
    get_s = time.perf_counter() - t
    check(all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                 layer.parameters())),
          "layer 0 from get differs from the layer put")
    del back
    out["layer"] = {"params": n_layer, "bytes": layer_bytes,
                    "put_s": put_s, "get_s": get_s,
                    "put_gb_s": layer_bytes / put_s / 1e9,
                    "get_gb_s": layer_bytes / get_s / 1e9,
                    "put_stages_s": {k: v["seconds"]
                                     for k, v in stages.items()},
                    "numpy_put_gb_s": layer_bytes / np_put_s / 1e9}
    block_task = rt.remote(num_gpus=1)(_rt_block_task)
    t = time.perf_counter()
    got, task_counts, task_visible, task_pid = rt.get(
        block_task.remote(cfg, layer_ref, x_ref), timeout=600)
    task_s = time.perf_counter() - t
    dev = params.layers[0].attn.wq.device
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=dev)
    with torch.no_grad():
        ref = _block(cfg, x.to(dev), params.layers[0], cos, sin).cpu()
    check(got.device.type == "cpu" and got.dtype == ref.dtype
          and got.shape == ref.shape,
          f"the task's CUDA output came back as {got.device} {got.dtype} "
          f"{tuple(got.shape)}")
    same = bool(torch.equal(got.view(torch.int16), ref.view(torch.int16)))
    max_abs = float((got.float() - ref.float()).abs().max())
    out["layer"].update(task_s=task_s, launches=task_counts,
                        visible=task_visible, bit_identical=same,
                        max_abs_err=max_abs)
    stage_ms = {k: round(v["seconds"] * 1e3, 1) for k, v in stages.items()}
    print(f"[runtime] layer 0 of Llama-3-8B ({n_layer / 1e6:.1f} M params, "
          f"{layer_bytes / 1e6:.1f} MB bf16) put {put_s * 1e3:.1f} ms "
          f"({out['layer']['put_gb_s']:.2f} GB/s; by stage, ms: "
          f"{stage_ms}"
          f"; the same bytes as one numpy array "
          f"{out['layer']['numpy_put_gb_s']:.2f} GB/s), get "
          f"{get_s * 1e3:.1f} ms ({out['layer']['get_gb_s']:.2f} GB/s); "
          f"the num_gpus=1 task (CUDA_VISIBLE_DEVICES={task_visible!r}) ran "
          f"_block on [1, 2048, 4096] in {task_s:.2f} s wall (a fresh "
          f"worker, torch import and CUDA start included); output "
          f"bit-identical to this process's _block: {same} (max abs "
          f"{max_abs:.3g}); launches {task_counts}; {card}", flush=True)
    check(task_visible == "0", f"the granted task saw "
                               f"CUDA_VISIBLE_DEVICES={task_visible!r}")
    check(same, f"the GPU task's _block differs from this process's "
                f"(max abs {max_abs})")
    check(task_counts["flash_fwd"] == 1 and task_counts["rms_norm"] == 2,
          f"the GPU task did not launch K1 once and K4 twice: {task_counts}")
    del layer, x_ref, got, ref

    # -- the in-process engine first, then the actor ---------------------
    ecfg = dict(batch_slots=8, page_size=16, max_prompt_len=512,
                max_new_tokens_cap=64, prefix_cache=False)
    new = 32
    prompts, _, _ = _serve_mix_prompts(cfg, seed)
    prompts = [[int(t) for t in p] for p in prompts]
    engine = InferenceEngine(cfg, params, EngineConfig(**ecfg), seed=seed)
    try:
        local = _rt_serve(engine, prompts, new)
        local_one = _rt_serve(engine, prompts, 1)
        local_threads = _rt_threads()
    finally:
        engine.shutdown()
    del engine
    sums = _rt_checksums(params)
    gc.collect()
    torch.cuda.empty_cache()

    from ray_tpu_torch.dag import enable_compiled_dags

    actor_cls = enable_compiled_dags(rt.remote(num_gpus=1)(_RtEngineActor))
    t = time.perf_counter()
    actor = actor_cls.remote(seed, ecfg, time.time())
    # The compiled DAG's CPU stages import torch (7-10 s each) while the
    # engine actor starts, off the DAG path's clock.
    dag_stages = [enable_compiled_dags(rt.remote(c)).remote()
                  for c in (_DagEncode, _DagCollect)]
    stages_cuda = [a.cuda_initialized.remote() for a in dag_stages]
    info = rt.get(actor.info.remote(), timeout=900)
    out["actor_start_s"] = time.perf_counter() - t
    out["actor"] = info
    st = info["start"]
    print(f"[runtime] the 8B engine actor's start by stage (s): spawn to "
          f"its first line {st['spawn_to_first_line_s']:.2f}, import torch "
          f"{st['import_torch_s']:.2f} (preloaded: {st['torch_preloaded']}; "
          f"OS threads {st['os_threads_before_torch']} before, "
          f"{st['os_threads_after_torch']} after), CUDA context "
          f"{st['cuda_context_s']:.2f}, 8B build {st['build_8b_s']:.2f}, "
          f"engine {st['engine_s']:.2f}; {out['actor_start_s']:.1f} s in "
          f"all at the driver", flush=True)
    check(info["visible"] == "0" and info["count"] == 1,
          f"the actor's card: {info}")
    actor_sums = rt.get(actor.checksums.remote(), timeout=300)
    diff = [n for n in sums if actor_sums.get(n) != sums[n]]
    check(set(actor_sums) == set(sums) and not diff,
          f"the actor's weights differ from this process's: {diff[:5]}")
    rt.get(actor.reset_counts.remote())
    remote = rt.get(actor.serve.remote(prompts, new), timeout=600)
    actor_counts = rt.get(actor.read_counts.remote())
    remote_one = rt.get(actor.serve.remote(prompts, 1), timeout=600)
    actor_threads = rt.get(actor.threads.remote())
    match = [r["tokens"] == l["tokens"] for r, l in zip(remote, local)]
    check(all(match), f"the actor's greedy tokens differ from the "
                      f"in-process engine's on requests "
                      f"{[i for i, m in enumerate(match) if not m]}")
    check(actor_counts["flash_fwd"] > 0 and actor_counts["rms_norm"] > 0
          and actor_counts["rms_norm_bwd"] == 0,
          f"the actor's serving did not launch K1 and K4: {actor_counts}")
    # Timing through the actor: a first token (max_new_tokens=1) per
    # prompt timed at this process, and the bare call's round trip.
    first = []
    for p in prompts:
        t = time.perf_counter()
        rt.get(actor.generate.remote(p, 1))
        first.append(time.perf_counter() - t)
    pings = []
    for _ in range(20):
        t = time.perf_counter()
        rt.get(actor.ping.remote())
        pings.append(time.perf_counter() - t)
    # The first pass is cold in the actor's process; the one-token pass,
    # after it, reads the warm TTFT on both sides.
    passes = {"first": (local, remote), "one_token": (local_one, remote_one)}
    out["serve"] = {
        "requests": len(prompts), "new_tokens": new,
        "tokens_equal": all(match),
        # The in-process greedy tokens, for the serve-front phase.
        "tokens": [r["tokens"] for r in local],
        "ttft_p50_ms": {name: {"in_process": _rt_ttft(a),
                               "in_actor": _rt_ttft(b)}
                        for name, (a, b) in passes.items()},
        "ttft_in_process_ms": {name: [r["ttft_s"] * 1e3 for r in a]
                               for name, (a, _) in passes.items()},
        "ttft_in_actor_ms": {name: [r["ttft_s"] * 1e3 for r in b]
                             for name, (_, b) in passes.items()},
        "threads": {"in_process": local_threads, "in_actor": actor_threads},
        "first_token_through_actor_p50_ms": _rt_p50(first) * 1e3,
        "actor_call_rtt_p50_ms": _rt_p50(pings) * 1e3,
        "launches": actor_counts}
    sv = out["serve"]
    split = "; ".join(
        f"{name}: TTFT {v['in_process']['ttft']:.1f} / "
        f"{v['in_actor']['ttft']:.1f} ms (queue "
        f"{v['in_process']['queue']:.2f} / {v['in_actor']['queue']:.2f}, "
        f"prefill {v['in_process']['prefill']:.1f} / "
        f"{v['in_actor']['prefill']:.1f})"
        for name, v in sv["ttft_p50_ms"].items())
    print(f"[runtime] 8B engine actor (CUDA_VISIBLE_DEVICES="
          f"{info['visible']!r}, started in {out['actor_start_s']:.1f} s, "
          f"weights equal to this process's by {len(sums)} fp64 "
          f"checksums): {len(prompts)} greedy requests x {new} tokens, one "
          f"at a time, equal token for token to the in-process engine's; "
          f"engine p50s in process / in the actor, by pass: {split}; "
          f"first token through an actor call "
          f"{sv['first_token_through_actor_p50_ms']:.1f} ms; actor call "
          f"round trip {sv['actor_call_rtt_p50_ms']:.2f} ms, task round "
          f"trip {out['task_rtt_p50_ms']:.2f} ms (p50 of 20); threads "
          f"in process / in the actor: python "
          f"{local_threads['python_threads']} / "
          f"{actor_threads['python_threads']}, torch "
          f"{local_threads['torch_threads']} / "
          f"{actor_threads['torch_threads']}, cpus {local_threads['cpus']} "
          f"/ {actor_threads['cpus']}; launches {actor_counts}; {card}",
          flush=True)

    # -- observability across the process boundary -----------------------
    _, _, trace_id = rt.get(actor.generate.remote(prompts[0], 4, True),
                            timeout=300)
    steps, spans, devmem = [], [], []
    deadline = time.time() + 60
    while time.time() < deadline:
        steps = [r for g in _rt_state(rt, "engine_steps")
                 if g["engine"] == info["engine_id"] for r in g["records"]]
        spans = [e for e in _rt_state(rt, "timeline")
                 if e.get("kind") == "span" and e.get("trace_id") == trace_id]
        devmem = [d for d in _rt_state(rt, "devmem")
                  if d["pid"] == info["pid"]]
        names = {s["name"] for s in spans}
        if steps and devmem and {"engine:queue", "engine:prefill",
                                 "engine:decode"} <= names:
            break
        time.sleep(0.5)
    fields = set().union(*(set(r) for r in steps)) if steps else set()
    pools = devmem[0]["devmem"]["pools"] if devmem else {}
    out["observe"] = {"step_records": len(steps),
                      "step_fields": sorted(fields),
                      "span_names": sorted({s["name"] for s in spans}),
                      "devmem_pools": sorted(pools),
                      "devmem_live_bytes": devmem[0]["devmem"]["live_bytes"]
                      if devmem else None}
    print(f"[runtime] at the head: {len(steps)} step records of the "
          f"actor's engine ({len(fields)} fields), spans "
          f"{out['observe']['span_names']} of its traced request, devmem "
          f"pools {sorted(pools)}", flush=True)
    check(steps and fields == _STEP_FIELDS,
          f"the actor's step records at the head: {len(steps)} with fields "
          f"{sorted(fields)}")
    check({"runtime-actor-request", "engine:queue", "engine:prefill",
           "engine:decode"} <= set(out["observe"]["span_names"]),
          f"the actor's spans at the head: {out['observe']['span_names']}")
    check({"model_weights", "kv_pool"} <= set(pools)
          and pools["model_weights"] > 0,
          f"the actor's devmem report at the head: {devmem}")

    # -- compiled DAG, CLI and dashboard while the actor holds the card --
    t = time.perf_counter()
    actor_pass = []
    for p in prompts:
        toks, _, _ = rt.get(actor.generate.remote(p, _DAG_NEW), timeout=300)
        actor_pass.append(toks)
    actor_pass_s = time.perf_counter() - t
    check(actor_pass == [r["tokens"][:_DAG_NEW] for r in local],
          "the actor-call pass's tokens differ from the in-process engine's")
    t = time.perf_counter()
    out["dag"] = _runtime_dag(rt, actor, info, prompts,
                              [r["tokens"][:_DAG_NEW] for r in local],
                              actor_pass_s, dag_stages, stages_cuda)
    out["dag"]["path_s"] = time.perf_counter() - t
    print(f"[time] runtime dag, CLI and dashboard: "
          f"{out['dag']['path_s']:.1f} s", flush=True)

    # -- isolation: the card is held, so a second GPU task waits ---------
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    listed = sorted(int(x) for x in apps.stdout.split() if x.strip())
    allowed = {os.getpid(), info["pid"], task_pid}
    out["compute_apps"] = {"listed": listed, "allowed": sorted(allowed)}
    pending = probe.options(num_gpus=1).remote()
    ready, _ = rt.wait([pending], timeout=5.0)
    out["second_task_pending_while_held"] = not ready
    check(not ready, "a second num_gpus=1 task ran while the actor held "
                     "the one card")
    rt.kill(actor)
    t = time.perf_counter()
    after = rt.get(pending, timeout=300)
    out["second_task_after_kill"] = dict(after, wait_s=time.perf_counter()
                                         - t)
    check(after["visible"] == "0" and after["cuda_available"],
          f"the second GPU task after the kill: {after}")
    print(f"[runtime] a second num_gpus=1 task stayed pending while the "
          f"actor held the card and ran {time.perf_counter() - t:.2f} s "
          f"after its kill (CUDA_VISIBLE_DEVICES={after['visible']!r}); "
          f"nvidia-smi compute apps {listed} (this process {os.getpid()}, "
          f"the actor {info['pid']})", flush=True)
    if listed and os.getpid() in listed:
        check(set(listed) <= allowed,
              f"a process the runtime did not grant holds the card: "
              f"{listed} (allowed {sorted(allowed)})")
    else:
        # The container's nvidia-smi shows no pids, or pids of another
        # namespace, which cannot be mapped to this one's: then this is a
        # count only, and an ungranted worker on the card would pass it in
        # place of a granted one.  The ungranted probe above is what shows
        # that a worker without a grant cannot reach the card.
        check(len(listed) <= len(allowed),
              f"nvidia-smi lists {listed}: more than the driver and the "
              f"granted actor")
    counts = {k: task_counts[k] + actor_counts[k] for k in task_counts}
    out["launches"] = counts

    # -- after the kill: a workflow and a job, each through a GPU task ---
    t = time.perf_counter()
    out["workflow"] = _runtime_workflow(torch, rt, cfg, params, seed,
                                        layer_ref)
    out["workflow"]["path_s"] = time.perf_counter() - t
    print(f"[time] runtime workflow: {out['workflow']['path_s']:.1f} s",
          flush=True)
    del layer_ref
    t = time.perf_counter()
    out["job"] = _runtime_job(rt, seed, cfg.d_model)
    out["job"]["path_s"] = time.perf_counter() - t
    print(f"[time] runtime job: {out['job']['path_s']:.1f} s", flush=True)


# ------------------------------------------------------------ serve front
#
# The serve-front phase drives the port's serving front (``serve.run``, the
# controller and its replica actors, handles and the HTTP ingress) with the
# engine in the replicas' own processes.  Each replica's launch counts are
# read in that process, through a method of its deployment.

#: The serve-front phase's 12 requests in submit order (the serving cell's
#: mix: 8, then 4 while those decode): each one's entry point, its adapter
#: ("mux": the handle's ``multiplexed_model_id``; "adapter": ``adapter=``
#: in the SSE body), and the one cancelled mid-stream.
_FRONT_JOBS = (
    {"via": "handle"}, {"via": "sse"},
    {"via": "handle", "mux": "a1"}, {"via": "sse", "adapter": "a2"},
    {"via": "handle", "cancel": True}, {"via": "sse"},
    {"via": "handle"}, {"via": "sse"},
    {"via": "handle"}, {"via": "sse"}, {"via": "handle"}, {"via": "sse"})
#: The cancelled request stops reading after this many tokens.
_FRONT_CANCEL_AT = 4


class _Front8B:
    """The serve-front phase's Llama-3-8B deployment: an ``InferenceEngine``
    over ``llama_init`` weights from a ``torch.Generator`` seeded with
    ``seed`` (``phase_forward``'s), built in the replica's process on the
    card it was granted; tokens stream one item each, and a consumer that
    goes away cancels the request.  ``model="tiny"`` with ``device="cpu"``
    is the CPU rehearsal's."""

    def __init__(self, seed: int, ecfg: dict, model: str = "llama3_8b",
                 device=None):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.llama import LlamaConfig, llama_init
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        t = time.perf_counter()
        dev = resolve_device(device)
        cfg = (LlamaConfig.llama3_8b() if model == "llama3_8b"
               else LlamaConfig.tiny(dtype=torch.float32))
        self.params = llama_init(
            cfg, torch.Generator(device=dev.type).manual_seed(seed), dev)
        self.engine = InferenceEngine(cfg, self.params, EngineConfig(**ecfg),
                                      seed=seed, device=dev)
        self.init_s = time.perf_counter() - t

    def __call__(self, prompt_tokens, max_new_tokens: int = 16):
        stream = self.engine.submit(prompt_tokens,
                                    max_new_tokens=max_new_tokens)
        try:
            yield from stream
        finally:
            stream.cancel()

    def stats(self):
        return dict(self.engine.stats(), kernel_launches=_read_counts(),
                    init_s=self.init_s,
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))

    def reset_counts(self):
        _reset_counts()

    def local_mix(self, prompts, n_first: int, new: int):
        """The same mix served in this process with no front: each stream
        consumed by a thread here (``_serve_mix``), greedy."""
        results, wall, _ = _serve_mix(self.engine, prompts,
                                      [0.0] * len(prompts), n_first, new)
        itls = sorted(sum(r[3]) / len(r[3]) for r in results)
        ttfts = sorted(r[1] for r in results)
        tokens = sum(len(r[0]) for r in results)
        return {"tokens": [r[0] for r in results], "wall_s": wall,
                "tokens_per_s": tokens / wall,
                "itl_p50_ms": _rt_p50(itls) * 1e3,
                "ttft_p50_ms": _rt_p50(ttfts) * 1e3,
                "ttft_max_ms": ttfts[-1] * 1e3}


# -- autoscale: a GPU node added on demand ------------------------------------
#
# ``phase_autoscale`` starts a cluster whose head has no card, so a
# ``num_gpus=1`` task can only run on a node the autoscaler adds: a 1-host,
# 1-card slice (``a3-highgpu-1g``) through the in-memory Compute Engine
# stand-in, whose host joins as a node daemon granting ``{"GPU": 1}``.

#: The phase's idle timeout, poll period and limit (seconds).
AS_IDLE_S = 3.0
AS_POLL_S = 0.25
AS_LIMIT_S = 60.0
#: The instance history of a node that scaled up and back down.
AS_HISTORY = ["QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING",
              "TERMINATING", "TERMINATED"]


def _proc_born() -> float:
    """This process's start on the wall clock (``/proc``, 10-ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _as_block_task(cfg, layer, x, dev):
    """The added node's task: ``_rt_block_task``, with the worker's node
    id, its process's start, and the body's start and end on this host's
    clock."""
    start = time.time()
    out, counts, visible, pid = _rt_block_task(cfg, layer, x, dev)
    return {"out": out, "launches": counts, "visible": visible, "pid": pid,
            "node": os.environ.get("RT_NODE_ID"), "born": _proc_born(),
            "start": start, "end": time.time()}


def _same_bits(torch, a, b) -> bool:
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a.view(ints), b.view(ints))))


def phase_autoscale(torch, report, cfg, params, seed: int, card: str,
                    dev=None):
    """An ``Autoscaler`` over ``GpuSliceNodeProvider`` adds the node a
    pending ``num_gpus=1`` task needs, the task runs layer 0 of the 8B
    model there (K4, K1, K4) from the object store, and the idle node is
    deleted; see the module docstring's phase list.  ``dev="cpu"``
    rehearses it on the CPU (the tiny model, a 64-token input)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler
    from ray_tpu_torch.autoscaler.gce import (GpuSliceNodeProvider,
                                              MockGceGpuApi)
    from ray_tpu_torch.models.llama import Block, _block
    from ray_tpu_torch.ops.rotary import rope_frequencies

    t_phase = time.perf_counter()
    on_card = dev is None
    out = {"card": card}
    layer = Block(cfg, "cpu")
    layer.load_state_dict({k: v.cpu() for k, v
                           in params.layers[0].state_dict().items()})
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 2048 if on_card else 64, cfg.d_model),
                    generator=gen).to(cfg.dtype)
    pdev = params.layers[0].attn.wq.device
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=pdev)
    with torch.no_grad():
        ref = _block(cfg, x.to(pdev), params.layers[0], cos, sin).cpu()
    del cos, sin
    gc.collect()
    free0 = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    shm = os.statvfs("/dev/shm")
    store = int(min(4 << 30, shm.f_frsize * shm.f_bavail // 2))

    class Provider(GpuSliceNodeProvider):
        """Notes when each slice's hosts have joined, and their nodes."""

        joined = []

        def create_node(self):
            handle = super().create_node()
            self.joined.append((time.time(), handle.host_handles))
            return handle

    rt.init(num_cpus=1, num_gpus=0, object_store_memory=store)
    provider = None
    try:
        check("GPU" not in rt.cluster_resources(),
              f"the head offers a card: {rt.cluster_resources()}")
        api = MockGceGpuApi()
        provider = Provider(api, machine_type="a3-highgpu-1g",
                            num_cpus_per_host=1)
        scaler = Autoscaler(provider, min_nodes=0, max_nodes=1,
                            idle_timeout_s=AS_IDLE_S,
                            poll_interval_s=AS_POLL_S)
        layer_ref, x_ref = rt.put(layer), rt.put(x)
        task = rt.remote(num_gpus=1)(_as_block_task)
        scaler.start()
        try:
            t_submit = time.time()
            got = rt.get(task.remote(cfg, layer_ref, x_ref, dev),
                         timeout=300)
            t_result = time.time()
            deadline = time.monotonic() + AS_IDLE_S + 30
            while time.monotonic() < deadline and not (
                    provider.non_terminated_nodes() == []
                    and any(c["method"].endswith(".delete")
                            for c in api.calls)):
                time.sleep(0.05)
        finally:
            scaler.stop()
        state = scaler.instance_manager.get_state()
        creates = [c for c in api.calls if c["method"].endswith("bulkInsert")]
        deletes = [c for c in api.calls if c["method"].endswith(".delete")]
        check(len(creates) == 1 and len(provider.joined) == 1,
              f"the demand made {len(creates)} creates, expected 1")
        t_joined, hosts = provider.joined[0]
        check(len(deletes) == 1
              and deletes[0]["node_id"] == creates[0]["node_id"],
              f"scale-down deletes {deletes} against the create "
              f"{creates[0]['node_id']}")
        check(len(state) == 1 and [h["status"] for h in state[0]["history"]]
              == AS_HISTORY, f"instance history {state}")
        history = {h["status"]: h["ts"] for h in state[0]["history"]}
        node_ids = [h.hex for h in hosts]
        # The drained daemon exits after its grace window; its workers
        # follow it (their connection to it closes).
        for h in hosts:
            h.proc.wait(timeout=30)
        t_exit = time.time()
    finally:
        if provider is not None:
            provider._cluster.shutdown()  # the head too
        else:
            rt.shutdown()
    timing = {"scale_up_s": t_joined - t_submit,
              "worker_start_s": got["start"] - t_joined,
              "worker_born_s": got["born"] - t_submit,
              "worker_import_s": got["start"] - got["born"],
              "task_s": got["end"] - got["start"],
              "result_s": t_result - got["end"],
              "submit_to_result_s": t_result - t_submit,
              "scale_down_s": history["TERMINATED"] - t_result,
              "node_exit_s": t_exit - history["TERMINATED"]}
    same = _same_bits(torch, got["out"], ref)
    out.update(timing, node=got["node"], added_nodes=node_ids,
               visible=got["visible"], launches=got["launches"],
               bit_identical=same, create=creates[0],
               history=[h["status"] for h in state[0]["history"]],
               max_abs_err=float((got["out"].float()
                                  - ref.float()).abs().max()))
    print(f"[autoscale] submit to result {timing['submit_to_result_s']:.2f}"
          f" s: scale-up (demand seen, slice created, host joined) "
          f"{timing['scale_up_s']:.2f} s, worker start "
          f"{timing['worker_start_s']:.2f} s (its process started "
          f"{timing['worker_born_s']:.2f} s after the submit, then imports "
          f"and arguments {timing['worker_import_s']:.2f} s), task (layer 0 "
          f"to the card, _block on [1, {x.shape[1]}, {cfg.d_model}]) "
          f"{timing['task_s']:.2f} s, result back "
          f"{timing['result_s']:.2f} s; {card}", flush=True)
    print(f"[autoscale] scale-down {timing['scale_down_s']:.2f} s after the "
          f"result (idle timeout {AS_IDLE_S} s, poll {AS_POLL_S} s), the "
          f"node daemon gone {timing['node_exit_s']:.2f} s later; node "
          f"{str(got['node'])[:12]} (added {[n[:12] for n in node_ids]}), "
          f"CUDA_VISIBLE_DEVICES={got['visible']!r}, launches "
          f"{got['launches']}, bit-identical {same}; {card}", flush=True)
    check(got["node"] in node_ids,
          f"the task ran on node {got['node']}, not the added {node_ids}")
    check(bool(got["visible"]),
          f"the task saw CUDA_VISIBLE_DEVICES={got['visible']!r}")
    check(same, f"the added node's _block differs from this process's "
                f"(max abs {out['max_abs_err']})")
    if on_card:
        check(got["launches"]["flash_fwd"] == 1
              and got["launches"]["rms_norm"] == 2,
              f"the task did not launch K1 once and K4 twice: "
              f"{got['launches']}")
        deadline = time.monotonic() + 30
        while True:
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info()[0]
            if free >= free0 - (1 << 30) or time.monotonic() > deadline:
                break
            time.sleep(0.25)
        out["card_free_before"], out["card_free_after"] = free0, free
        print(f"[autoscale] card free {free0 / 2**30:.2f} GiB before, "
              f"{free / 2**30:.2f} GiB after shutdown; {card}", flush=True)
        check(free >= free0 - (1 << 30),
              f"the card's free memory did not come back: "
              f"{free0 / 2**30:.2f} GiB before, {free / 2**30:.2f} after")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[autoscale] phase {out['phase_s']:.1f} s (limit {AS_LIMIT_S} "
          f"s); {card}", flush=True)
    if on_card:
        check(out["phase_s"] <= AS_LIMIT_S,
              f"the autoscale phase took {out['phase_s']:.1f} s")
    report["autoscale"] = out


def _front_prompts(cfg, seed: int, cap: int):
    """The serving cell's 12 prompts (``_serve_mix_prompts``) as lists, cut
    to ``cap / 512`` of their length for a smaller prompt cap (the CPU
    rehearsal's tiny model); and how many come first."""
    prompts, _, n_first = _serve_mix_prompts(cfg, seed)
    return [[int(t) for t in p[:max(4, len(p) * cap // 512)]]
            for p in prompts], n_first


def _front_handle(handle, prompt, new: int, cancel: bool, rec: dict):
    """One request streamed through ``handle`` under a forced trace root
    (so the replica's engine spans carry its trace id)."""
    from ray_tpu_torch.util import tracing

    with tracing.trace("serve-front", force=True) as root:
        rec["t0"], rec["t0_wall"] = time.perf_counter(), time.time()
        stream = handle.remote(prompt, new)
    rec["trace_id"] = root["trace_id"]
    for tok in stream:
        rec["stamps"].append(time.perf_counter())
        rec.setdefault("first_wall", time.time())
        rec["tokens"].append(int(tok))
        if cancel and len(rec["tokens"]) == _FRONT_CANCEL_AT:
            stream.cancel()
            break


def _front_sse(port: int, app: str, body: dict, rec: dict):
    """One request as HTTP server-sent events, traced by the ingress
    (``X-RT-Force-Trace``): one ``data:`` frame a token, then ``event:
    done``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        rec["t0"], rec["t0_wall"] = time.perf_counter(), time.time()
        conn.request("POST", f"/{app}", body=json.dumps(body), headers={
            "Content-Type": "application/json",
            "Accept": "text/event-stream", "X-RT-Force-Trace": "1"})
        resp = conn.getresponse()
        check(resp.status == 200
              and resp.getheader("Content-Type") == "text/event-stream",
              f"SSE answered {resp.status} {resp.getheader('Content-Type')}")
        rec["trace_id"] = resp.getheader("X-RT-Trace-Id")
        event, done = None, False
        while not done:
            line = resp.readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            if line.startswith(b"event: "):
                event = line[7:].decode()
            elif line.startswith(b"data: "):
                check(event in (None, "done"),
                      f"SSE {event} frame: {line[6:].decode()}")
                if event is None:
                    rec["stamps"].append(time.perf_counter())
                    rec.setdefault("first_wall", time.time())
                    rec["tokens"].append(int(json.loads(line[6:])))
                done = event == "done"
            elif not line:
                event = None
        check(done, "the SSE stream ended without its done event")
    finally:
        conn.close()


def _front_mix(n_jobs: int, n_first: int, submit):
    """``submit(i, rec)`` for each request on its own thread: ``n_first``
    at once, the rest once each of those has streamed a token.  Returns
    the records (``tokens``, ``stamps``, ``t0``, ``trace_id``) and the
    wall seconds."""
    recs = [{"tokens": [], "stamps": []} for _ in range(n_jobs)]
    errors = []

    def run(i):
        try:
            submit(i, recs[i])
        except Exception as e:  # noqa: BLE001: reported below
            errors.append((i, repr(e)))

    threads = []

    def start(i):
        threads.append(threading.Thread(target=run, args=(i,), daemon=True))
        threads[-1].start()

    t0 = time.perf_counter()
    for i in range(n_first):
        start(i)
    deadline = time.time() + 600
    while (any(not recs[i]["stamps"] for i in range(n_first)) and not errors
           and time.time() < deadline):
        time.sleep(0.005)
    for i in range(n_first, n_jobs):
        start(i)
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "a stream did not finish in 600 s")
    wall = time.perf_counter() - t0
    check(not errors, f"stream errors: {errors}")
    return recs, wall


def _front_spans(rt, trace_ids, timeout: float = 60.0):
    """{trace id: {span name: span}} at the head, once every request's
    ``engine:decode`` span is there: its attrs hold the engine's own TTFT
    and mean inter-token latency; the ``engine:queue`` span starts at the
    engine's ``submit`` and ``engine:prefill`` ends at its first token
    (``time.time()`` on the same host as the client's clock)."""
    want, got = set(trace_ids), {}
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = {}
        for ev in _rt_state(rt, "timeline"):
            if ev.get("kind") == "span" and ev.get("trace_id") in want:
                got.setdefault(ev["trace_id"], {})[ev["name"]] = ev
        if sum("engine:decode" in v for v in got.values()) == len(want):
            break
        time.sleep(0.5)
    n = sum("engine:decode" in v for v in got.values())
    check(n == len(want), f"engine spans of {n} of {len(want)} requests "
                          f"reached the head")
    return got


def _front_timing(recs, jobs, spans, n_first: int, wall: float):
    """TTFT at the client (submission to the first item) and in the
    engine (its decode span's ``ttft_s``), the front's added latency (the
    difference, per request) and per token (client mean inter-token gap
    minus the engine's, over the requests that ran to the end), and
    tokens/s at the client; in ms."""
    per = []
    for i, (r, job) in enumerate(zip(recs, jobs)):
        sp = spans[r["trace_id"]]
        a = sp["engine:decode"]["attrs"]
        rec = {"via": job["via"], "late": i >= n_first,
               "client_ttft_ms": (r["stamps"][0] - r["t0"]) * 1e3,
               "engine_ttft_ms": a["ttft_s"] * 1e3}
        rec["added_ms"] = rec["client_ttft_ms"] - rec["engine_ttft_ms"]
        # Where the added time lies: from the client's submission to the
        # engine's submit (routing, dispatch, a replica lane), and from
        # the engine's first token to the client's first item (delivery).
        rec["dispatch_ms"] = (sp["engine:queue"]["start"]
                              - r["t0_wall"]) * 1e3
        rec["delivery_ms"] = (r["first_wall"]
                              - sp["engine:prefill"]["end"]) * 1e3
        # The dispatch by stage, from the handle's and the replica's spans:
        # the routing table (before the handle's span), the task's way to
        # a replica lane, and the replica's own code up to the engine.
        hs = next((v for k, v in sp.items() if k.startswith("handle:")),
                  None)
        rs = next((v for k, v in sp.items() if k.startswith("replica:")),
                  None)
        if hs is not None and rs is not None:
            rec["route_ms"] = (hs["start"] - r["t0_wall"]) * 1e3
            rec["to_replica_ms"] = (rs["start"] - hs["start"]) * 1e3
            rec["in_replica_ms"] = (sp["engine:queue"]["start"]
                                    - rs["start"]) * 1e3
        if not job.get("cancel") and len(r["stamps"]) > 1:
            rec["client_itl_ms"] = ((r["stamps"][-1] - r["stamps"][0])
                                    / (len(r["stamps"]) - 1) * 1e3)
            rec["engine_itl_ms"] = a["mean_itl_s"] * 1e3
            rec["added_per_token_ms"] = (rec["client_itl_ms"]
                                         - rec["engine_itl_ms"])
        per.append(rec)

    def p50(rows, key):
        xs = [r[key] for r in rows if key in r]
        return _rt_p50(xs) if xs else None

    groups = {"all": per,
              "handle": [r for r in per if r["via"] == "handle"],
              "sse": [r for r in per if r["via"] == "sse"],
              "first": [r for r in per if not r["late"]],
              "late": [r for r in per if r["late"]]}
    tokens = sum(len(r["tokens"]) for r in recs)
    return {
        "requests": per,
        "client_ttft_ms": {"p50": p50(per, "client_ttft_ms"),
                           "max": max(r["client_ttft_ms"] for r in per)},
        "engine_ttft_ms": {"p50": p50(per, "engine_ttft_ms"),
                           "max": max(r["engine_ttft_ms"] for r in per)},
        "client_itl_ms_p50": p50(per, "client_itl_ms"),
        "engine_itl_ms_p50": p50(per, "engine_itl_ms"),
        "added_ms_p50": {k: p50(v, "added_ms") for k, v in groups.items()},
        "dispatch_ms_p50": {k: p50(v, "dispatch_ms")
                            for k, v in groups.items()},
        "delivery_ms_p50": {k: p50(v, "delivery_ms")
                            for k, v in groups.items()},
        # Over the first wave (a late request's lane wait is its own).
        "dispatch_stages_ms_p50": {
            k: p50(groups["first"], k) for k in ("route_ms", "to_replica_ms",
                                                 "in_replica_ms")},
        "added_per_token_ms_p50": {k: p50(v, "added_per_token_ms")
                                   for k, v in groups.items()},
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall}


def _front_line(name: str, t: dict, card: str) -> str:
    f = lambda x: "n/a" if x is None else f"{x:.2f}"  # noqa: E731
    return (f"[serve-front] {name}: {len(t['requests'])} requests, "
            f"{t['tokens']} tokens in {t['wall_s']:.2f} s "
            f"({t['tokens_per_s']:.1f} tokens/s at the client); TTFT p50 / "
            f"max at the client {f(t['client_ttft_ms']['p50'])} / "
            f"{f(t['client_ttft_ms']['max'])} ms, in the engine "
            f"{f(t['engine_ttft_ms']['p50'])} / "
            f"{f(t['engine_ttft_ms']['max'])} ms; inter-token p50 at the "
            f"client {f(t['client_itl_ms_p50'])} ms, in the engine "
            f"{f(t['engine_itl_ms_p50'])} ms; the front's added latency "
            f"p50 per request (ms) "
            + ", ".join(f"{k} {f(v)}" for k, v in t["added_ms_p50"].items())
            + "; of that, p50 dispatch (ms) "
            + ", ".join(f"{k} {f(v)}" for k, v in t["dispatch_ms_p50"].items())
            + "; dispatch by stage, first wave (ms) "
            + ", ".join(f"{k[:-3]} {f(v)}"
                        for k, v in t["dispatch_stages_ms_p50"].items())
            + "; delivery (ms) "
            + ", ".join(f"{k} {f(v)}" for k, v in t["delivery_ms_p50"].items())
            + "; per token (ms) "
            + ", ".join(f"{k} {f(v)}"
                        for k, v in t["added_per_token_ms_p50"].items())
            + f"; {card}")


def _front_balanced(unary, timeout: float = 30.0):
    """Poll the replica's ``stats`` until no sequence is active and every
    page is free or held by the prefix cache alone; returns the stats."""
    deadline = time.time() + timeout
    while True:
        st = unary("stats")
        cached = (st["prefix_cache"] or {}).get("pages", 0)
        if (st["active_seqs"] == 0 and st["shared_pages"] == 0
                and st["free_pages"] + cached == st["total_pages"]):
            return st
        check(time.time() < deadline,
              f"the replica's pages are not balanced: {st['free_pages']} "
              f"free + {cached} cached of {st['total_pages']}, "
              f"{st['active_seqs']} active, {st['shared_pages']} shared")
        time.sleep(0.1)


def _front_b1(torch, rt, serve, seed: int, dev, card: str):
    """(a): the b1 app through ``llm_app``; see ``phase_serve_front``."""
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.serve.engine import (_MODEL_BUILDERS, EngineConfig,
                                            InferenceEngine, random_lora)

    cpu = dev == "cpu"
    model = "tiny" if cpu else "b1"
    cfg = _MODEL_BUILDERS[model]()
    cap = 128 if cpu else 512
    ecfg = dict(batch_slots=8, page_size=16, max_prompt_len=cap)
    rank = EngineConfig(**ecfg).lora_rank
    new = 32
    t = time.perf_counter()
    handle = serve.run(serve.llm_app(
        model=model, engine=ecfg, adapters={"a1": 1, "a2": 2}, device=dev),
        timeout=600)
    out = {"model": model, "start_s": time.perf_counter() - t}
    port = serve.start_http()

    def unary(method, *args):
        return handle.options(method_name=method).remote(*args).result(
            timeout=600)

    # The weights the replica built from the seed, against the driver's.
    params = llama_init(cfg, torch.Generator(device="cpu" if cpu else "cuda")
                        .manual_seed(seed), dev)
    sums = _rt_checksums(params)
    got_sums = unary("weight_checksums")
    diff = [n for n in sums if got_sums.get(n) != sums[n]]
    check(set(got_sums) == set(sums) and not diff,
          f"the replica's {model} weights differ from the driver's: "
          f"{diff[:5]}")
    n_params = sum(p.numel() for p in params.parameters())
    # The cold pass (a fresh replica) and a warm one on fresh prompts (the
    # prefix cache would serve the same prompts from their cached pages).
    passes = {"cold": _front_prompts(cfg, seed, cap),
              "warm": _front_prompts(cfg, seed + 1, cap)}
    streams = {None: handle.options(stream=True),
               "a1": handle.options(stream=True, multiplexed_model_id="a1")}

    def submitter(prompts):
        def submit(i, rec):
            job = _FRONT_JOBS[i]
            if job["via"] == "handle":
                _front_handle(streams[job.get("mux")], prompts[i], new,
                              job.get("cancel", False), rec)
            else:
                body = {"prompt_tokens": prompts[i], "max_new_tokens": new}
                if job.get("adapter"):
                    body["adapter"] = job["adapter"]
                _front_sse(port, "llm", body, rec)
        return submit

    # -- the main path: the cold pass, an ObjectRef adapter, the warm pass
    before = unary("stats")["kernel_launches"]
    runs = {}
    prompts, n_first = passes["cold"]
    runs["cold"] = _front_mix(len(_FRONT_JOBS), n_first, submitter(prompts))
    i_mux = next(i for i, j in enumerate(_FRONT_JOBS) if j.get("mux"))
    ref = rt.put(random_lora(cfg, 1, rank=rank, device=dev))
    unary("load_adapter", "a1_store", ref)
    via_store = [int(t) for t in streams[None].remote(
        prompts[i_mux], new, adapter="a1_store")]
    st = _front_balanced(unary)
    check(st["cancelled"] >= 1, f"no request was cancelled: {st}")
    cold_recs = runs["cold"][0]
    check(via_store == cold_recs[i_mux]["tokens"],
          f"the adapter read from the object store streamed {via_store}, "
          f"the same adapter registered directly "
          f"{cold_recs[i_mux]['tokens']}")
    prompts, n_first = passes["warm"]
    runs["warm"] = _front_mix(len(_FRONT_JOBS), n_first, submitter(prompts))
    st = _front_balanced(unary)
    out["launches"] = {k: v - before[k]
                       for k, v in st["kernel_launches"].items()}

    # -- the in-process engine: the same requests one at a time ----------
    engine = InferenceEngine(cfg, params, EngineConfig(**ecfg), seed=seed,
                             device=dev)
    try:
        for name, s in (("a1", 1), ("a2", 2)):
            engine.register_adapter(name, random_lora(cfg, s, rank=rank,
                                                      device=dev))
        want = {name: [list(engine.submit(
            p, max_new_tokens=new,
            adapter=job.get("mux") or job.get("adapter")))
            for p, job in zip(passes[name][0], _FRONT_JOBS)]
            for name in passes}
    finally:
        engine.shutdown()
    del engine, params
    for name, (recs, wall) in runs.items():
        for i, (r, w, job) in enumerate(zip(recs, want[name], _FRONT_JOBS)):
            got = r["tokens"]
            if job.get("cancel"):
                check(len(got) == _FRONT_CANCEL_AT and got == w[:len(got)],
                      f"{name} pass: the cancelled request {i} streamed "
                      f"{got}, expected {_FRONT_CANCEL_AT} tokens of {w}")
            else:
                check(got == w, f"{name} pass: request {i} ({job}) "
                                f"streamed {got}, the in-process engine "
                                f"{w}")
        spans = _front_spans(rt, [r["trace_id"] for r in recs])
        out[name] = _front_timing(recs, _FRONT_JOBS, spans,
                                  passes[name][1], wall)
    out.update(params=n_params,
               prompt_lens=[len(p) for p in passes["cold"][0]],
               new_tokens=new, tokens_equal=True, store_adapter_equal=True,
               pages_balanced=True, cancelled=st["cancelled"],
               prefix_cache_pages=(st["prefix_cache"] or {}).get("pages"))
    print(f"[serve-front] b1 app (llm_app(model={model!r}), "
          f"{n_params / 1e9:.3f} B parameters, one replica granted "
          f"{'no card' if cpu else 'the card'}) ready in "
          f"{out['start_s']:.1f} s (serve.run: worker start, torch import, "
          f"CUDA start and weights); weights equal to the driver's by "
          f"{len(sums)} fp64 checksums; in each of two passes 6 requests "
          f"through the handle and 6 as SSE (one by multiplexed_model_id, "
          f"one by adapter=, one cancelled after {_FRONT_CANCEL_AT} "
          f"tokens) equal token for token to an in-process engine's; the "
          f"adapter from the object store streamed the same tokens as the "
          f"one registered directly; pages balanced after the cancels "
          f"({st['free_pages']} free + {out['prefix_cache_pages']} cached "
          f"of {st['total_pages']}); launches in the replica "
          f"{out['launches']}", flush=True)
    for name in runs:
        print(_front_line(f"b1 app, {name} pass", out[name], card),
              flush=True)
    serve.delete("llm")
    return out


def _front_8b(torch, rt, serve, seed: int, dev, card: str, ref, serve_ref):
    """(b): Llama-3-8B through ``serve.deployment``; see
    ``phase_serve_front``."""
    from ray_tpu_torch.models.llama import LlamaConfig

    cpu = dev == "cpu"
    model = "tiny" if cpu else "llama3_8b"
    cfg = (LlamaConfig.tiny(dtype=torch.float32) if cpu
           else LlamaConfig.llama3_8b())
    cap = 128 if cpu else 512
    # phase_serve's engine.
    ecfg = dict(batch_slots=8, page_size=16, max_prompt_len=cap,
                max_new_tokens_cap=64, prefix_cache=False)
    new = 32
    dep = serve.deployment(
        name="llm8b",
        ray_actor_options=None if cpu else {"num_gpus": 1})(_Front8B)
    t = time.perf_counter()
    handle = serve.run(dep.bind(seed, ecfg, model, dev), name="llm8b",
                       timeout=600)
    out = {"model": model, "start_s": time.perf_counter() - t}

    def unary(method, *args):
        return handle.options(method_name=method).remote(*args).result(
            timeout=600)

    info = unary("stats")
    out.update(init_s=info["init_s"], visible=info["visible"])
    check(cpu or info["visible"] == "0",
          f"the 8B replica saw CUDA_VISIBLE_DEVICES={info['visible']!r}")
    prompts, n_first = _front_prompts(cfg, seed, cap)
    stream = handle.options(stream=True)
    jobs = [{"via": "handle"}] * len(prompts)
    unary("reset_counts")
    runs = {name: _front_mix(
        len(prompts), n_first,
        lambda i, rec: _front_handle(stream, prompts[i], new, False, rec))
        for name in ("cold", "warm")}
    out["launches"] = unary("stats")["kernel_launches"]
    # The same mix in the replica's process with no front (not the main
    # path: its launches are not counted): the engine's own pace there.
    local = unary("local_mix", prompts, n_first, new)
    st = _front_balanced(unary)
    bad = [i for i, (g, w) in enumerate(zip(local.pop("tokens"), ref))
           if g != w]
    check(not bad, f"the mix served inside the 8B replica differs from "
                   f"the in-process engine's on requests {bad}")
    out["in_replica"] = local
    greedy = []
    if serve_ref is not None:
        toks, temps = serve_ref
        greedy = [i for i, tp in enumerate(temps) if tp == 0.0]
    for name, (recs, wall) in runs.items():
        got = [r["tokens"] for r in recs]
        bad = [i for i, (g, w) in enumerate(zip(got, ref)) if g != w]
        check(not bad, f"{name} pass: the 8B deployment's greedy tokens "
                       f"differ from the in-process engine's on requests "
                       f"{bad}")
        bad = [i for i in greedy if got[i] != toks[i]]
        check(not bad, f"{name} pass: the 8B deployment's tokens differ "
                       f"from phase_serve's on its greedy requests {bad}")
        spans = _front_spans(rt, [r["trace_id"] for r in recs])
        out[name] = _front_timing(recs, jobs, spans, n_first, wall)
    out.update(tokens_equal=True, serve_greedy_equal=len(greedy),
               free_pages=st["free_pages"], total_pages=st["total_pages"])
    print(f"[serve-front] 8B deployment ({model}, serve.deployment with "
          f"ray_actor_options={None if cpu else {'num_gpus': 1}}, "
          f"CUDA_VISIBLE_DEVICES={info['visible']!r}) ready in "
          f"{out['start_s']:.1f} s (its weights and engine "
          f"{out['init_s']:.1f} s of that); in each of two passes 12 greedy "
          f"requests streamed through the handle equal token for token to "
          f"the in-process engine's one at a time"
          + (f" and to phase_serve's {len(greedy)} greedy requests"
             if greedy else "")
          + f"; launches in the replica {out['launches']}", flush=True)
    for name in runs:
        print(_front_line(f"8B deployment, {name} pass", out[name], card),
              flush=True)
    print(f"[serve-front] the same mix inside the 8B replica with no front: "
          f"{local['tokens_per_s']:.1f} tokens/s, the engine's inter-token "
          f"p50 {local['itl_p50_ms']:.2f} ms, TTFT p50 / max "
          f"{local['ttft_p50_ms']:.1f} / {local['ttft_max_ms']:.1f} ms; "
          f"{card}", flush=True)
    serve.delete("llm8b")
    return out


def phase_serve_front(torch, report, seed: int, card: str, dev=None):
    """The serving front on the card: (a) the b1 app through
    ``serve.run(serve.llm_app(model="b1", ...))`` and (b) a Llama-3-8B
    deployment through ``serve.deployment``, one GPU replica at a time;
    see the module docstring's phase list.  ``dev="cpu"`` rehearses it on
    the CPU with the tiny model in both (the reference tokens of (b) then
    come from an in-process engine).  gRPC is not driven here: ``grpcio``
    is not known to be installed on the card's machine, and the ingress
    runs no device code; the CPU tests hold it against the JAX
    package's."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    cpu = dev == "cpu"
    out = {"card": card}
    check(cpu or "RT_GPUS" not in os.environ,
          "the GPU count must come from autodetection, not RT_GPUS")
    rt.init(num_cpus=4)
    try:
        res = rt.cluster_resources()
        out["resources"] = res
        check(cpu or res.get("GPU") == 1.0,
              f"autodetected GPU resource {res.get('GPU')}, expected 1")
        out["b1"] = _front_b1(torch, rt, serve, seed, dev, card)
        if cpu:
            ref, serve_ref = _front_ref_cpu(torch, seed), None
        else:
            ref = report["runtime"]["serve"]["tokens"]
            serve_ref = (report["serve"]["tokens"],
                         report["serve"]["temperatures"])
        out["8b"] = _front_8b(torch, rt, serve, seed, dev, card, ref,
                              serve_ref)
    finally:
        serve.stop_http()
        serve.shutdown()
        rt.shutdown()
    out["launches"] = {k: out["b1"]["launches"][k] + out["8b"]["launches"][k]
                       for k in out["b1"]["launches"]}
    c = out["launches"]
    check(cpu or (c["flash_fwd"] > 0 and c["rms_norm"] > 0
                  and c["flash_bwd_dq"] == c["flash_bwd_dkv"] == 0
                  and c["rms_norm_bwd"] == 0),
          f"the replicas did not launch K1 and K4's forward (and K2, K3 and "
          f"K4's backward never): {c}")
    report["serve_front"] = out


def _front_ref_cpu(torch, seed: int):
    """The CPU rehearsal's reference for (b): the tiny model's greedy
    tokens from an in-process engine, one request at a time."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_init(cfg, torch.Generator().manual_seed(seed), "cpu")
    engine = InferenceEngine(cfg, params, EngineConfig(
        batch_slots=8, page_size=16, max_prompt_len=128,
        max_new_tokens_cap=64, prefix_cache=False), seed=seed, device="cpu")
    try:
        prompts, _ = _front_prompts(cfg, seed, 128)
        return [r["tokens"] for r in _rt_serve(engine, prompts, 32)]
    finally:
        engine.shutdown()


def _serve_all(engine, jobs, new: int):
    """Submit ``jobs`` ([(prompt, adapter)]) at once, each consumed on its
    own thread; returns [(tokens, ttft_s)] in job order and raises on any
    stream error or a stream that does not finish."""
    results = [None] * len(jobs)
    errors = []

    def consume(i, stream):
        try:
            results[i] = (list(stream), stream.ttft_s)
        except Exception as e:  # noqa: BLE001: reported below
            errors.append((i, repr(e)))

    threads = []
    for i, (prompt, adapter) in enumerate(jobs):
        s = engine.submit(prompt, max_new_tokens=new, adapter=adapter)
        threads.append(threading.Thread(target=consume, args=(i, s)))
        threads[-1].start()
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "a stream did not finish in 600 s")
    check(not errors, f"stream errors: {errors}")
    return results


def _balanced(engine) -> bool:
    """Clear the prefix cache; True once every page is free again."""
    deadline = time.time() + 10
    while time.time() < deadline:
        engine.clear_prefix_cache()
        alloc = engine.allocator
        if alloc.free_count == alloc.total and alloc.shared_count == 0:
            return True
        time.sleep(0.05)
    return False


def _program_calls(paged):
    """Calls of the three programs that launch kernels."""
    return {n: paged.call_count(n)
            for n in ("decode", "prefill", "prefill_prefix")}


def phase_multitenant(torch, report, cfg, params, seed: int):
    """The multi-tenant plane on the card: the radix prefix cache (suffix
    prefill through K1 at ``q_offset = prefix_len``, copy-on-write on a
    mid-page divergence) and the LoRA adapter pool, first on the tiny
    model in fp32 against the same engine on the CPU, then on full
    Llama-3-8B in bf16; and K1 timed at a suffix-prefill shape."""
    out = {"tiny": _multitenant_tiny(torch, seed)}
    out["llama3_8b"] = _multitenant_8b(torch, cfg, params, seed)
    out["k1_suffix"] = _time_k1_suffix(torch)
    out["launches"] = {
        k: out["tiny"]["launches"][k] + out["llama3_8b"]["launches"][k]
        for k in out["tiny"]["launches"]}
    report["multitenant"] = out


def _multitenant_tiny(torch, seed: int):
    """(a) The tiny model in fp32, prefix cache on, two adapters and the
    base model: a 48-token shared prefix with six tails and one fork that
    diverges inside its second page, served on the card and on the CPU by
    the same script; the greedy tokens must be equal."""
    from ray_tpu_torch.models import paged
    from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
    from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                            random_lora)

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = llama_init(cfg, torch.Generator(device="cuda")
                        .manual_seed(seed + 5))
    cpu_params = Llama(cfg, torch.device("cpu"))
    cpu_params.load_state_dict(params.state_dict())
    ecfg = EngineConfig(batch_slots=4, page_size=16, max_prompt_len=128,
                        max_new_tokens_cap=16, max_adapters=2, lora_rank=4)
    loras = {f"t{s}": random_lora(cfg, seed + s, rank=4, device="cpu")
             for s in (1, 2)}
    rng = np.random.default_rng(seed + 5)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in (3, 9, 14, 5, 11, 7)]
    names = [None, "t1", "t2", None, "t1", "t2"]
    jobs = [(np.concatenate([prefix, t]).astype(np.int32), a)
            for t, a in zip(tails, names)]
    # The fork shares 20 tokens: a copy-on-write inside the second page.
    jobs.append((np.concatenate([prefix[:20], rng.integers(
        0, cfg.vocab_size, 30)]).astype(np.int32), None))
    new = 16

    def script(engine):
        """Primers (one per adapter: cold), then the other four (all hit),
        then all seven again (all hit): the cache's content, and so each
        request's path, does not depend on timing."""
        for name, lora in loras.items():
            engine.register_adapter(name, lora)
        got = _serve_all(engine, jobs[:3], new)
        got += _serve_all(engine, jobs[3:], new)
        again = _serve_all(engine, jobs, new)
        stats = engine.stats()
        return ([t for t, _ in got], [t for t, _ in again], stats,
                _balanced(engine))

    traces0 = paged.trace_count("decode")
    calls0 = _program_calls(paged)
    _reset_counts()
    engine = InferenceEngine(cfg, params, ecfg, seed=seed)
    try:
        got, again, stats, balanced = script(engine)
    finally:
        engine.shutdown()
    torch.cuda.synchronize()
    counts = _read_counts()
    calls = {k: v - calls0[k] for k, v in _program_calls(paged).items()}
    decode_traces = paged.trace_count("decode") - traces0
    engine = InferenceEngine(cfg, cpu_params, ecfg, seed=seed, device="cpu")
    try:
        want, want_again, _, _ = script(engine)
    finally:
        engine.shutdown()
    same = sum(int(a == b) for g, w in zip(got + again, want + want_again)
               for a, b in zip(g, w))
    hits = stats["prefix_hits"]
    L = cfg.n_layers
    print(f"[multitenant] tiny fp32: {len(jobs)} requests (48-token shared "
          f"prefix, a fork inside page 2, base + 2 adapters) twice, "
          f"{same}/{2 * len(jobs) * new} tokens equal to the CPU engine's, "
          f"second round equal to the first: {again == got}; "
          f"prefix hits {hits}, program calls {calls}, decode traces "
          f"{decode_traces}, free list balanced {balanced}; launches "
          f"{counts}")
    check(got == want and again == want_again,
          f"tiny multitenant on the card differs from the CPU: {got} "
          f"{again} vs {want} {want_again}")
    check(hits >= 5 and calls["prefill_prefix"] > 0,
          f"tiny multitenant: {hits} prefix hits, calls {calls}")
    check(decode_traces == 1, f"tiny multitenant: {decode_traces} decode "
                              f"signatures, expected 1")
    check(balanced, "tiny multitenant: pages leaked after "
                    "clear_prefix_cache()")
    check(counts["flash_fwd"] == L * (calls["prefill"]
                                      + calls["prefill_prefix"])
          and counts["rms_norm"] == (2 * L + 1) * sum(calls.values())
          and counts["rms_norm_bwd"] == 0,
          f"tiny multitenant launches {counts} do not match program calls "
          f"{calls}")
    return {"requests": 2 * len(jobs), "tokens_equal": same,
            "second_round_equal": again == got,
            "prefix_hits": hits, "program_calls": calls,
            "decode_traces": decode_traces, "launches": counts}


def _multitenant_8b(torch, cfg, params, seed: int):
    """(b) Full Llama-3-8B in bf16: a 384-token system prompt cached for
    the base model and two adapters, then 12 requests (tails of 16-100
    tokens, one diverging mid-page) x 32 greedy tokens served at once, all
    from the cache; then each prompt served alone from the cache and cold
    (cache cleared) for TTFT and the first tokens."""
    from ray_tpu_torch.models import paged
    from ray_tpu_torch.models.llama import llama_hidden
    from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                            random_lora)

    ecfg = EngineConfig(batch_slots=8, page_size=16, max_prompt_len=512,
                        max_new_tokens_cap=64, max_adapters=4, lora_rank=8)
    rng = np.random.default_rng(seed + 6)
    system = rng.integers(0, cfg.vocab_size, 384).astype(np.int32)
    names = [None, "a1", "a2"]
    tail_lens = (16, 40, 64, 100, 24, 77, 50, 90, 33, 58, 81, 20)
    jobs = []
    for i, n in enumerate(tail_lens):
        head = system[:200] if i == 7 else system  # 7: mid-page fork
        jobs.append((np.concatenate([head, rng.integers(
            0, cfg.vocab_size, n)]).astype(np.int32), names[i % 3]))
    base_idx, adapter_idx = 3, 4  # designated: base and adapter "a2"
    new = 32
    loras = {name: random_lora(cfg, seed + s, rank=8)
             for s, name in ((1, "a1"), (2, "a2"))}
    engine = InferenceEngine(cfg, params, ecfg, seed=seed)
    try:
        for name, lora in loras.items():
            engine.register_adapter(name, lora)
        engine.warmup()
        decode_traces0 = paged.trace_count("decode")
        # The system prompt cached under each adapter, as earlier traffic
        # of a shared deployment leaves it.
        _serve_all(engine, [(system, a) for a in names], 1)
        hits0 = engine.prefix_hits
        calls0 = _program_calls(paged)
        _reset_counts()
        t0 = time.perf_counter()
        mix = _serve_all(engine, jobs, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        calls = {k: v - calls0[k] for k, v in _program_calls(paged).items()}
        hits = engine.prefix_hits - hits0
        decode_traces = paged.trace_count("decode") - decode_traces0
        balanced = _balanced(engine)
        # Each prompt alone: from the cache (system prompt primed), then
        # cold (cache cleared).
        alone = []
        for prompt, adapter in jobs:
            engine.clear_prefix_cache()
            _serve_all(engine, [(system, adapter)], 1)
            (hit_toks, hit_ttft), = _serve_all(engine, [(prompt, adapter)],
                                               1)
            engine.clear_prefix_cache()
            (cold_toks, cold_ttft), = _serve_all(engine, [(prompt, adapter)],
                                                 new)
            alone.append((hit_toks[0], hit_ttft, cold_toks, cold_ttft))
        # One base request from the cache and cold under the profiler:
        # where its TTFT goes.
        prompt = jobs[base_idx][0]
        engine.clear_prefix_cache()
        _serve_all(engine, [(system, None)], 1)
        profiled = {}
        for how in ("cache", "cold"):
            kernels, wall_ms = profile_window(
                torch, lambda: _serve_all(engine, [(prompt, None)], 1),
                iters=1)
            profiled[how] = {"wall_ms": wall_ms,
                             "device_busy_ms": sum(kernels.values())}
            engine.clear_prefix_cache()
        check(_balanced(engine), "8B multitenant: pages leaked after the "
                                 "hit/cold runs")
        stats = engine.stats()
    finally:
        engine.shutdown()
    # The cold forward's top-2 logit margin at each prompt's first token:
    # how near a tie a first-token flip between the two paths sits.
    margins = []
    with torch.no_grad():
        for prompt, adapter in jobs:
            h = llama_hidden(cfg, params, torch.from_numpy(prompt).long()
                             [None].cuda(), loras.get(adapter))
            top = (h[0, -1] @ params.lm_head).float().topk(2).values
            margins.append(float(top[0] - top[1]))
    L = cfg.n_layers
    check(all(len(t) == new for t, _ in mix), "8B multitenant lost tokens")
    check(hits >= 10 and hits == len(jobs),
          f"8B multitenant: {hits} prefix hits of {len(jobs)}")
    check(calls["prefill"] == 0 and calls["prefill_prefix"] == len(jobs)
          and counts["flash_fwd"] == L * calls["prefill_prefix"]
          and counts["rms_norm"] == (2 * L + 1) * sum(calls.values())
          and counts["rms_norm_bwd"] == 0,
          f"8B multitenant: program calls {calls}, launches {counts}: K1 "
          f"and K4 must run on every prefill_prefix call")
    check(decode_traces == 0, f"8B multitenant: the mix added "
                              f"{decode_traces} decode signatures")
    check(balanced, "8B multitenant: pages leaked after "
                    "clear_prefix_cache()")
    agree = [sum(int(a == b) for a, b in zip(t, cold[2]))
             for (t, _), cold in zip(mix, alone)]
    first_mix = [int(t[0] == cold[2][0]) for (t, _), cold in zip(mix, alone)]
    first_alone = [int(h == c[0]) for h, _, c, _ in alone]
    ttft_hit = sorted(h for _, h, _, _ in alone)
    ttft_cold = sorted(c for _, _, _, c in alone)
    ttft_mix = sorted(t for _, t in mix)
    p50 = lambda v: v[len(v) // 2] * 1e3  # noqa: E731
    print(f"[multitenant] Llama-3-8B bf16: 12 requests x {new} tokens over "
          f"base + 2 adapters on a 384-token cached system prompt (one fork "
          f"at token 200): wall {wall:.2f} s, prefix hits {hits}, program "
          f"calls {calls}, decode signatures added {decode_traces}, free "
          f"list balanced {balanced}; launches {counts}")
    print(f"[multitenant] served alone, TTFT p50 from the cache "
          f"{p50(ttft_hit):.1f} ms vs cold {p50(ttft_cold):.1f} ms (the mix, "
          f"12 at once: p50 {p50(ttft_mix):.1f} ms); first tokens equal to "
          f"cold: mix {sum(first_mix)}/12, alone {sum(first_alone)}/12; mix "
          f"tokens equal to cold, per request: {agree}; the cold forward's "
          f"top-2 logit margins at the first token: "
          f"{[round(m, 4) for m in margins]}")
    print(f"[multitenant] one base request profiled (wall / device busy, "
          f"ms): from the cache {profiled['cache']['wall_ms']:.1f} / "
          f"{profiled['cache']['device_busy_ms']:.1f}, cold "
          f"{profiled['cold']['wall_ms']:.1f} / "
          f"{profiled['cold']['device_busy_ms']:.1f}")
    for what, i in (("base", base_idx), ("adapter a2", adapter_idx)):
        check(first_mix[i] == 1,
              f"8B multitenant: the designated {what} request's first "
              f"token from the cache {mix[i][0][0]} differs from the cold "
              f"serving's {alone[i][2][0]}")
    return {"requests": len(jobs), "wall_s": wall, "prefix_hits": hits,
            "program_calls": calls, "decode_traces_added": decode_traces,
            "launches": counts, "ttft_hit_p50_ms": p50(ttft_hit),
            "ttft_cold_p50_ms": p50(ttft_cold),
            "ttft_mix_p50_ms": p50(ttft_mix),
            "ttft_hit_ms": [t * 1e3 for t in ttft_hit],
            "ttft_cold_ms": [t * 1e3 for t in ttft_cold],
            "first_token_equal_mix": first_mix,
            "first_token_equal_alone": first_alone,
            "tokens_equal_to_cold": agree,
            "first_token_margins": margins, "profiled": profiled,
            "prefix_cache": stats["prefix_cache"],
            "adapters": stats["adapters"]}


def _time_k1_suffix(torch):
    """K1 at one suffix-prefill shape of the 8B serve config: a 64-row
    suffix bucket at q_offset 384 over the gathered table (Sk = MAXP x 16
    = 576), beside the plain version and SDPA.  SDPA's ``is_causal``
    aligns the mask top-left when Sq != Sk, so SDPA takes an explicit
    boolean mask."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    B, H, Hkv, Sq, Sk, D, off = 1, 32, 8, 64, 576, 128, 384
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = _attn_inputs(torch, g, B, H, Hkv, Sq, Sk, D, torch.bfloat16)
    out, _ = att.flash_attention_fwd(q, k, v, causal=True, q_offset=off)
    ref, _ = att.flash_attention_ref(q, k, v, causal=True, q_offset=off)
    mask = (torch.arange(Sk, device="cuda")[None, :]
            <= torch.arange(Sq, device="cuda")[:, None] + off)
    lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    kern = lambda: att.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=True, q_offset=off)
    plain = lambda: att.flash_attention_ref(  # noqa: E731
        q, k, v, causal=True, q_offset=off)
    # The visited work: row r sees keys 0 .. off + r; keys past the last
    # row's position are never read.
    pairs = Sq * (off + 1) + Sq * (Sq - 1) // 2
    keys = min(Sk, off + Sq)
    flops = 4 * B * H * D * pairs
    nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * keys * D) * 2 + B * H * Sq * 4
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    rec = {
        "shape": dict(B=B, H=H, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, q_offset=off,
                      causal=True, dtype="bfloat16"),
        "max_abs_err": float((out.float() - ref.float()).abs().max()),
        "sdpa_max_abs_diff": float((lib_fn().float() - ref.float())
                                   .abs().max()),
        "call_ms": time_ms(torch, kern),
        "ms": device_ms(torch, kern),
        "plain_ms": device_ms(torch, plain, iters=3),
        "library_ms": device_ms(torch, lib_fn),
        "library": "SDPA, explicit boolean mask, enable_gqa",
        "bound_ms": max(by_ops, by_bytes) * 1e3,
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
    print("[K1 suffix] " + json.dumps(rec))
    return rec


# Kernel-name patterns of a train step's device time, by kind.
_STEP_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel", "flash_fwd_fma_kernel")),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_fma_kernel")),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                          "flash_bwd_dkv_fma_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("AdamW (fused)", ("multi_tensor_apply", "fused_adam")),
    ("K4 rms_norm (forward and backward)", ("rms_norm_kernel",
                                            "rms_norm_bwd_kernel",
                                            "rms_norm_dw_kernel")),
)


def _train_launches(L: int, steps: int, policy: str = "full"):
    """Launches of each kernel in ``steps`` train steps of an L-layer model
    under ``remat_policy``.  ``full``, ``save_dots`` and
    ``save_dots_no_batch``: a block's forward (attention, two norms) runs
    twice (forward and recompute), its backward once; ``save_attn`` keeps
    the attention's residuals, so K1 runs once; with no checkpoint
    (``xla_cse``, ``cse_save_attn``) K1 and the norms run once.  The final
    norm runs once each way.  The MoE block remats in full."""
    k1 = 1 if policy in ("save_attn", "xla_cse", "cse_save_attn") else 2
    k4 = 2 if policy in ("xla_cse", "cse_save_attn") else 4
    return {"flash_fwd": k1 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps, "rms_norm": (k4 * L + 1) * steps,
            "rms_norm_bwd": (2 * L + 1) * steps}


_OTHER = "other (elementwise, reductions, copies)"


def _kind_of(name: str) -> str:
    return next((k for k, pats in _STEP_KINDS
                 if any(pat in name for pat in pats)), _OTHER)


def _by_kind(kernels):
    """{kind: device ms} of {kernel name: device ms}, by name pattern."""
    out = {}
    for name, ms in kernels.items():
        kind = _kind_of(name)
        out[kind] = out.get(kind, 0.0) + ms
    return out


def phase_train(torch, report, seed: int, steps: int = 5):
    """AdamW train steps on full Llama-3-8B (B=1, S=2048), as bench.py
    drives the JAX package: 2 warm steps, then ``steps`` timed ones."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)

    cfg = LlamaConfig.llama3_8b()
    B, S = 1, 2048
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = llama_init(cfg, gen, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    tx = default_optimizer(lr=1e-4)
    state = TrainState.create(params, tx)
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    metrics = []
    for _ in range(2):  # warm: optimizer state, cuBLAS heuristics
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels, prof_wall_ms = profile_window(torch, lambda: step(state, batch),
                                           iters=1)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    by_kind = _by_kind(kernels)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    L = cfg.n_layers
    tokens_per_s = B * S / step_s
    # bench.py's convention: 6N + 6 L S d model flops per token, remat
    # excluded, against the H100's dense bf16 peak.
    flops_per_token = 6 * n_params + 6 * L * S * cfg.d_model
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    print(f"[train] Llama-3-8B {n_params / 1e9:.2f}B params ({L} layers, "
          f"bf16, remat full) B={B} S={S}: step {step_s * 1e3:.1f} ms, "
          f"{tokens_per_s:.1f} tokens/s, MFU {mfu:.4f}; peak memory "
          f"{peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(x, 4) for x in norms]}; launches {counts}")
    print(f"[train] profiled step: device busy {busy_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}); by kind (ms): "
          + "; ".join(f"{k} {t:.1f}" for k, t in sorted(
              by_kind.items(), key=lambda kv: -kv[1]))
          + "; top kernels (ms): "
          + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    check(counts == _train_launches(L, steps),
          f"train launches {counts}, expected {_train_launches(L, steps)} "
          f"(K1 and K4's forward in the forward and the remat recompute, "
          f"K2, K3 and K4's backward once, the final norm once each way)")
    report["train"] = {
        "params_b": n_params / 1e9, "layers": L, "batch": B, "seq": S,
        "steps": steps, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens_per_s, "mfu": mfu, "peak_gb": peak_gb,
        "losses": losses, "grad_norms": norms, "launches": counts,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / prof_wall_ms,
        "by_kind_ms": by_kind, "top_kernels_ms": dict(top)}
    return cfg, tokens, state


def phase_train_check(torch, report, cfg, tokens, seed: int):
    """Two layers at full width: loss and every gradient in bf16 on the
    card (K1-K4, K4 both ways) against the same weights in fp32 on the CPU
    through the plain path (the kernels' plain versions), B=1, S=256."""
    from ray_tpu_torch.models.llama import Llama, llama_init, llama_loss

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = llama_init(cfg2, torch.Generator(device="cuda")
                        .manual_seed(seed + 3), trainable=True)
    tok = tokens[:, :256]
    tgt = torch.roll(tok, -1, dims=1)
    _reset_counts()
    loss = llama_loss(cfg2, params, tok, tgt)
    loss.backward()
    loss = float(loss.detach())
    counts = _read_counts()
    check(counts == _train_launches(2, 1),
          f"train check launches {counts}, expected "
          f"{_train_launches(2, 1)}")
    got = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
    cpu = Llama(dataclasses.replace(cfg2, dtype=torch.float32, remat=False),
                torch.device("cpu"))
    cpu.load_state_dict(params.state_dict())
    del params
    cpu.requires_grad_(True)
    t0 = time.perf_counter()
    ref = llama_loss(cpu.config, cpu, tok.cpu(), tgt.cpu())
    ref.backward()
    ref = float(ref.detach())
    cpu_s = time.perf_counter() - t0
    rel = {n: float((got[n] - p.grad).norm() / p.grad.norm())
           for n, p in cpu.named_parameters()}
    loss_rel = abs(loss - ref) / abs(ref)
    # bf16 against fp32: every activation, weight and gradient is rounded
    # to bf16 (unit roundoff 2^-8 = 0.4 %) at each of the ~20 ops of a
    # layer's forward and backward, and the weight gradients are summed
    # over 256 tokens; the relative norm error of each gradient is expected
    # at 1-2 %, and 5 % is the bound.  The loss is one fp32 reduction of
    # bf16 logits: 1 %.
    grad_tol, loss_tol = 5e-2, 1e-2
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"[train-check] 2-layer full-width S=256 vs fp32 CPU plain path "
          f"({cpu_s:.1f} s): loss {loss:.5f} vs {ref:.5f} "
          f"(rel {loss_rel:.3g}, tol {loss_tol}); gradient rel norm err over "
          f"{len(rel)} tensors, worst: "
          + ", ".join(f"{n} {e:.4g}" for n, e in worst)
          + f" (tol {grad_tol})")
    check(loss_rel <= loss_tol and max(rel.values()) <= grad_tol,
          f"train path disagrees with the fp32 CPU reference: loss rel "
          f"{loss_rel}, gradient rel {dict(worst)}")
    report["train_check"] = {"loss": loss, "ref_loss": ref,
                             "loss_rel": loss_rel, "grad_rel": rel,
                             "grad_tol": grad_tol, "loss_tol": loss_tol,
                             "launches": counts}


# full first: the others' reference in the same phase.
_POLICIES = ("full", "save_attn", "save_dots", "save_dots_no_batch",
             "xla_cse")


def _act_bytes(cfg, tokens: int, policy: str) -> int:
    """Bytes one Llama layer keeps for the backward under ``policy`` at
    ``tokens`` tokens: bf16 activations, K1's fp32 lse where the
    attention's residuals are kept, and (with no checkpoint) the fp32 RoPE
    upcasts of q and k that its multiplies save."""
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.head_dim
    qkv, lse = d + 2 * kv, 4 * cfg.n_heads
    kept = {  # bytes a token, the block's input first
        "full": 2 * d,
        "save_attn": 2 * (d + qkv + d) + lse,        # rotated q/k/v, out
        "save_dots": 2 * (d + qkv + d + 2 * f + d),  # every product
        # x, h, rotated q/k/v, out, merged heads, x1, h2, w1 and w3
        # outputs, silu, their product; RoPE's fp32 q and k
        "xla_cse": 2 * (6 * d + qkv + 4 * f) + 4 * (d + kv) + lse,
    }
    kept["save_dots_no_batch"] = kept["save_dots"]
    kept["cse_save_attn"] = kept["xla_cse"]
    return tokens * kept[policy]


def _reckon_peak(cfg, tokens: int, policy: str, layer_params: int,
                 other_params: int) -> float:
    """Bytes a train step of ``cfg`` peaks at, reckoned before running it:
    the bf16 parameters and AdamW moments, the gradients outside the
    layers, and per layer the larger of what it keeps for the backward and
    its gradients (a layer's activations are freed as its gradients are
    made)."""
    L = cfg.n_layers
    state = 3 * 2 * (L * layer_params + other_params)
    return (state + 2 * other_params
            + L * max(_act_bytes(cfg, tokens, policy), 2 * layer_params))


def _remat_steps(torch, cfg, policy, state, batch, steps, layer_params,
                 other_params):
    """1 warm and ``steps`` timed AdamW steps of ``state`` under
    ``policy``: step time, MFU, peak memory beside the reckoned peak, and
    the launches checked against the policy's; then one step under the
    profiler (idle share, time by kernel kind)."""
    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.models.train_state import (default_optimizer,
                                                  make_train_step)

    B, S = batch["tokens"].shape
    L = cfg.n_layers
    c = dataclasses.replace(cfg, remat_policy=policy)
    reckoned = _reckon_peak(c, B * S, policy, layer_params, other_params)
    step = make_train_step(
        lambda p, b: llama_loss(c, p, b["tokens"], b["targets"]),
        default_optimizer(lr=1e-4))
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    _reset_counts()
    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    clock = clocks_line()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    # A retry frees the allocator's cached blocks: a device-wide sync.
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries
    clock = f"{clock} before, {clocks_line()} after"
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in metrics]
    kernels, prof_wall_ms = profile_window(torch, lambda: step(state, batch),
                                           iters=1)
    busy_ms = sum(kernels.values())
    by_kind = _by_kind(kernels)
    n_params = L * layer_params + other_params
    tokens_per_s = B * S / step_s
    mfu = (tokens_per_s * (6 * n_params + 6 * L * S * cfg.d_model)
           / PEAK_BF16_FLOPS)
    want = _train_launches(L, steps, policy)
    print(f"[remat] {policy}: {L} layers, step {step_s * 1e3:.1f} ms, "
          f"{tokens_per_s:.1f} tokens/s, MFU {mfu:.4f}, peak "
          f"{peak_gb:.2f} GB (reckoned {reckoned / 1e9:.2f}); losses "
          f"{[round(x, 4) for x in losses]}; launches {counts}; allocator "
          f"retries {retries}; SM clock {clock}; profiled "
          f"step: busy {busy_ms:.1f} ms of {prof_wall_ms:.1f} ms (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}), by kind (ms): "
          + "; ".join(f"{k} {t:.1f}" for k, t in sorted(
              by_kind.items(), key=lambda kv: -kv[1])), flush=True)
    check(all(np.isfinite(losses)), f"{policy}: non-finite loss {losses}")
    check(counts == want, f"{policy}: launches {counts}, expected {want}")
    return {"layers": L, "step_ms": step_s * 1e3, "mfu": mfu,
            "tokens_per_s": tokens_per_s, "peak_gb": peak_gb,
            "reckoned_peak_gb": reckoned / 1e9, "losses": losses,
            "launches": counts, "alloc_retries": retries, "sm_clock": clock,
            "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / prof_wall_ms, "by_kind_ms": by_kind}


def _remat_sizes(cfg, params):
    """(parameters of one layer, parameters outside the layers)."""
    layer = sum(p.numel() for p in params.layers[0].parameters())
    total = sum(p.numel() for p in params.parameters())
    return layer, total - len(params.layers) * layer


def _fits(torch, cfg, tokens, policy, layer_params, other_params) -> bool:
    budget = torch.cuda.get_device_properties(0).total_memory - 4e9
    return _reckon_peak(cfg, tokens, policy, layer_params,
                        other_params) <= budget


def phase_remat(torch, report, cfg, state, tokens, steps: int = 3):
    """Each remat policy on the train phase's Llama-3-8B model and
    optimizer state (B=1, S=2048), ``full`` first as the others'
    reference, when its reckoned peak fits the card at that depth.
    Returns the policies that do not fit, for ``phase_remat_shallow``."""
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    sizes = _remat_sizes(cfg, state.params)
    out, deferred = {}, []
    for policy in _POLICIES:
        if _fits(torch, cfg, tokens.numel(), policy, *sizes):
            out[policy] = _remat_steps(torch, cfg, policy, state, batch,
                                       steps, *sizes)
        else:
            deferred.append(policy)
    report["remat"] = out
    return deferred


def phase_remat_shallow(torch, report, cfg, tokens, deferred, seed: int,
                        steps: int = 3):
    """Each policy ``phase_remat`` deferred, on a fresh model at the
    deepest depth whose reckoned peak fits (the shared state freed
    first); then the launches of the whole remat path."""
    from ray_tpu_torch.models.llama import Llama, llama_init
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer)

    out = report["remat"]
    sizes = _remat_sizes(cfg, Llama(dataclasses.replace(cfg, n_layers=1),
                                    torch.device("meta")))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    for policy in deferred:
        L = max(n for n in range(1, cfg.n_layers + 1) if _fits(
            torch, dataclasses.replace(cfg, n_layers=n), tokens.numel(),
            policy, *sizes))
        print(f"[remat] {policy} does not fit {cfg.n_layers} layers; "
              f"running {L}", flush=True)
        c = dataclasses.replace(cfg, n_layers=L)
        params = llama_init(c, torch.Generator(device="cuda")
                            .manual_seed(seed + 2), trainable=True)
        state = TrainState.create(params, default_optimizer(lr=1e-4))
        out[policy] = _remat_steps(torch, c, policy, state, batch, steps,
                                   *sizes)
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(out[p]["launches"][k] for p in _POLICIES)
                       for k in _counters()}


def phase_remat_check(torch, report, cfg, tokens, seed: int):
    """Two layers of Llama-3-8B (B=1, S=2048): under every policy the loss
    and every gradient against ``full``'s on the same batch, and one step's
    launches against the policy's."""
    from ray_tpu_torch.models.llama import _REMAT, llama_init, llama_loss

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = llama_init(cfg2, torch.Generator(device="cuda")
                        .manual_seed(seed + 4), trainable=True)
    tgt = torch.roll(tokens, -1, dims=1)
    ref, out = None, {}
    # The policies run the same kernels on the same values: bit-identical
    # results are expected; 2^-8 (one bf16 rounding) in relative norm
    # would be allowed where a kept tensor were summed in another order.
    tol = 2.0 ** -8
    for policy in ["full"] + [p for p in _REMAT if p != "full"]:
        c = dataclasses.replace(cfg2, remat_policy=policy)
        _reset_counts()
        loss = llama_loss(c, params, tokens, tgt)
        loss.backward()
        loss = loss.detach()
        counts = _read_counts()
        check(counts == _train_launches(2, 1, policy),
              f"{policy}: launches {counts}, expected "
              f"{_train_launches(2, 1, policy)}")
        grads = {n: p.grad for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        if ref is None:
            ref = (loss, grads)
            continue
        identical = bool(torch.equal(loss, ref[0])) and all(
            torch.equal(g, ref[1][n]) for n, g in grads.items())
        rel = max(float((g.float() - ref[1][n].float()).norm()
                        / ref[1][n].float().norm()) for n, g in grads.items())
        loss_rel = abs(float(loss) - float(ref[0])) / abs(float(ref[0]))
        print(f"[remat-check] {policy}: loss {float(loss):.6f} vs full "
              f"{float(ref[0]):.6f}; "
              + ("bit-identical to full" if identical else
                 f"worst gradient rel norm err {rel:.3g} (tol {tol:.3g})")
              + f"; launches {counts}", flush=True)
        check(identical or (rel <= tol and loss_rel <= tol),
              f"{policy} disagrees with full: loss rel {loss_rel}, "
              f"gradient rel {rel}")
        out[policy] = {"bit_identical": identical, "grad_rel": rel,
                       "loss_rel": loss_rel, "launches": counts}
    report["remat_check"] = out


# The MoE FFN's profiler ranges: (their GEMMs, the rest) by range.
_MOE_RANGES = {"moe.experts": ("expert GEMMs (bmm)",
                               "expert SwiGLU elementwise"),
               "moe.ffn": ("dispatch and combine products",
                           "routing, dispatch and combine glue (one-hots, "
                           "cumsum, softmax, casts)")}
_EVAL = "autograd::engine::evaluate_function: "


def _moe_profile(torch, step_fn):
    """One call of ``step_fn`` profiled with CPU and CUDA activity, with
    ``moe._moe_ffn`` and ``moe._experts`` under profiler ranges: {kind:
    device ms}.  A kernel goes to the innermost range around the op that
    launched it; else, when that op runs in an autograd node's evaluation
    (and is not itself a forward op: the remat recompute creates nodes),
    to the range the node's forward op ran in, matched by forward thread
    and sequence number; else to its kind by name (``_STEP_KINDS``, the
    GEMMs there being the dense projections and lm_head)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.models import moe

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    originals = (moe._moe_ffn, moe._experts)
    moe._moe_ffn = ranged("moe.ffn", moe._moe_ffn)
    moe._experts = ranged("moe.experts", moe._experts)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn()
            torch.cuda.synchronize()
    finally:
        moe._moe_ffn, moe._experts = originals
    events = list(prof.events())

    def owner(e):
        """A range name, a node evaluation, or None (unranged forward)."""
        forward = False
        while e is not None:
            if e.name in _MOE_RANGES:
                return e.name
            if e.name.startswith(_EVAL):
                return None if forward else e
            if e.sequence_nr >= 0 and "Backward" not in e.name:
                forward = True
            e = e.cpu_parent
        return None

    created = {}  # (forward thread, sequence nr) -> range
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(_EVAL):
            o = owner(e)
            if isinstance(o, str):
                created[(e.thread, e.sequence_nr)] = o
    by_kind = {}
    for e in events:
        if not e.kernels:
            continue
        o = owner(e)
        if o is not None and not isinstance(o, str):
            o = created.get((o.fwd_thread, o.sequence_nr))
        for k in e.kernels:
            kind = _kind_of(k.name)
            if o is not None:
                kind = _MOE_RANGES[o][0 if kind == "GEMM (cuBLAS)" else 1]
            elif kind == "GEMM (cuBLAS)":
                kind = "dense GEMMs (projections, lm_head)"
            by_kind[kind] = by_kind.get(kind, 0.0) + k.duration / 1e3
    return by_kind


def _active_params(cfg, n_params: int) -> int:
    """Parameters a token runs through: each layer's experts count top_k
    times of n_experts."""
    expert = 3 * cfg.d_model * cfg.d_ff
    return n_params - cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert


def phase_moe(torch, report, seed: int, steps: int = 5):
    """``MoEConfig.mixtral_8x7b(n_layers=4)`` (Mixtral-8x7B's widths,
    random weights from a seed, bf16, remat full) at B=1, S=2048: a
    ``moe_apply`` forward, then 2 warm and ``steps`` timed AdamW steps
    through ``make_train_step(moe_loss)``; one step profiled for the idle
    share (device activity only) and one for time by kind."""
    from ray_tpu_torch.models.moe import (MoEConfig, moe_apply, moe_init,
                                          moe_loss)
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)

    cfg = MoEConfig.mixtral_8x7b(n_layers=4)
    B, S = 1, 2048
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    t0 = time.perf_counter()
    params = moe_init(cfg, gen, trainable=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(),
          f"{n_params} parameters, MoEConfig.param_count() "
          f"{cfg.param_count()}")
    check(params.layers[0].moe.router.dtype == torch.float32,
          "the router is not fp32")
    n_active = _active_params(cfg, n_params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    with torch.no_grad():
        moe_apply(cfg, params, tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            logits, aux = moe_apply(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / 3
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(aux)),
          f"moe_apply: logits {tuple(logits.shape)}, aux {float(aux)}")
    del logits
    tx = default_optimizer(lr=1e-4)
    state = TrainState.create(params, tx)
    step = make_train_step(
        lambda p, b: moe_loss(cfg, p, b["tokens"], b["targets"]), tx)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels, prof_wall_ms = profile_window(torch, lambda: step(state, batch),
                                           iters=1)
    busy_ms = sum(kernels.values())
    by_kind = _moe_profile(torch, lambda: step(state, batch))
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    L = cfg.n_layers
    tokens_per_s = B * S / step_s
    # bench.py's convention, 6N + 6 L S d a token, with N the active
    # parameters (a token's top_k experts of n_experts).
    mfu = (tokens_per_s * (6 * n_active + 6 * L * S * cfg.d_model)
           / PEAK_BF16_FLOPS)
    want = _train_launches(L, steps)
    print(f"[moe] Mixtral-8x7B widths, {L} layers: {n_params / 1e9:.3f}B "
          f"params ({n_active / 1e9:.3f}B active, the N of MFU), bf16 "
          f"(router fp32), remat full, capacity {cfg.capacity(B * S)}; "
          f"init {init_s:.1f} s; moe_apply B={B} S={S} {fwd_ms:.1f} ms; "
          f"step {step_s * 1e3:.1f} ms, {tokens_per_s:.1f} tokens/s, MFU "
          f"{mfu:.4f}; peak memory {peak_gb:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 4) for x in norms]}; launches {counts}", flush=True)
    print(f"[moe] profiled step: device busy {busy_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall (idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f}); by kind (ms, CPU and CUDA "
          f"traced): " + "; ".join(f"{k} {t:.1f}" for k, t in sorted(
              by_kind.items(), key=lambda kv: -kv[1])), flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    check(counts == want, f"moe launches {counts}, expected {want}")
    report["moe"] = {
        "params_b": n_params / 1e9, "active_params_b": n_active / 1e9,
        "layers": L, "batch": B, "seq": S, "steps": steps,
        "capacity": cfg.capacity(B * S), "init_s": init_s,
        "forward_ms": fwd_ms, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens_per_s, "mfu": mfu, "peak_gb": peak_gb,
        "losses": losses, "grad_norms": norms, "launches": counts,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / prof_wall_ms, "by_kind_ms": by_kind}
    return cfg, tokens


def _routing(torch, cfg, params, tokens):
    """Per layer ``(probs [G, E] fp32, top_e [G, k], kept [E])`` of a
    no-grad ``moe_apply``, recorded on the CPU."""
    from ray_tpu_torch.models import moe

    rec, original = [], moe._route

    def recording(*args):
        out = original(*args)
        probs, _, top_e, slot_oh = out
        rec.append((probs.float().cpu(), top_e.cpu(),
                    slot_oh.sum((0, 1, 3)).long().cpu()))
        return out

    moe._route = recording
    try:
        with torch.no_grad():
            moe.moe_apply(cfg, params, tokens)
    finally:
        moe._route = original
    return rec


def phase_moe_check(torch, report, cfg, tokens, seed: int):
    """One MoE layer at full width (B=1, S=256).  The tokens each expert
    kept, card (bf16) against CPU (fp32), with the router margins of the
    tokens whose expert choice differs.  Then the loss and every gradient
    in bf16 on the card against the same weights in fp32 on the CPU
    through the plain path, the CPU held to the card's expert choices:
    a token whose choice flips between bf16 and fp32 (a router margin
    under the rounding of its hidden state) moves a whole token's
    contribution between experts, which is not an arithmetic error."""
    from ray_tpu_torch.models import moe

    cfg2 = dataclasses.replace(cfg, n_layers=1)
    params = moe.moe_init(cfg2, torch.Generator(device="cuda")
                          .manual_seed(seed + 6), trainable=True)
    tok = tokens[:, :256]
    tgt = torch.roll(tok, -1, dims=1)
    _reset_counts()
    loss = moe.moe_loss(cfg2, params, tok, tgt)
    loss.backward()
    loss = float(loss.detach())
    counts = _read_counts()
    check(counts == _train_launches(1, 1),
          f"moe check launches {counts}, expected {_train_launches(1, 1)}")
    got = {n: p.grad.float().cpu() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    card_routes = _routing(torch, cfg2, params, tok)
    cpu = moe.MoE(dataclasses.replace(cfg2, dtype=torch.float32,
                                      remat=False), torch.device("cpu"))
    cpu.load_state_dict(params.state_dict())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_routes = _routing(torch, cpu.config, cpu, tok.cpu())
    kept = []
    for layer, ((_, ce, ck), (cp, pe, pk)) in enumerate(
            zip(card_routes, cpu_routes)):
        top = cp.sort(dim=-1, descending=True).values
        margin = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        flipped = (ce.sort(-1).values != pe.sort(-1).values).any(-1)
        kept.append({"card": ck.tolist(), "cpu": pk.tolist(),
                     "equal": bool(torch.equal(ck, pk)),
                     "flipped_tokens": flipped.nonzero()[:, 0].tolist(),
                     "flipped_margins": margin[flipped].tolist(),
                     "min_margin": float(margin.min())})
        print(f"[moe-check] layer {layer}: tokens kept per expert, card "
              f"{ck.tolist()}, CPU {pk.tolist()}; "
              + ("equal" if torch.equal(ck, pk) else "different")
              + f"; tokens whose experts differ "
              f"{flipped.nonzero()[:, 0].tolist()[:10]} with CPU router "
              f"margins {[round(x, 5) for x in margin[flipped].tolist()[:10]]}"
              f" (smallest margin of all {float(margin.min()):.3g})",
              flush=True)

    # The CPU's loss and gradients with the card's expert choices.
    choices, top_k = [e for _, e, _ in card_routes], moe._top_k

    def card_choice(probs, k):
        top_e = choices.pop(0)
        return probs.gather(-1, top_e), top_e

    cpu.requires_grad_(True)
    moe._top_k = card_choice
    try:
        ref = moe.moe_loss(cpu.config, cpu, tok.cpu(), tgt.cpu())
    finally:
        moe._top_k = top_k
    check(not choices, f"{len(choices)} recorded expert choices unused")
    ref.backward()
    ref = float(ref.detach())
    cpu_s = time.perf_counter() - t0
    rel = {n: float((got[n] - p.grad).norm() / p.grad.norm())
           for n, p in cpu.named_parameters()}
    loss_rel = abs(loss - ref) / abs(ref)
    # As phase_train_check: bf16 roundings at each op of a layer, weight
    # gradients summed over 256 tokens: 1-2 % expected, 5 % the bound; the
    # loss 1 %.
    grad_tol, loss_tol = 5e-2, 1e-2
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"[moe-check] 1-layer full-width S=256 vs fp32 CPU plain path "
          f"with the card's expert choices ({cpu_s:.1f} s): loss "
          f"{loss:.5f} vs {ref:.5f} (rel {loss_rel:.3g}, tol {loss_tol}); "
          f"gradient rel norm err over {len(rel)} tensors, worst: "
          + ", ".join(f"{n} {e:.4g}" for n, e in worst)
          + f" (tol {grad_tol})", flush=True)
    check(loss_rel <= loss_tol and max(rel.values()) <= grad_tol,
          f"MoE train path disagrees with the fp32 CPU reference: loss rel "
          f"{loss_rel}, gradient rel {dict(worst)}")
    report["moe_check"] = {"loss": loss, "ref_loss": ref,
                           "loss_rel": loss_rel, "grad_rel": rel,
                           "grad_tol": grad_tol, "loss_tol": loss_tol,
                           "launches": counts, "kept": kept}


def phase_mlp(torch, report, seed: int, steps: int = 20):
    """The MNIST MLP (784-256-256-10, fp32) built by ``mlp_init`` with no
    device given, so on the card: ``steps`` AdamW steps on a batch of
    random images whose labels follow a fixed linear rule; the loss must
    fall."""
    from ray_tpu_torch.models.mlp import MLPConfig, mlp_init, mlp_loss
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)

    cfg = MLPConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    params = mlp_init(cfg, gen, trainable=True)
    check(all(p.is_cuda for p in params.parameters()),
          "mlp_init with no device did not build on the card")
    x = torch.randn(512, cfg.in_dim, generator=gen, device="cuda")
    rule = torch.randn(cfg.in_dim, cfg.out_dim, generator=gen, device="cuda")
    y = (x @ rule).argmax(-1)
    tx = default_optimizer(lr=1e-3)
    state = TrainState.create(params, tx)
    step = make_train_step(lambda p, b: mlp_loss(cfg, p, b["x"], b["y"]),
                           tx)
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, m = step(state, {"x": x, "y": y})
        losses.append(float(m["loss"]))
    wall_s = time.perf_counter() - t0
    print(f"[mlp] 784-256-256-10 on {params.layers[0].w.device}: {steps} "
          f"AdamW steps in {wall_s:.2f} s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          f"the MLP loss did not fall by half: {losses}")
    report["mlp"] = {"steps": steps, "wall_s": wall_s, "losses": losses}


# ------------------------------------------------------------------- rllib
#
# rllib's learners, models and in-process env runners on the card, fp32
# (TF32 off).  No kernel of csrc/ lies on this path: the convolutions and
# products are cuDNN's and cuBLAS's, as XLA's are in the JAX package.  Each
# learner's update is held to the same update on the CPU from the same
# weights and inputs (``_rl_gate``).

#: PPOConfig's defaults (ray_tpu/rllib/ppo.py): 2 runners x 8 envs x 64
#: steps, GAE(0.99, 0.95), 10 epochs of minibatch 256.
RL_PPO = dict(runners=2, envs=8, steps=64, gamma=0.99, lam=0.95,
              epochs=10, minibatch=256, lr=3e-4)
RL_ITERS = 5
#: The Nature-DQN torso on 84 x 84 x 4 frames (Mnih et al. 2015) under the
#: PPO paper's Atari settings (Schulman et al. 2017, Table 5): 8 actors x
#: 128 steps, minibatch 256, 3 epochs, lr 2.5e-4, clip 0.1, vf 1, ent 0.01.
RL_ATARI = dict(obs=(84, 84, 4), actions=6, channels=(32, 64, 64),
                kernels=(8, 4, 3), strides=(4, 2, 1), dense=512,
                batch=1024, minibatch=256, epochs=3, lr=2.5e-4)
#: Card against CPU: each loss within RL_LOSS_REL of the CPU's (plus
#: RL_LOSS_FLOOR for a metric near zero); the last step's gradients within
#: RL_GRAD_REL relative global norm; every parameter within
#: 2 steps lr (1.01) + 1e-4 |p|: Adam's step is at most ~lr an element
#: whatever the gradient, so two runs whose near-zero gradient elements
#: differ by rounding can move such an element by lr the other way.
RL_LOSS_REL, RL_LOSS_FLOOR, RL_GRAD_REL = 1e-4, 1e-6, 1e-4


def _rl_gate(torch, name: str, card, cpu, aux_card, aux_cpu, lr: float,
             steps: int):
    """Hold ``card`` (an ``nn.Module`` on the card after ``steps`` updates)
    and its metrics to ``cpu`` after the same updates on the CPU."""
    loss = {k: abs(aux_card[k] - aux_cpu[k])
            / (RL_LOSS_REL * abs(aux_cpu[k]) + RL_LOSS_FLOOR)
            for k in aux_cpu}
    g_err = g_ref = 0.0
    worst_p, worst_abs, tight = 0.0, 0.0, 0
    with torch.no_grad():
        for (n, pc), (_, pg) in zip(cpu.named_parameters(),
                                    card.named_parameters()):
            if pc.grad is not None:
                check(pg.grad is not None, f"{name}: {n} has no gradient")
                g_err += float(((pg.grad.cpu() - pc.grad) ** 2).sum())
                g_ref += float((pc.grad ** 2).sum())
            d = (pg.detach().cpu() - pc.detach()).abs()
            bound = 2 * steps * lr * 1.01 + 1e-4 * pc.detach().abs()
            worst_p = max(worst_p, float((d / bound).max()))
            worst_abs = max(worst_abs, float(d.max()))
            tight += int((d > 2e-5 + 1e-4 * pc.detach().abs()).sum())
    grad_rel = (g_err / max(g_ref, 1e-30)) ** 0.5
    rec = {"loss_ratio": max(loss.values()), "grad_rel": grad_rel,
           "param_ratio": worst_p, "param_max_abs_err": worst_abs,
           "params_past_2e-5": tight, "steps": steps,
           "card": aux_card, "cpu": aux_cpu}
    print(f"[rllib] gate {name}: losses card/CPU "
          + ", ".join(f"{k} {aux_card[k]:.6g}/{aux_cpu[k]:.6g}"
                      for k in aux_cpu)
          + f" (worst error / (1e-4 rel + 1e-6) {rec['loss_ratio']:.3g}); "
          f"gradient rel norm err {grad_rel:.3g} (tol {RL_GRAD_REL}); "
          f"parameters worst error / Adam bound {worst_p:.3g} (max abs "
          f"{worst_abs:.3g}, {tight} elements past 2e-5 + 1e-4 |p|) after "
          f"{steps} step(s)", flush=True)
    check(rec["loss_ratio"] <= 1.0 and grad_rel <= RL_GRAD_REL
          and worst_p <= 1.0,
          f"rllib {name}: the card's update disagrees with the CPU's: "
          f"{ {k: v for k, v in rec.items() if k not in ('card', 'cpu')} }")
    return rec


def _rl_stitch(samples, gamma: float, lam: float):
    """The PPO algorithm's batch: GAE per runner fragment, then [T, N] rows
    flattened and concatenated (ray_tpu/rllib/ppo.py ``train``)."""
    from ray_tpu_torch.rllib import compute_gae

    flat = {"obs": [], "actions": [], "logp_old": [], "advantages": [],
            "returns": []}
    for s in samples:
        adv, ret = compute_gae(s["rewards"], s["values"],
                               s["bootstrap_values"], s["dones"], gamma, lam)
        T, N = s["rewards"].shape
        flat["obs"].append(s["obs"].reshape(T * N, *s["obs"].shape[2:]))
        flat["actions"].append(s["actions"].reshape(-1))
        flat["logp_old"].append(s["logp_old"].reshape(-1))
        flat["advantages"].append(adv.reshape(-1))
        flat["returns"].append(ret.reshape(-1))
    return {k: np.concatenate(v) for k, v in flat.items()}


def _rl_busy(torch, fn):
    """(device ms, wall ms, idle share, {kernel: ms}) of one call of
    ``fn`` under the profiler."""
    by_name, wall = profile_window(torch, fn, iters=1)
    busy = sum(by_name.values())
    return busy, wall, 1.0 - busy / wall, by_name


def _rl_update_times(torch, fn, n: int):
    """Wall ms per call over ``n`` calls of ``fn`` (which ends in a host
    read, so each call is complete), then one profiled call's device ms and
    idle share."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = (time.perf_counter() - t0) * 1e3 / n
    busy, pwall, idle, _ = _rl_busy(torch, fn)
    return {"wall_ms": wall, "device_ms": busy, "profiled_wall_ms": pwall,
            "idle_share": idle}


def _rl_ppo_cartpole(torch, seed: int, dev=None):
    """(a) The main path: PPOConfig's defaults on CartPole, two in-process
    ``EnvRunner``s and a ``PPOLearner`` on the card, ``RL_ITERS``
    iterations of sample -> GAE -> ``update_from_batch`` -> weight sync,
    then one more under the profiler."""
    from ray_tpu_torch.rllib import EnvRunner, MLPModel, PPOLearner

    c = RL_PPO
    model = MLPModel((4,), 2, 64)
    runners = [EnvRunner("CartPole-v1", c["envs"], seed=seed + i,
                         model=model, device=dev) for i in range(c["runners"])]
    learner = PPOLearner(4, 2, lr=c["lr"], seed=seed, model=model,
                         device=dev)
    want = dev or "cuda"
    check(all(p.device.type == want for p in learner.params.parameters())
          and runners[0].device.type == want,
          "the learner or the runners were not built on the card")
    weights = learner.get_weights()
    for r in runners:
        r.set_weights(weights)
    its, returns = [], []

    def iteration(i):
        t0 = time.perf_counter()
        samples = [r.sample(c["steps"]) for r in runners]
        t1 = time.perf_counter()
        batch = _rl_stitch(samples, c["gamma"], c["lam"])
        m = learner.update_from_batch(
            batch, num_epochs=c["epochs"],
            minibatch_size=min(c["minibatch"], len(batch["obs"])),
            seed=seed + i)
        t2 = time.perf_counter()
        w = learner.get_weights()
        for r in runners:
            r.set_weights(w)
        t3 = time.perf_counter()
        for s in samples:
            returns.extend(s["episode_returns"].tolist())
        its.append({"steps": len(batch["obs"]), "sample_s": t1 - t0,
                    "learn_s": t2 - t1, "sync_s": t3 - t2,
                    "wall_s": t3 - t0, "copy": dict(learner.last_copy),
                    **m})
        return batch

    for i in range(RL_ITERS):
        batch = iteration(i)
    busy, wall, idle, _ = _rl_busy(torch, lambda: iteration(RL_ITERS))
    check(all(np.isfinite(it["total_loss"]) for it in its),
          f"PPO losses not finite: {[it['total_loss'] for it in its]}")
    timed = its[1:RL_ITERS]  # the first iteration builds and warms
    steps = sum(it["steps"] for it in timed)
    rec = {
        "iterations": its, "episode_returns": returns,
        "env_steps_per_s": steps / sum(it["wall_s"] for it in timed),
        "sample_steps_per_s": steps / sum(it["sample_s"] for it in timed),
        "learn_ms": 1e3 * sum(it["learn_s"] for it in timed) / len(timed),
        "traced_iteration": {"device_ms": busy, "wall_ms": wall,
                             "idle_share": idle}}
    print(f"[rllib] ppo cartpole: {RL_ITERS} iterations of "
          f"{its[0]['steps']} env steps (2 runners x 8 envs x 64) + 10 "
          f"epochs x 4 minibatches; env steps/s {rec['env_steps_per_s']:.0f}"
          f" (sampling alone {rec['sample_steps_per_s']:.0f}); learn "
          f"{rec['learn_ms']:.1f} ms an iteration; losses "
          f"{[round(it['total_loss'], 4) for it in its]}; mean return "
          f"{np.mean(returns) if returns else float('nan'):.1f} over "
          f"{len(returns)} episodes; a traced iteration: device "
          f"{busy:.2f} of {wall:.1f} ms, idle share {idle:.4f}", flush=True)
    return rec, batch


def _rl_gate_ppo(torch, seed: int, model, batch, lr: float, kw, name: str,
                 dev=None, **learner_kw):
    """One ``update_from_batch`` of one minibatch step on the card and on
    the CPU, from the same initial weights."""
    from ray_tpu_torch.rllib import PPOLearner

    size = int(np.prod(model.obs_shape))
    card = PPOLearner(size, model.num_actions, lr=lr, seed=seed,
                      model=model, device=dev, **learner_kw)
    cpu = PPOLearner(size, model.num_actions, lr=lr, seed=seed,
                     model=model, device="cpu", **learner_kw)
    check(all(torch.equal(a.cpu(), b) for a, b in
              zip(card.params.parameters(), cpu.params.parameters())),
          f"{name}: the same seed gave other weights on the card")
    mb = {k: v[:kw["minibatch_size"]] for k, v in batch.items()}
    return _rl_gate(torch, name, card.params, cpu.params,
                    card.update_from_batch(mb, **kw),
                    cpu.update_from_batch(mb, **kw), lr, 1)


def _rl_atari(torch, seed: int, dev=None):
    """(b) PPO at the Nature-CNN Atari widths: one ``update_from_batch``
    of a 1,024-frame batch (3 epochs x 4 minibatches of 256), timed
    wall and device, one minibatch step alone, the host-to-device copy,
    peak memory and idle share; then one minibatch step against the CPU."""
    from ray_tpu_torch.rllib import CNNModel, PPOLearner
    from ray_tpu_torch.rllib.learner import to_device

    c = RL_ATARI
    model = CNNModel(c["obs"], c["actions"], channels=c["channels"],
                     kernels=c["kernels"], strides=c["strides"],
                     dense=c["dense"])
    kw = dict(lr=c["lr"], clip_param=0.1, vf_coeff=1.0,
              entropy_coeff=0.01)
    learner = PPOLearner(int(np.prod(c["obs"])), c["actions"], seed=seed,
                         model=model, device=dev, **kw)
    n_params = sum(p.numel() for p in learner.params.parameters())
    rng = np.random.default_rng(seed + 11)
    n = c["batch"]
    frames = rng.integers(0, 256, (n, *c["obs"]), dtype=np.uint8)
    batch = {"obs": frames.astype(np.float32) / 255.0,
             "actions": rng.integers(0, c["actions"], n).astype(np.int32),
             "logp_old": (np.log(1.0 / c["actions"])
                          + rng.normal(0, 0.05, n)).astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "returns": rng.normal(size=n).astype(np.float32)}
    upd = dict(num_epochs=c["epochs"], minibatch_size=c["minibatch"],
               seed=seed)
    learner.update_from_batch(batch, **upd)  # warm (cuDNN, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = learner.update_from_batch(batch, **upd)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    copy = dict(learner.last_copy)
    busy, pwall, idle, by_name = _rl_busy(
        torch, lambda: learner.update_from_batch(batch, **upd))
    # The copy as the profiled window saw it (CUPTI has dropped a window's
    # copies on the H100 machine) and by CUDA events around the copy alone.
    h2d_traced_ms = sum(v for k, v in by_name.items() if "HtoD" in k)
    h2d_ms = time_ms(torch, lambda: to_device(batch, learner.device),
                     iters=3, warmup=1)
    mb = {k: torch.from_numpy(v[:c["minibatch"]]).to(learner.device)
          for k, v in batch.items()}
    step_call_ms = time_ms(torch, lambda: learner._update(mb), iters=10)
    step_dev_ms = device_ms(torch, lambda: learner._update(mb), iters=5)
    steps = c["epochs"] * (n // c["minibatch"])
    rec = {"params": n_params, "update_wall_ms": wall_s * 1e3,
           "update_device_ms": busy, "update_profiled_wall_ms": pwall,
           "idle_share": idle, "frames_per_s": steps * c["minibatch"]
           / wall_s, "minibatch_steps": steps,
           "step_call_ms": step_call_ms, "step_device_ms": step_dev_ms,
           "h2d_bytes": copy["bytes"], "h2d_host_ms": copy["seconds"] * 1e3,
           "h2d_ms": h2d_ms, "h2d_traced_ms": h2d_traced_ms,
           "peak_gb": peak_gb, **m}
    print(f"[rllib] ppo nature-cnn (84x84x4, 32/64/64 convs, dense 512, "
          f"{n_params:,} parameters): update_from_batch of {n} frames "
          f"({steps} minibatch steps) wall {rec['update_wall_ms']:.1f} ms, "
          f"device {busy:.1f} ms (idle share {idle:.4f}); "
          f"{rec['frames_per_s']:.0f} frames/s; one minibatch step "
          f"{step_call_ms:.2f} ms (device {step_dev_ms:.2f}); host-to-device "
          f"copy of {copy['bytes'] / 1e6:.1f} MB: {h2d_ms:.2f} ms by CUDA "
          f"events ({copy['bytes'] / h2d_ms / 1e6:.2f} GB/s), host "
          f"{rec['h2d_host_ms']:.1f} ms in the timed update, "
          f"{h2d_traced_ms:.2f} ms in the traced one; peak "
          f"{peak_gb:.3f} GB; loss "
          f"{m['total_loss']:.5f}", flush=True)
    del learner, mb
    rec["gate"] = _rl_gate_ppo(
        torch, seed, model, batch, c["lr"],
        dict(num_epochs=1, minibatch_size=c["minibatch"], seed=0),
        "ppo nature-cnn", dev, clip_param=0.1, vf_coeff=1.0,
        entropy_coeff=0.01)
    return rec


def _rl_dqn(torch, seed: int, dev=None):
    """(c) DQN at DQNConfig's defaults: a ``ReplayBuffer`` filled by an
    ``EnvRunner``'s ``sample_transitions`` on the card, 64 updates of
    batch 64 and one ``sync_target``."""
    from ray_tpu_torch.rllib import DQNLearner, EnvRunner, ReplayBuffer
    from ray_tpu_torch.rllib.learner import host_floats

    kw = dict(lr=5e-4, gamma=0.99, grad_clip=10.0, hidden=64)
    runner = EnvRunner("CartPole-v1", 8, seed=seed, device=dev)
    learner = DQNLearner(4, 2, seed=seed, device=dev, **kw)
    runner.set_q_weights(learner.get_weights())
    buf = ReplayBuffer(50_000, 4, seed=seed)
    t0 = time.perf_counter()
    for _ in range(8):
        buf.add_batch(runner.sample_transitions(32, 1.0))
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aux = None
    for _ in range(64):
        aux = learner.update_raw(buf.sample(64))
    m = host_floats(aux)
    burst_ms = (time.perf_counter() - t0) * 1e3
    learner.sync_target()
    times = _rl_update_times(
        torch, lambda: learner.update_from_batch(buf.sample(64)), 32)
    runner.set_q_weights(learner.get_weights())
    runner.sample_transitions(8, 0.05)
    batch = buf.sample(64)
    card = DQNLearner(4, 2, seed=seed, device=dev, **kw)
    cpu = DQNLearner(4, 2, seed=seed, device="cpu", **kw)
    gate = _rl_gate(torch, "dqn", card.params, cpu.params,
                    card.update_from_batch(batch),
                    cpu.update_from_batch(batch), kw["lr"], 1)
    rec = {"transitions": len(buf), "sample_s": sample_s,
           "burst_ms_per_update": burst_ms / 64, **times, **m,
           "gate": gate}
    print(f"[rllib] dqn: {len(buf)} transitions in {sample_s:.2f} s; 64 "
          f"updates of 64 at {rec['burst_ms_per_update']:.3f} ms each (one "
          f"read at the end); one update with its read {times['wall_ms']:.3f}"
          f" ms (device {times['device_ms']:.3f} ms, idle share "
          f"{times['idle_share']:.4f}); loss {m['loss']:.5f}", flush=True)
    return rec


def _rl_impala(torch, seed: int, dev=None):
    """(c) IMPALA at ImpalaConfig's defaults: two ``ImpalaEnvRunner``
    fragments of 64 steps x 8 envs per update, lr 7e-4, grad clip 40."""
    from ray_tpu_torch.rllib import ImpalaEnvRunner, ImpalaLearner

    runners = [ImpalaEnvRunner("CartPole-v1", 8, seed=seed + i, device=dev)
               for i in range(2)]
    learner = ImpalaLearner(4, 2, lr=7e-4, grad_clip=40.0, seed=seed,
                            device=dev)
    for r in runners:
        r.set_weights(learner.get_weights(), 0)
    t0 = time.perf_counter()
    frags = [r.sample(64) for r in runners]
    sample_s = time.perf_counter() - t0
    for v in range(8):
        m = learner.update_from_fragments(frags)
        for r in runners:
            r.set_weights(learner.get_weights(), v + 1)
        frags = [r.sample(64) for r in runners]
    times = _rl_update_times(
        torch, lambda: learner.update_from_fragments(frags), 16)
    card = ImpalaLearner(4, 2, lr=7e-4, grad_clip=40.0, seed=seed,
                         device=dev)
    cpu = ImpalaLearner(4, 2, lr=7e-4, grad_clip=40.0, seed=seed,
                        device="cpu")
    gate = _rl_gate(torch, "impala", card.params, cpu.params,
                    card.update_from_fragments(frags),
                    cpu.update_from_fragments(frags), 7e-4, 1)
    rec = {"fragment_sample_s": sample_s, **times, **m, "gate": gate}
    print(f"[rllib] impala: 2 fragments of 64 x 8 sampled in "
          f"{sample_s:.2f} s; one V-trace update {times['wall_ms']:.3f} ms "
          f"(device {times['device_ms']:.3f} ms, idle share "
          f"{times['idle_share']:.4f}); loss {m['total_loss']:.5f}, mean "
          f"rho {m['mean_rho']:.4f}", flush=True)
    return rec


def _rl_sac(torch, seed: int, dev=None):
    """(c) SAC at SACConfig's defaults on Pendulum: hidden 256, batch 256,
    16 updates from a buffer filled by a ``ContinuousEnvRunner`` on the
    card; the gate hands the card and the CPU the same noise."""
    from ray_tpu_torch.rllib import (ContinuousEnvRunner, PendulumEnv,
                                     SACLearner)
    from ray_tpu_torch.rllib.learner import host_floats, to_device

    kw = dict(action_low=-2.0, action_high=2.0, hidden=256)
    runner = ContinuousEnvRunner(PendulumEnv, 8, action_size=1, scale=2.0,
                                 bias=0.0, seed=seed, device=dev)
    parts = [runner.sample_transitions(32, random_actions=True)
             for _ in range(4)]
    data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]
            if k != "episode_returns"}
    rng = np.random.default_rng(seed + 3)
    learner = SACLearner(3, 1, seed=seed, device=dev, **kw)

    def update():
        idx = rng.integers(0, len(data["rewards"]), 256)
        return learner.update_from_batch({k: v[idx] for k, v in
                                          data.items()})

    for _ in range(16):
        m = update()
    runner.set_actor_weights(learner.get_actor_weights())
    runner.sample_transitions(8)
    times = _rl_update_times(torch, update, 16)
    idx = rng.integers(0, len(data["rewards"]), 256)
    batch = {k: v[idx] for k, v in data.items()}
    gen = torch.Generator().manual_seed(seed)
    eps = [torch.randn(256, 1, generator=gen) for _ in range(2)]
    card = SACLearner(3, 1, seed=seed, device=dev, **kw)
    cpu = SACLearner(3, 1, seed=seed, device="cpu", **kw)
    a_card = host_floats(card._update(to_device(batch, card.device),
                                      *[e.to(card.device) for e in eps]))
    a_cpu = host_floats(cpu._update(to_device(batch, cpu.device), *eps))
    gate = _rl_gate(torch, "sac", card.params, cpu.params, a_card, a_cpu,
                    3e-4, 1)
    rec = {**times, **m, "gate": gate}
    print(f"[rllib] sac: one update of 256 (twin critics, actor, alpha, "
          f"Polyak) {times['wall_ms']:.3f} ms (device "
          f"{times['device_ms']:.3f} ms, idle share "
          f"{times['idle_share']:.4f}); critic loss {m['critic_loss']:.4f}",
          flush=True)
    return rec


def _rl_bc(torch, seed: int, dev=None):
    """(c) BC on a dataset ``collect_offline_dataset`` writes to a temp
    dir (50 CartPole episodes of an epsilon-soft reactive policy), 200
    steps of batch 256."""
    from ray_tpu_torch.rllib import BC, JsonReader, collect_offline_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    try:
        path = os.path.join(tmp, "cartpole.jsonl")
        rows = collect_offline_dataset(
            "CartPole-v1", path, num_episodes=50, seed=seed, epsilon=0.3,
            policy=lambda obs: ((1 if obs[2] > 0 else 0), 1.0))
        reader = JsonReader(path)
        bc = BC((4,), 2, lr=1e-3, seed=seed, device=dev)
        bc.train_on(reader, num_steps=10, batch_size=256)
        t0 = time.perf_counter()
        loss = bc.train_on(reader, num_steps=200, batch_size=256, seed=1)
        step_ms = (time.perf_counter() - t0) * 1e3 / 200
        table = reader.read_all()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    idx = np.random.default_rng(seed).integers(0, rows, 256)
    obs = torch.from_numpy(np.asarray(table["obs"], np.float32)[idx])
    acts = torch.from_numpy(np.asarray(table["actions"], np.int32)[idx])
    times = _rl_update_times(
        torch, lambda: float(bc._update(obs.to(bc.device),
                                        acts.to(bc.device))), 32)
    card = BC((4,), 2, lr=1e-3, seed=seed, device=dev)
    cpu = BC((4,), 2, lr=1e-3, seed=seed, device="cpu")
    gate = _rl_gate(torch, "bc", card.params, cpu.params,
                    {"loss": float(card._update(obs.to(card.device),
                                                acts.to(card.device)))},
                    {"loss": float(cpu._update(obs, acts))}, 1e-3, 1)
    rec = {"rows": rows, "train_on_ms_per_step": step_ms, "loss": loss,
           **times, "gate": gate}
    print(f"[rllib] bc: {rows} rows; train_on {step_ms:.3f} ms a step of "
          f"256 (its loop reads once); one step with its read "
          f"{times['wall_ms']:.3f} ms (device {times['device_ms']:.3f} ms); "
          f"loss {loss:.4f}", flush=True)
    return rec


def _rl_rank(rank: int, seed: int, tmp: str):
    """One rank of the rllib mesh check: the PPO ``update_from_batch`` at
    dp 2 on the card, on the batch the parent saved."""
    import torch

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.rllib import PPOLearner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(os.path.join(tmp, "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    mesh = make_mesh(MeshConfig(dp=2, fsdp=1))
    learner = PPOLearner(4, 2, lr=RL_PPO["lr"], seed=seed, mesh=mesh)
    t0 = time.perf_counter()
    m = learner.update_from_batch(batch, num_epochs=RL_PPO["epochs"],
                                  minibatch_size=RL_PPO["minibatch"])
    return {"metrics": m, "s": time.perf_counter() - t0,
            "params": {k: v.cpu().numpy() for k, v in
                       learner.params.state_dict().items()},
            "imports": sorted(mod for mod in sys.modules
                              if mod.split(".")[0] in ("jax", "jaxlib",
                                                       "ray_tpu"))}


def _rl_mesh(torch, seed: int, batch):
    """(d) The learners' ``mesh=`` path: two ranks on the one card over
    gloo, one PPO ``update_from_batch`` at dp 2 (PPOConfig's 10 epochs of
    minibatch 256), held against the same update in one process."""
    from ray_tpu_torch.parallel import spawn_ranks
    from ray_tpu_torch.rllib import PPOLearner

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rllib_mesh_")
    try:
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        t0 = time.perf_counter()
        ranks = spawn_ranks(_rl_rank, 2, seed, tmp,
                            store=os.path.join(tmp, "store"),
                            backend="gloo", cuda_device=0, timeout_s=300)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(not r["imports"] for r in ranks),
          f"a rank imported JAX or the JAX package: "
          f"{[r['imports'] for r in ranks]}")
    one = PPOLearner(4, 2, lr=RL_PPO["lr"], seed=seed)
    t0 = time.perf_counter()
    m = one.update_from_batch(batch, num_epochs=RL_PPO["epochs"],
                              minibatch_size=RL_PPO["minibatch"])
    one_s = time.perf_counter() - t0
    r0, r1 = ranks
    check(r0["metrics"] == r1["metrics"]
          and all(np.array_equal(r0["params"][k], r1["params"][k])
                  for k in r0["params"]),
          "the two ranks' parameters or metrics differ")
    loss = max(abs(r0["metrics"][k] - m[k])
               / (RL_LOSS_REL * abs(m[k]) + RL_LOSS_FLOOR) for k in m)
    steps = RL_PPO["epochs"] * (len(batch["obs"]) // RL_PPO["minibatch"])
    worst, worst_abs = 0.0, 0.0
    for k, v in one.params.state_dict().items():
        ref = v.cpu().numpy()
        d = np.abs(r0["params"][k] - ref)
        worst = max(worst, float((d / (2 * steps * RL_PPO["lr"] * 1.01
                                       + 1e-4 * np.abs(ref))).max()))
        worst_abs = max(worst_abs, float(d.max()))
    rec = {"ranks_s": ranks_s, "rank_update_s": [r["s"] for r in ranks],
           "one_process_s": one_s, "loss_ratio": loss,
           "param_ratio": worst, "param_max_abs_err": worst_abs,
           "steps": steps, "metrics": r0["metrics"], "one_process": m}
    print(f"[rllib] mesh dp 2 (two ranks on the one card, gloo): PPO "
          f"update_from_batch of {len(batch['obs'])} rows ({steps} steps) "
          f"total loss {r0['metrics']['total_loss']:.6f} vs one process "
          f"{m['total_loss']:.6f} (worst metric error / (1e-4 rel + 1e-6) "
          f"{loss:.3g}); parameters worst error / Adam bound {worst:.3g} "
          f"(max abs {worst_abs:.3g}); rank update "
          f"{[round(r['s'], 3) for r in ranks]} s, one process {one_s:.3f} "
          f"s; spawn and all {ranks_s:.1f} s", flush=True)
    check(loss <= 1.0 and worst <= 1.0,
          f"the dp 2 update disagrees with the one-process update: {rec}")
    return rec


def phase_rllib(torch, report, seed: int, dev=None):
    """rllib on the card, fp32 (see the section's comment): (a) the main
    path, PPO on CartPole with its launch counts, (b) PPO at the Nature-CNN
    Atari widths, (c) DQN, IMPALA, SAC and BC, (d) the ``mesh=`` path.
    ``dev="cpu"`` (a rehearsal off the card, the profiler and the card's
    clocks stubbed) drives every piece but (d) on the CPU."""
    _reset_counts()
    ppo, batch = _rl_ppo_cartpole(torch, seed, dev)
    counts = _read_counts()
    check(not any(counts.values()),
          f"a csrc kernel launched on the rllib path: {counts}")
    from ray_tpu_torch.rllib import MLPModel

    ppo["gate"] = _rl_gate_ppo(
        torch, seed, MLPModel((4,), 2, 64), batch, RL_PPO["lr"],
        dict(num_epochs=1, minibatch_size=RL_PPO["minibatch"], seed=0),
        "ppo cartpole", dev)
    out = {"launches": counts, "ppo_cartpole": ppo,
           "atari": _rl_atari(torch, seed, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out.update(dqn=_rl_dqn(torch, seed, dev),
               impala=_rl_impala(torch, seed, dev),
               sac=_rl_sac(torch, seed, dev), bc=_rl_bc(torch, seed, dev))
    if dev is None:
        out["mesh"] = _rl_mesh(torch, seed, batch)
    out["card"] = card_line()
    report["rllib"] = out


# ------------------------------------------------------------- train gang
#
# The training library on the card: ``TorchTrainer.fit()`` -> a gang of one
# worker granted the card -> its session -> ``train.report`` -> a
# checkpoint.  The worker runs the train phase's configuration (full
# Llama-3-8B, not cut) and reads its own process's launch counts.

#: The gang's steps: 1 warm, then 5 timed, each reported.
GANG_STEPS = 6
#: Its first loss against the train phase's first loss from the same seed:
#: the same code on the same card and inputs (equal unless a fresh
#: process picks other cuBLAS algorithms), held to 1e-3 absolute on a
#: loss of about 12.
GANG_LOSS_ATOL = 1e-3
#: A gang step slower than this times the train phase's means the worker
#: trained off the kernels or off the card.
GANG_SLOWER_MAX = 1.5


def _proc_ticks():
    """Each process's user + system CPU ticks with its name, from
    ``/proc`` (empty where it cannot be read)."""
    procs = {}
    for p in os.listdir("/proc") if os.path.isdir("/proc") else ():
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                s = f.read()
        except (OSError, ValueError):
            continue
        rest = s[s.rindex(")") + 2:].split()
        procs[p] = (s[s.index("(") + 1:s.rindex(")")],
                    int(rest[11]) + int(rest[12]))
    return procs


def _others_ms(a, b, top: int = 3):
    """Between two ``_proc_ticks``: the ``top`` processes other than this
    one by CPU milliseconds used, as ``[name, pid, ms]``."""
    ms = 1e3 / os.sysconf("SC_CLK_TCK")
    used = sorted(((b[p][0], p, (b[p][1] - a[p][1]) * ms) for p in b
                   if p in a and p != str(os.getpid())
                   and b[p][1] > a[p][1]), key=lambda x: -x[2])
    return [list(x) for x in used[:top]]


def _host_line(each) -> str:
    """``_gang_loop``'s host numbers of each step, one clause a step."""
    def one(h):
        return (f"thread CPU {h['thread_cpu_ms']:.1f} ms, GC "
                f"{h['gc_ms']:.1f} ms ({h['gc_full']} full), alloc retries "
                f"{h['alloc_retries']}, new segments {h['new_segments']}, "
                f"others " + (", ".join(f"{n}[{p}] {t:.0f} ms"
                                        for n, p, t in h["others"])
                              or "none"))
    return "; ".join(f"step {i + 1}: {one(h)}" for i, h in enumerate(each))


def _gang_cfg(dev, layers=None):
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = (LlamaConfig.tiny(dtype=torch.float32) if dev == "cpu"
           else LlamaConfig.llama3_8b())
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _gang_loop(config):
    """A gang worker: phase_train's model, optimizer and batch from the
    seed (``dev="cpu"``: the tiny model on the CPU), restored from the
    session's checkpoint when there is one; each step reported with its
    loss and milliseconds (the session adds the MFU from
    ``set_flops_per_step``), the last one with this process's launch counts
    and peak memory.  ``ckpt_at`` steps carry a checkpoint (the whole
    ``TrainState``); after reporting step ``kill_at`` the worker SIGKILLs
    itself, once.  With ``from_dataset`` each step's tokens are the next
    batch of the worker's "train" shard (``iter_batches(device="cuda")``)
    instead of one batch drawn from the seed, and ``lr`` sets AdamW's
    rate; each step also reports the session's data wait for its batch."""
    import signal

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import llama_init, llama_loss
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)
    from ray_tpu_torch.train.session import get_session

    t_entry = time.time()
    cpu = config["dev"] == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _gang_cfg(config["dev"], config.get("layers"))
    B, S = config["batch"], config["seq"]
    gen = torch.Generator(device="cpu" if cpu else "cuda").manual_seed(
        config["seed"] + 2)
    params = llama_init(cfg, gen, "cpu" if cpu else None, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    tx = default_optimizer(lr=config.get("lr", 1e-4))
    state = TrainState.create(params, tx)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        saved = train.load_pytree(ckpt.path)
        params.load_state_dict(saved["params"])
        state.opt_state.load_state_dict(saved["opt_state"])
        state.step = saved["step"]
        del saved
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    t_built = time.time()
    session = get_session()
    if config.get("from_dataset"):
        # One batch a step from this worker's shard of the "train" dataset,
        # copied to the card one batch ahead (``device_prefetch``).
        shard = train.get_dataset_shard("train").iter_batches(
            batch_size=B, device="cpu" if cpu else "cuda")

        def next_batch():
            tokens = next(shard)["tokens"]
            return {"tokens": tokens,
                    "targets": torch.roll(tokens, -1, dims=1)}
    else:
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cpu" if cpu else "cuda")
        fixed = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}

        def next_batch():
            return fixed
    # PERF.md's convention: 6N + 6 L S d model flops a token.
    session.telemetry.set_flops_per_step(
        (6 * n_params + 6 * cfg.n_layers * S * cfg.d_model) * B * S)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    sync()
    _reset_counts()
    history = []  # every step's numbers, reported again with the last
    # Garbage collections in this process: their milliseconds and the
    # full (generation 2) ones, read around each step.
    gcs = {"ms": 0.0, "full": 0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gcs["t0"] = time.perf_counter()
        else:
            gcs["ms"] += (time.perf_counter() - gcs["t0"]) * 1e3
            gcs["full"] += info["generation"] == 2

    gc.callbacks.append(on_gc)

    def alloc_counts():
        if cpu:
            return 0, 0
        st = torch.cuda.memory_stats()
        return (st.get("num_alloc_retries", 0),
                st.get("segment.all.allocated", 0))

    while state.step < config["steps"]:
        batch = next_batch()
        data_wait_s = session._data_wait_s  # this round's, so far
        # Where a step's wall goes on the host: this thread's CPU time,
        # garbage collection, the allocator's retries and new segments, the
        # other processes' CPU time.
        ticks, allocs = _proc_ticks(), alloc_counts()
        gc_ms, gc_full = gcs["ms"], gcs["full"]
        t0, c0 = time.perf_counter(), time.thread_time()
        state, m = step(state, batch)
        loss = float(m["loss"])
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        cpu_ms = (time.thread_time() - c0) * 1e3
        allocs2 = alloc_counts()
        metrics = {"step": state.step, "loss": loss, "step_ms": step_ms,
                   "params": n_params, "pid": os.getpid(),
                   "data_wait_s": data_wait_s,
                   "host": {"thread_cpu_ms": cpu_ms,
                            "gc_ms": gcs["ms"] - gc_ms,
                            "gc_full": gcs["full"] - gc_full,
                            "alloc_retries": allocs2[0] - allocs[0],
                            "new_segments": allocs2[1] - allocs[1],
                            "others": _others_ms(ticks, _proc_ticks())}}
        history.append({k: metrics[k] for k in ("step", "loss", "step_ms",
                                                "data_wait_s", "host")})
        if state.step == config["steps"]:
            metrics["history"] = history
            # Wall-clock marks: the loop's start, the model built, the
            # last step done.
            metrics["t_marks"] = [t_entry, t_built, time.time()]
            metrics["launches"] = _read_counts()
            metrics["peak_gb"] = (0.0 if cpu else
                                  torch.cuda.max_memory_allocated() / 1e9)
            metrics["visible"] = os.environ.get("CUDA_VISIBLE_DEVICES")
            if config.get("from_dataset"):
                from ray_tpu_torch.data import DataContext

                metrics["prefetch"] = dict(
                    DataContext.get_current().last_prefetch_stats)
        ck = None
        if state.step in config.get("ckpt_at", ()):
            d = tempfile.mkdtemp(prefix="gang_ckpt_", dir=config["scratch"])
            t1 = time.perf_counter()
            train.save_pytree(state, d)
            metrics["save_s"] = time.perf_counter() - t1
            ck = train.Checkpoint.from_directory(d)
        train.report(metrics, checkpoint=ck)
        if ck is not None:
            shutil.rmtree(ck.path, ignore_errors=True)
        marker = config.get("marker")
        if config.get("kill_at") == state.step and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
    gc.callbacks.remove(on_gc)


def _gang_fit(train, config, scratch, name, max_failures=0):
    """``TorchTrainer(_gang_loop)`` on one worker granted the card."""
    t0 = time.perf_counter()
    res = train.TorchTrainer(
        _gang_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=config["dev"] != "cpu"),
        run_config=train.RunConfig(
            name=name, storage_path=scratch,
            failure_config=train.FailureConfig(max_failures=max_failures)),
    ).fit()
    check(res.error is None, f"train gang {name} failed: {res.error}")
    return res, time.perf_counter() - t0


def phase_train_gang(torch, report, seed: int, card: str, dev=None):
    """The training library on the card; see the module docstring's phase
    list.  ``dev="cpu"`` rehearses it on the CPU with the tiny model (no
    card, so no launch counts, memory or comparison with the train
    phase)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    cpu = dev == "cpu"
    out = {"card": card}
    if not cpu:
        gc.collect()
        torch.cuda.empty_cache()
        out["driver_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
        out["driver_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    scratch = tempfile.mkdtemp(prefix="rt_train_gang_")
    disk = shutil.disk_usage(scratch)
    print(f"[train_gang] the driver holds "
          f"{out.get('driver_reserved_gb', 0):.3f} GB reserved "
          f"({out.get('driver_allocated_gb', 0):.3f} GB allocated) of the "
          f"card before the gang starts; scratch {scratch} "
          f"({disk.free / 1e9:.1f} GB free); {card}", flush=True)
    rt.init(num_cpus=4)
    try:
        res = rt.cluster_resources()
        check(cpu or res.get("GPU") == 1.0,
              f"autodetected GPU resource {res.get('GPU')}, expected 1")
        base = {"dev": dev, "seed": seed, "batch": 1,
                "seq": 32 if cpu else 2048, "scratch": scratch}
        r, wall = _gang_fit(train, dict(base, steps=GANG_STEPS),
                            scratch, "gang")
        hist = r.metrics_history
        check([m["step"] for m in hist] == list(range(1, GANG_STEPS + 1)),
              f"gang reported steps {[m['step'] for m in hist]}")
        losses = [m["loss"] for m in hist]
        timed = hist[1:]
        step_ms = float(np.median([m["step_ms"] for m in timed]))
        mfus = [m["mfu"] for m in timed if "mfu" in m]
        mfu = float(np.median(mfus)) if mfus else float("nan")
        last = hist[-1]
        L = _gang_cfg(dev).n_layers
        out.update(
            steps=GANG_STEPS, losses=losses, step_ms=step_ms,
            step_ms_each=[m["step_ms"] for m in hist], mfu=mfu,
            mfu_each=mfus, peak_gb=last["peak_gb"], fit_s=wall,
            params=last["params"], visible=last["visible"],
            launches=last["launches"],
            host_each=[m["host"] for m in hist])
        check(all(np.isfinite(losses)), f"non-finite gang loss: {losses}")
        line = (f"[train_gang] TorchTrainer, one worker granted the card "
                f"(CUDA_VISIBLE_DEVICES={last['visible']!r}): "
                f"{last['params'] / 1e9:.2f}B params, {L} layers, B=1 "
                f"S={base['seq']}, remat full; step median "
                f"{step_ms:.1f} ms over {len(timed)} timed steps "
                f"({[round(m['step_ms'], 1) for m in hist]}), MFU "
                f"{mfu:.4f} (TrainTelemetry, set_flops_per_step); losses "
                f"{[round(x, 4) for x in losses]}; worker peak "
                f"{last['peak_gb']:.2f} GB; fit {wall:.1f} s; launches "
                f"{last['launches']}")
        print(line, flush=True)
        print("[train_gang] host by step: " + _host_line(out["host_each"]),
              flush=True)
        if not cpu:
            ref = report["train"]
            out["train_step_ms"], out["train_mfu"] = ref["step_ms"], ref["mfu"]
            out["first_loss_err"] = abs(losses[0] - ref["losses"][0])
            print(f"[train_gang] against the train phase in this call: "
                  f"step {step_ms:.1f} ms vs {ref['step_ms']:.1f} ms "
                  f"({step_ms / ref['step_ms']:.3f}x), MFU {mfu:.4f} vs "
                  f"{ref['mfu']:.4f}; first loss {losses[0]:.6f} vs "
                  f"{ref['losses'][0]:.6f} (|err| "
                  f"{out['first_loss_err']:.3g}, tol {GANG_LOSS_ATOL}); "
                  f"{card}", flush=True)
            check(last["visible"] not in (None, ""),
                  "the gang worker was granted no card")
            check(last["launches"] == _train_launches(L, GANG_STEPS),
                  f"gang launches {last['launches']}, expected "
                  f"{_train_launches(L, GANG_STEPS)}")
            check(out["first_loss_err"] <= GANG_LOSS_ATOL,
                  f"the gang's first loss {losses[0]} differs from the "
                  f"train phase's {ref['losses'][0]}")
            check(step_ms <= GANG_SLOWER_MAX * ref["step_ms"],
                  f"the gang's step {step_ms:.1f} ms is over "
                  f"{GANG_SLOWER_MAX}x the train phase's "
                  f"{ref['step_ms']:.1f} ms")
        out["restore"] = _gang_restore(train, base, scratch, card)
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    report["train_gang"] = out


def _gang_restore(train, base, scratch, card):
    """A 1-layer model at the 8B widths: 3 steps uninterrupted, then 3
    steps with a checkpoint reported at step 2 and the worker killed right
    after; the restored gang's step-3 loss must equal the uninterrupted
    run's bit for bit."""
    cfg = dict(base, layers=1, steps=3)
    ref, ref_s = _gang_fit(train, cfg, scratch, "uninterrupted")
    marker = os.path.join(scratch, "killed")
    got, got_s = _gang_fit(train, dict(cfg, ckpt_at=[2], kill_at=2,
                                       marker=marker),
                           scratch, "restored", max_failures=1)
    ref_l = [m["loss"] for m in ref.metrics_history]
    got_l = [m["loss"] for m in got.metrics_history]
    pids = {m["pid"] for m in got.metrics_history}
    save_s = next(m["save_s"] for m in got.metrics_history if "save_s" in m)
    rec = {"losses": got_l, "uninterrupted": ref_l, "killed":
           os.path.exists(marker), "processes": len(pids),
           "save_s": save_s, "fit_s": got_s, "uninterrupted_fit_s": ref_s}
    print(f"[train_gang] restore (1 layer at the 8B widths): "
          f"uninterrupted losses {ref_l}; killed after the step-2 "
          f"checkpoint ({rec['killed']}, {len(pids)} worker processes), "
          f"restored losses {got_l}; checkpoint save {save_s:.1f} s, fit "
          f"{got_s:.1f} s vs {ref_s:.1f} s; {card}", flush=True)
    check(rec["killed"] and len(pids) == 2,
          "the worker was not killed and replaced")
    check([m["step"] for m in got.metrics_history] == [1, 2, 3],
          f"restored run's steps {[m['step'] for m in got.metrics_history]}")
    check(got_l[2] == ref_l[2],
          f"the restored step-3 loss {got_l[2]!r} differs from the "
          f"uninterrupted run's {ref_l[2]!r}")
    return rec


# --------------------------------------------------------------- data tune

#: The Tuner sweep's grid of learning rates and its steps a trial, the
#: first ``TUNE_WARM`` of them untimed, as the train phase's warm steps
#: (a fresh worker's second step still spends 100-300 ms more host time
#: than its third; PERF.md, open questions).
TUNE_LRS = (1e-4, 3e-4)
TUNE_STEPS = 4
TUNE_WARM = 2
#: Rows of the prefetch check's dataset.
PREFETCH_ROWS = 8


def _prefetch_check(torch, data, S: int, vocab: int, seed: int, dev):
    """(a) of the data-tune phase: ``PREFETCH_ROWS`` seeded rows of S
    int64 tokens through ``from_numpy``, ``map_batches`` (targets rolled by
    one), ``streaming_split(1)`` and ``iter_batches(batch_size=1,
    device=dev)``; every batch must equal its host rows bit for bit, and
    on the card the staging must be pinned and the copies on a stream of
    their own."""
    rows = np.random.default_rng(seed + 17).integers(
        0, vocab, (PREFETCH_ROWS, S), dtype=np.int64)
    ds = data.from_numpy(rows, "tokens", override_num_blocks=4).map_batches(
        lambda b: {"tokens": b["tokens"],
                   "targets": np.roll(b["tokens"], -1, axis=1)})
    (shard,) = ds.streaming_split(1)
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    seen = []
    t0 = time.perf_counter()
    for batch in shard.iter_batches(batch_size=1, device=dev):
        toks, tgt = batch["tokens"], batch["targets"]
        check(toks.device.type == torch.device(dev).type
              and toks.dtype == torch.int64 and tuple(toks.shape) == (1, S),
              f"a prefetched batch is {toks.device} {toks.dtype} "
              f"{tuple(toks.shape)}")
        host = toks.cpu().numpy()
        i = index.get(host[0].tobytes())
        check(i is not None and np.array_equal(
                  tgt.cpu().numpy()[0], np.roll(rows[i], -1)),
              "a prefetched batch differs from every host row")
        seen.append(i)
    wall = time.perf_counter() - t0
    st = dict(data.DataContext.get_current().last_prefetch_stats)
    check(sorted(seen) == list(range(PREFETCH_ROWS)),
          f"prefetched rows {seen}, expected each of {PREFETCH_ROWS} once")
    check(st["batches"] == PREFETCH_ROWS and st["bytes"] == 2 * rows.nbytes,
          f"prefetch stats {st}")
    cuda = dev != "cpu"
    if cuda:
        check(st["pinned"], "a staging tensor was not pinned")
        check(st["consumer_streams"] and st["copy_stream"]
              not in st["consumer_streams"],
              f"the copies ran on the consumer's stream: {st}")
        check(len(st["copy_ms"]) == PREFETCH_ROWS, f"copy times {st}")
    copy_s = sum(st["copy_ms"]) / 1e3
    return {"rows": PREFETCH_ROWS, "seq": S, "bytes": st["bytes"],
            "wall_s": wall, "pinned": st["pinned"],
            "copy_stream": st["copy_stream"],
            "consumer_streams": st["consumer_streams"],
            "copy_ms": st["copy_ms"],
            "copy_gb_s": st["bytes"] / copy_s / 1e9 if copy_s else None,
            "wait_ms": [w * 1e3 for w in st["wait_s"]]}


def _tune_rows(tokens, vocab: int, seed: int):
    """The sweep's dataset rows, one a step: the train phase's tokens,
    then rows from a seeded numpy generator."""
    row0 = tokens.detach().cpu().numpy().astype(np.int64)
    S = row0.shape[1]
    rest = np.random.default_rng(seed + 23).integers(
        0, vocab, (TUNE_STEPS - 1, S), dtype=np.int64)
    return np.concatenate([row0, rest])


def phase_data_tune(torch, report, seed: int, card: str, tokens,
                    first_loss: float, dev=None):
    """``ray_tpu_torch.data`` and ``tune`` on the card; see the module
    docstring's phase list.  ``tokens`` are the train phase's batch and
    ``first_loss`` the train gang's first loss on them.  ``dev="cpu"``
    rehearses it on the CPU with the tiny model (no card: no pinned
    memory, streams, launch counts or step comparison)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train, tune

    cpu = dev == "cpu"
    dstr = "cpu" if cpu else "cuda"
    cfg = _gang_cfg(dev)
    L = cfg.n_layers
    S = tokens.shape[1]
    out = {"card": card}
    if not cpu:
        gc.collect()
        torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix="rt_data_tune_")
    # A trial holds a CPU for its actor and one for its gang worker; the
    # dataset's tasks need CPUs beside them (the Tuner counts none for
    # them: on the CPU two trials at once would hold all of four).
    rt.init(num_cpus=6)
    try:
        pf = _prefetch_check(torch, data, S, cfg.vocab_size, seed, dstr)
        out["prefetch"] = pf
        waits = pf["wait_ms"]
        print(f"[data_tune] prefetch: {pf['rows']} rows of S={S} int64 "
              f"tokens (+ rolled targets) through from_numpy, map_batches, "
              f"streaming_split(1), iter_batches(batch_size=1, "
              f"device={dstr!r}): every batch equal to its host rows bit "
              f"for bit; staging pinned {pf['pinned']}, copy stream "
              f"{pf['copy_stream']} vs consumer {pf['consumer_streams']}; "
              f"{pf['bytes'] / 1e6:.3f} MB copied in "
              f"{sum(pf['copy_ms']):.3f} ms of copy-stream time ("
              + (f"{pf['copy_gb_s']:.2f} GB/s" if pf["copy_gb_s"]
                 else "no copies") +
              f"), consumer wait per batch {np.median(waits):.3f} ms median "
              f"({[round(w, 3) for w in waits]}); {card}", flush=True)
        rows = _tune_rows(tokens, cfg.vocab_size, seed)
        ds = data.from_numpy(rows, "tokens", override_num_blocks=len(rows))
        base = {"dev": dev, "seed": seed, "batch": 1, "seq": S,
                "steps": TUNE_STEPS, "scratch": scratch,
                "from_dataset": True}
        trainer = train.TorchTrainer(
            _gang_loop, train_loop_config=base,
            datasets={"train": ds},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=not cpu))
        t0, t0_wall = time.perf_counter(), time.time()
        results = tune.Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(TUNE_LRS))}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=train.RunConfig(name="sweep", storage_path=scratch),
        ).fit()
        out["fit_s"] = time.perf_counter() - t0
        trials = list(results)
        check(len(trials) == len(TUNE_LRS)
              and all(r.status == "TERMINATED" for r in trials),
              f"the sweep's trials: "
              f"{[(r.status, r.error) for r in trials]}")
        recs = []
        for r in trials:
            hist = r.metrics["history"]
            check([m["step"] for m in hist] == list(range(1, TUNE_STEPS + 1)),
                  f"trial {r.trial_id} reported steps "
                  f"{[m['step'] for m in hist]}")
            recs.append({
                "lr": r.config["train_loop_config"]["lr"],
                "losses": [m["loss"] for m in hist],
                "step_ms_each": [m["step_ms"] for m in hist],
                "step_ms": float(np.median([m["step_ms"] for m
                                            in hist[TUNE_WARM:]])),
                "data_wait_ms": [m["data_wait_s"] * 1e3 for m in hist],
                "host_each": [m["host"] for m in hist],
                "visible": r.metrics["visible"],
                "launches": r.metrics["launches"],
                "peak_gb": r.metrics["peak_gb"],
                "prefetch": r.metrics["prefetch"],
                "t_marks": r.metrics["t_marks"]})
        # Where the sweep's wall went, trial by trial: from the previous
        # trial's last step (or the sweep's start, for trials that ran at
        # once) to this loop's start (trial actor, trainer, gang worker,
        # imports), building the model, the steps; the rest is the last
        # trial's teardown.
        prev = t0_wall
        for t in sorted(recs, key=lambda t: t["t_marks"][0]):
            entry, built, done = t["t_marks"]
            t["spans_s"] = {"to_loop": entry - (prev if entry >= prev
                                                else t0_wall),
                            "build": built - entry, "steps": done - built}
            prev = max(prev, done)
        out["teardown_s"] = t0_wall + out["fit_s"] - prev
        out["trials"] = recs
        best = results.get_best_result()
        lowest = min(recs, key=lambda t: t["losses"][-1])
        out["best_lr"] = best.config["train_loop_config"]["lr"]
        for t in recs:
            print(f"[data_tune] trial lr={t['lr']:g}: one worker "
                  f"(CUDA_VISIBLE_DEVICES={t['visible']!r}), {L} layers, "
                  f"B=1 S={S}, {TUNE_STEPS} steps from the streamed "
                  f"dataset: losses {[round(x, 6) for x in t['losses']]}; "
                  f"step median {t['step_ms']:.1f} ms after {TUNE_WARM} "
                  f"warm steps "
                  f"({[round(x, 1) for x in t['step_ms_each']]}); data wait "
                  f"a round {[round(x, 3) for x in t['data_wait_ms']]} ms; "
                  f"peak {t['peak_gb']:.2f} GB; launches {t['launches']}; "
                  f"staging pinned {t['prefetch']['pinned']}; wall: "
                  + ", ".join(f"{k} {v:.1f} s"
                              for k, v in t["spans_s"].items())
                  + f"; {card}", flush=True)
            print(f"[data_tune] trial lr={t['lr']:g} host by step: "
                  + _host_line(t["host_each"]), flush=True)
        check(all(t["losses"][0] == first_loss for t in recs),
              f"a trial's first loss {[t['losses'][0] for t in recs]} "
              f"differs from the train gang's {first_loss!r}")
        check(recs[0]["losses"][1] != recs[1]["losses"][1],
              "both trials' step-2 losses are equal: the lr did not reach "
              "the loop")
        check(out["best_lr"] == lowest["lr"],
              f"get_best_result() named lr {out['best_lr']}, the lowest "
              f"final loss is lr {lowest['lr']}'s")
        counts = {k: sum(t["launches"][k] for t in recs)
                  for k in recs[0]["launches"]}
        out["launches"] = counts
        print(f"[data_tune] Tuner over TorchTrainer(datasets=...): "
              f"{len(recs)} trials in {out['fit_s']:.1f} s (last "
              f"teardown {out['teardown_s']:.1f} s), best lr "
              f"{out['best_lr']:g}; first loss {recs[0]['losses'][0]!r} "
              f"(train gang {first_loss!r})", flush=True)
        if not cpu:
            ref = report["train"]
            out["train_step_ms"] = ref["step_ms"]
            print(f"[data_tune] trial step medians "
                  f"{[round(t['step_ms'], 1) for t in recs]} ms vs the "
                  f"train phase's {ref['step_ms']:.1f} ms in this call "
                  f"({[round(t['step_ms'] / ref['step_ms'], 3) for t in recs]}"
                  f"x); {card}", flush=True)
            for t in recs:
                check(t["visible"] not in (None, ""),
                      f"trial lr={t['lr']} ran on a worker granted no card")
                check(t["launches"] == _train_launches(L, TUNE_STEPS),
                      f"trial lr={t['lr']} launches {t['launches']}, "
                      f"expected {_train_launches(L, TUNE_STEPS)}")
                pst = t["prefetch"]
                check(pst["pinned"] and pst["copy_stream"]
                      not in pst["consumer_streams"],
                      f"trial lr={t['lr']}'s prefetch: {pst}")
                check(t["step_ms"] <= GANG_SLOWER_MAX * ref["step_ms"],
                      f"trial lr={t['lr']}'s step {t['step_ms']:.1f} ms is "
                      f"over {GANG_SLOWER_MAX}x the train phase's")
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    report["data_tune"] = out


# ---------------------------------------------------------- rllib drivers


class _NatureFrames:
    """Frames of the Nature-CNN input shape (84 x 84 x 4 in [0, 1]), six
    actions, a seeded reward of 1 with probability 0.1 a step, episodes
    truncated at 128 steps: drives PPO's runners and CNN learner at the
    Atari widths with no emulator."""

    observation_shape = (84, 84, 4)
    observation_size = 84 * 84 * 4
    num_actions = 6

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _frame(self):
        return self._rng.random(self.observation_shape, dtype=np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._frame()

    def step(self, action):
        self._t += 1
        return (self._frame(), float(self._rng.random() < 0.1), False,
                self._t >= 128)


_ALGO_LOSSES = ("policy_loss", "vf_loss", "entropy", "total_loss")


def _algo_run(algo, n: int):
    """``n`` iterations of ``algo.train()``: (results, wall seconds each);
    the algorithm is stopped after."""
    out, walls = [], []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            out.append(algo.train())
            walls.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    return out, walls


def _learner_on(learner) -> str:
    return next(learner.params.parameters()).device.type


def _ppo_cartpole_runs(rllib, seed: int, dev):
    """PPO on CartPole at ``PPOConfig``'s defaults with the learner on
    ``dev``: (its device type, 3 iterations' results, their walls)."""
    cfg = rllib.PPOConfig().environment("CartPole-v1")
    cfg.seed, cfg.device = seed, dev
    algo = cfg.build()
    return (_learner_on(algo.learner), *_algo_run(algo, 3))


def phase_rllib_algos(torch, report, seed: int, card: str, dev=None):
    """rllib's algorithm drivers on the card; see the module docstring's
    phase list.  ``dev="cpu"`` rehearses it with every learner on the
    CPU."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib

    cpu = dev == "cpu"
    out = {"card": card}
    want = "cpu" if cpu else "cuda"
    _reset_counts()
    rt.init(num_cpus=6)
    try:
        # (a) PPO on CartPole at PPOConfig's defaults, learner on the card,
        # then the same driver with the learner on the CPU.
        on, card_res, card_w = _ppo_cartpole_runs(rllib, seed, dev)
        _, cpu_res, cpu_w = _ppo_cartpole_runs(rllib, seed, "cpu")
        check(on == want, f"PPO's learner ran on {on}")
        worst = 0.0
        for c, p in zip(card_res, cpu_res):
            check(c["num_env_steps_sampled"] == p["num_env_steps_sampled"]
                  and (c["episode_return_mean"] == p["episode_return_mean"]
                       or (np.isnan(c["episode_return_mean"])
                           and np.isnan(p["episode_return_mean"]))),
                  f"PPO card vs CPU: env steps or returns differ: "
                  f"{c['num_env_steps_sampled']}/{p['num_env_steps_sampled']}"
                  f" {c['episode_return_mean']}/{p['episode_return_mean']}")
            for k in _ALGO_LOSSES:
                worst = max(worst, abs(c[k] - p[k])
                            / (RL_LOSS_REL * abs(p[k]) + RL_LOSS_FLOOR))
        out["ppo"] = {
            "iterations": len(card_res), "learner": on,
            "wall_s": card_w, "cpu_wall_s": cpu_w,
            "env_steps": [r["num_env_steps_sampled"] for r in card_res],
            "returns": [r["episode_return_mean"] for r in card_res],
            "env_steps_per_s": [r["env_steps_per_sec"] for r in card_res],
            "learn_s": [r["time_learn_s"] for r in card_res],
            "cpu_learn_s": [r["time_learn_s"] for r in cpu_res],
            "loss_ratio": worst,
            "losses": [{k: r[k] for k in _ALGO_LOSSES} for r in card_res]}
        print(f"[rllib_algos] PPO CartPole (PPOConfig defaults: 2 runner "
              f"actors x 8 envs x 64 steps, 10 epochs x minibatch 256), "
              f"learner on {on}: 3 iterations, wall "
              f"{[round(w, 3) for w in card_w]} s, learn "
              f"{[round(x, 3) for x in out['ppo']['learn_s']]} s (CPU "
              f"learner {[round(x, 3) for x in out['ppo']['cpu_learn_s']]}"
              f" s), env steps/s "
              f"{[round(x) for x in out['ppo']['env_steps_per_s']]}; returns"
              f" {out['ppo']['returns']} equal to the CPU learner's; worst "
              f"loss error / ({RL_LOSS_REL} rel + {RL_LOSS_FLOOR}) "
              f"{worst:.3g}; {card}", flush=True)
        check(worst <= 1.0, f"PPO card vs CPU losses: ratio {worst}")

        # (b) One iteration at the Nature-CNN Atari widths (the rllib
        # phase's settings): 2 runners x 4 envs x 128 frames, 3 epochs x
        # 256.
        c = RL_ATARI
        model = rllib.CNNModel(c["obs"], c["actions"],
                               channels=c["channels"], kernels=c["kernels"],
                               strides=c["strides"], dense=c["dense"])
        cfg = (rllib.PPOConfig().environment(_NatureFrames)
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=128)
               .training(lr=c["lr"], clip_param=0.1, entropy_coeff=0.01,
                         num_epochs=c["epochs"],
                         minibatch_size=c["minibatch"], model=model,
                         device=dev))
        cfg.vf_coeff, cfg.seed = 1.0, seed
        algo = cfg.build()
        on = _learner_on(algo.learner)
        (m,), (w,) = _algo_run(algo, 1)
        out["atari"] = {"learner": on, "wall_s": w,
                        "frames": m["num_env_steps_sampled"],
                        "time_sample_s": m["time_sample_s"],
                        "time_learn_s": m["time_learn_s"],
                        **{k: m[k] for k in _ALGO_LOSSES}}
        print(f"[rllib_algos] PPO Nature-CNN (84x84x4, {c['channels']} "
              f"convs, dense {c['dense']}), learner on {on}: one iteration "
              f"of {m['num_env_steps_sampled']} frames in {w:.2f} s "
              f"(sample {m['time_sample_s']:.2f} s, learn "
              f"{m['time_learn_s']:.3f} s); loss {m['total_loss']:.5f}; "
              f"{card}", flush=True)
        check(on == want and m["num_env_steps_sampled"] == 1024
              and all(np.isfinite(m[k]) for k in _ALGO_LOSSES),
              f"PPO Nature-CNN iteration: {out['atari']}")

        # (c) One iteration each of DQN, IMPALA, SAC and MultiAgentPPO.
        builds = {
            "dqn": (rllib.DQNConfig().environment("CartPole-v1")
                    .training(learning_starts=0, device=dev, seed=seed),
                    ("loss", "td_error_mean", "qf_mean")),
            "impala": (rllib.ImpalaConfig().environment("CartPole-v1")
                       .training(device=dev),
                       _ALGO_LOSSES + ("mean_rho",)),
            "sac": (rllib.SACConfig().training(warmup_steps=0, device=dev,
                                               seed=seed),
                    ("critic_loss", "actor_loss", "alpha")),
            "multi_agent": (
                rllib.MultiAgentPPOConfig()
                .environment("MultiAgentCartPole", num_agents=2)
                .multi_agent(policies=["p0", "p1"],
                             policy_mapping_fn=lambda a: "p" + a[-1])
                .training(device=dev, seed=seed), None)}
        for name, (cfg, keys) in builds.items():
            algo = cfg.build()
            learners = (algo.learners.values() if name == "multi_agent"
                        else [algo.learner])
            ons = sorted({_learner_on(ln) for ln in learners})
            (m,), (w,) = _algo_run(algo, 1)
            if keys is None:
                vals = {f"{pid}.{k}": v for pid, pm in m["policies"].items()
                        for k, v in pm.items() if k in _ALGO_LOSSES}
            else:
                vals = {k: m[k] for k in keys if k in m}
            rec = {"learner": ons, "wall_s": w, **vals,
                   "env_steps": m["num_env_steps_sampled_lifetime"]}
            out[name] = rec
            print(f"[rllib_algos] {name}: one iteration, learner on {ons}, "
                  f"{rec['env_steps']} env steps in {w:.2f} s; "
                  + ", ".join(f"{k} {v:.5g}" for k, v in vals.items())
                  + f"; {card}", flush=True)
            check(ons == [want] and vals and len(vals) >= (
                      len(keys) if keys else 8)
                  and all(np.isfinite(v) for v in vals.values()),
                  f"{name}: the learner did not update on {want}: {rec}")
    finally:
        rt.shutdown()
    counts = _read_counts()
    out["launches"] = counts
    check(not any(counts.values()),
          f"a csrc kernel launched on the rllib drivers' path: {counts}")
    report["rllib_algos"] = out


# ---------------------------------------------------------------- parallel
#
# Four ranks on the one card.  NCCL refuses two ranks on one device, so
# they join a gloo group through a FileStore; gloo carries the collectives
# of CUDA tensors through pinned host memory (``collective/mesh_ops.py``),
# and every tensor of the computation stays on the card.  The ranks share
# the card, so their step times are not a scaling figure.

PAR_WORLD = 4
#: Sub-steps of the parallel phase, in the order the ranks run them.
PAR_STEPS = ("ring", "sharded", "seq_sharded", "pipeline", "moe_ep")


def _par_reset():
    """Zero the launch counts and the collectives' traffic."""
    from ray_tpu_torch.collective import mesh_ops

    _reset_counts()
    mesh_ops.traffic.update(calls=0, bytes=0, seconds=0.0)


def _par_read():
    """(launch counts, a copy of the collectives' traffic)."""
    from ray_tpu_torch.collective import mesh_ops

    return _read_counts(), dict(mesh_ops.traffic)


def _par_gen(torch, seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def _par_llama(n_layers: int):
    from ray_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama3_8b(max_seq=8192),
                               n_layers=n_layers)


def _par_batch(torch, vocab: int, B: int, S: int, seed: int):
    tokens = torch.randint(0, vocab, (B, S), generator=_par_gen(torch, seed),
                           device="cuda")
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def _par_ring_inputs(torch, seed: int):
    """q, k, v, dO at B 1, H 32, Hkv 8, D 128, S 8192, bf16."""
    g = _par_gen(torch, seed)
    shapes = ((1, 32, 8192, 128), (1, 8, 8192, 128), (1, 8, 8192, 128),
              (1, 32, 8192, 128))
    return [torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
            for s in shapes]


#: (layers, mesh, batch, seq, steps, sp_shard_seq) of the Llama sub-steps.
_PAR_LLAMA = {
    "sharded": (1, dict(fsdp=2, tp=2), 2, 2048, 1, False),
    "seq_sharded": (1, dict(fsdp=1, sp=4), 1, 8192, 1, True),
}
_PAR_PIPE = dict(layers=4, pp=4, n_micro=4, batch=4, seq=2048)
_PAR_MOE = dict(layers=1, mesh=dict(fsdp=1, tp=2, ep=2), batch=1, seq=2048,
                steps=1)
_PAR_LR = 1e-4


def _par_steps(torch, cfg, loss_fn, params, batch, steps, mesh=None,
               rules=None, sp_shard_seq=False):
    """``steps`` AdamW steps of ``make_train_step``: (state, losses, grad
    norms, each step's seconds)."""
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step,
                                                  shard_train_state)

    tx = default_optimizer(lr=_PAR_LR)
    state = TrainState.create(params, tx)
    if mesh is not None:
        state = shard_train_state(state, mesh, rules)
    step = make_train_step(loss_fn, tx, mesh, rules,
                           sp_shard_seq=sp_shard_seq)
    losses, norms, times = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    return state, losses, norms, times


def _par_record_routes(moe_mod):
    """Wrap ``moe._route`` to keep the expert choices of its first call (the
    step's forward; the remat recompute calls it again): (records,
    restore)."""
    rec, original = [], moe_mod._route

    def recording(*args):
        out = original(*args)
        if not rec:
            rec.append((out[0].detach().float().cpu(),
                        out[2].detach().cpu()))
        return out

    moe_mod._route = recording

    def restore():
        moe_mod._route = original

    return rec, restore


def _par_refs(torch, seed: int, tmp: str):
    """The references, unsharded on the card in this process: each saved
    to ``tmp`` and freed before the ranks start.  Returns their times."""
    from ray_tpu_torch.models import moe as moe_mod
    from ray_tpu_torch.models.llama import llama_init, llama_loss
    from ray_tpu_torch.models.moe import MoEConfig, moe_init, moe_loss
    from ray_tpu_torch.ops.attention import flash_attention

    times = {}

    def save(name, obj):
        torch.save(obj, os.path.join(tmp, f"{name}.pt"))
        gc.collect()
        torch.cuda.empty_cache()

    q, k, v, do = _par_ring_inputs(torch, seed + 20)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    times["ring"] = time.perf_counter() - t0
    save("ring", {"out": out.detach().cpu(), "dq": q.grad.cpu(),
                  "dk": k.grad.cpu(), "dv": v.grad.cpu()})
    del q, k, v, do, out

    for name, (L, _, B, S, steps, _) in _PAR_LLAMA.items():
        cfg = _par_llama(L)
        params = llama_init(cfg, _par_gen(torch, seed + 21), trainable=True)
        batch = _par_batch(torch, cfg.vocab_size, B, S, seed + 22)
        state, losses, norms, step_s = _par_steps(
            torch, cfg, lambda p, b: llama_loss(cfg, p, b["tokens"],
                                                b["targets"]),
            params, batch, steps)
        times[name] = step_s[-1]
        save(name, {"losses": losses, "norms": norms,
                    "params": {n: p.detach().cpu() for n, p in
                               state.params.named_parameters()}})
        del params, state, batch

    cfg = _par_llama(_PAR_PIPE["layers"])
    params = llama_init(cfg, _par_gen(torch, seed + 21), trainable=True)
    batch = _par_batch(torch, cfg.vocab_size, _PAR_PIPE["batch"],
                       _PAR_PIPE["seq"], seed + 22)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = llama_loss(cfg, params, batch["tokens"], batch["targets"])
    loss.backward()
    torch.cuda.synchronize()
    times["pipeline"] = time.perf_counter() - t0
    save("pipeline", {"loss": float(loss.detach()),
                      "grads": {n: p.grad.cpu() for n, p in
                                params.named_parameters()}})
    del params, batch, loss

    cfg = MoEConfig.mixtral_8x7b(n_layers=_PAR_MOE["layers"])
    params = moe_init(cfg, _par_gen(torch, seed + 24), trainable=True)
    batch = _par_batch(torch, cfg.vocab_size, _PAR_MOE["batch"],
                       _PAR_MOE["seq"], seed + 25)
    rec, restore = _par_record_routes(moe_mod)
    try:
        state, losses, norms, step_s = _par_steps(
            torch, cfg, lambda p, b: moe_loss(cfg, p, b["tokens"],
                                              b["targets"]),
            params, batch, _PAR_MOE["steps"])
    finally:
        restore()
    times["moe_ep"] = step_s[-1]
    save("moe_ep", {"losses": losses, "norms": norms, "probs": rec[0][0],
                    "top_e": rec[0][1],
                    "params": {n: p.detach().cpu() for n, p in
                               state.params.named_parameters()}})
    del params, state, batch
    return times


def _par_slices(p):
    """The slices of the global tensor that DTensor ``p``'s local shard
    holds (even shards; the mesh dims that split one tensor dim, outer
    first)."""
    from torch.distributed.tensor import Shard

    idx, parts = [0] * p.ndim, [1] * p.ndim
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard):
            n = p.device_mesh.size(i)
            idx[pl.dim] = idx[pl.dim] * n + p.device_mesh.get_local_rank(i)
            parts[pl.dim] *= n
    return tuple(slice(j * d // k, (j + 1) * d // k)
                 for j, k, d in zip(idx, parts, p.shape))


def _par_param_err(torch, params, ref, steps: int):
    """Every local parameter shard against the same slice of the unsharded
    run's parameter after ``steps`` AdamW steps.  Two bf16 runs whose
    gradients differ by rounding may move an element by up to lr (Adam's
    step is at most ~lr an element whatever the gradient) the other way,
    and each of their stored values is rounded to bf16 once a step (half
    an ulp, at most 2^-8 of the value rounded): |got - ref| <= 2 steps lr
    (1.01) + 2^-6 (|ref| + 2 steps lr) bounds it.  Compared in chunks of
    2^24 elements, so four ranks' temporaries fit beside their states.
    Returns (the worst |got - ref| / bound, the worst |got - ref|, tensors
    compared)."""
    worst_ratio, worst_abs = 0.0, 0.0
    lr_part = 2 * steps * _PAR_LR
    with torch.no_grad():
        for name, p in params.named_parameters():
            got = p.to_local().reshape(-1)
            r = ref[name][_par_slices(p)].contiguous().reshape(-1)
            for a in range(0, got.numel(), 1 << 24):
                g = got[a:a + (1 << 24)].float()
                rc = r[a:a + (1 << 24)].to(g.device).float()
                diff = (g - rc).abs()
                bound = lr_part * 1.01 + 2.0 ** -6 * (rc.abs() + lr_part)
                worst_ratio = max(worst_ratio, float((diff / bound).max()))
                worst_abs = max(worst_abs, float(diff.max()))
    return worst_ratio, worst_abs, len(ref)


def _par_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _par_ring(torch, rank: int, seed: int, tmp: str, mesh):
    """(a) ``ring_attention`` forward and backward on this rank's chunk of
    the S 8192 sequence against the reference's chunk."""
    from ray_tpu_torch.ops.ring_attention import ring_attention

    q, k, v, do = _par_ring_inputs(torch, seed + 20)
    n = 8192 // PAR_WORLD
    rows = slice(rank * n, (rank + 1) * n)
    q, k, v, do = (t[:, :, rows].contiguous() for t in (q, k, v, do))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    for timed in (False, True):  # a warm call, then the counted one
        q.grad = k.grad = v.grad = None
        _par_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, axis_name="sp", causal=True,
                             mesh=mesh)
        out.backward(do)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, comm = _par_read()
    ref = torch.load(os.path.join(tmp, "ring.pt"), weights_only=True,
                     mmap=True)
    errs = {}
    for name, got in (("out", out), ("dq", q.grad), ("dk", k.grad),
                      ("dv", v.grad)):
        r = ref[name][:, :, rows].to("cuda").float()
        g = got.detach().float()
        check(bool(torch.isfinite(g).all()), f"ring {name} not finite")
        errs[name] = {"max_abs_err": float((g - r).abs().max()),
                      "rel_norm_err": float((g - r).norm() / r.norm())}
    return {"wall_s": wall, "launches": counts, "comm": comm, "errs": errs}


def _par_llama_step(torch, rank: int, seed: int, tmp: str, name: str):
    """(b) and (c): the sharded ``make_train_step(llama_loss)`` steps against
    the unsharded ones."""
    from ray_tpu_torch.models.llama import (llama_init, llama_loss,
                                            llama_sharding_rules)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    L, mcfg, B, S, steps, sp_shard_seq = _PAR_LLAMA[name]
    cfg = _par_llama(L)
    mesh = make_mesh(MeshConfig(**mcfg))
    params = llama_init(cfg, _par_gen(torch, seed + 21), trainable=True)
    batch = _par_batch(torch, cfg.vocab_size, B, S, seed + 22)
    _par_reset()
    state, losses, norms, step_s = _par_steps(
        torch, cfg, lambda p, b: llama_loss(cfg, p, b["tokens"],
                                            b["targets"]),
        params, batch, steps, mesh, llama_sharding_rules(), sp_shard_seq)
    counts, comm = _par_read()
    del state  # AdamW's moments: room for the comparison
    ref = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=True,
                     mmap=True)
    ratio, worst, n = _par_param_err(torch, params, ref["params"], steps)
    wq = params.layers[0].attn.wq
    return {"step_s": step_s, "launches": counts, "comm": comm,
            "losses": losses,
            "norms": norms, "ref_losses": ref["losses"],
            "ref_norms": ref["norms"], "param_ratio": ratio,
            "param_max_abs_err": worst, "params_compared": n,
            "wq_local": list(wq.to_local().shape), "wq": list(wq.shape)}


def _par_pipeline(torch, rank: int, seed: int, tmp: str):
    """(d) ``make_pp_loss`` over pp 4: the loss and every gradient this
    rank holds against ``llama_loss``'s."""
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.parallel import (MeshConfig, make_mesh, make_pp_loss,
                                        pp_sharding_spec, shard_pytree,
                                        stack_layers)

    c = _PAR_PIPE
    cfg = _par_llama(c["layers"])
    mesh = make_mesh(MeshConfig(fsdp=1, pp=c["pp"]))
    params = llama_init(cfg, _par_gen(torch, seed + 21), trainable=True)
    stacked = stack_layers(params)
    del params
    stacked = shard_pytree(stacked, mesh, pp_sharding_spec(stacked))
    batch = _par_batch(torch, cfg.vocab_size, c["batch"], c["seq"],
                       seed + 22)
    loss_fn = make_pp_loss(cfg, mesh, n_micro=c["n_micro"])
    leaves = [t for t in stacked.values() if torch.is_tensor(t)] + [
        t for part in stacked["layers"].values()
        for t in (part.values() if isinstance(part, dict) else [part])]
    for timed in (False, True):  # a warm call, then the counted one
        for t in leaves:
            t.grad = None
        _par_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(stacked, batch["tokens"], batch["targets"])
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, comm = _par_read()
    ref = torch.load(os.path.join(tmp, "pipeline.pt"), weights_only=True,
                     mmap=True)
    per = c["layers"] // c["pp"]
    stage = mesh.get_local_rank("pp")
    rel = {}

    def leaf(tree, path):
        for key in path:
            tree = tree[key]
        return tree.grad.to_local()

    for name, r in ref["grads"].items():
        parts = name.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            if i // per != stage:
                continue
            got = leaf(stacked["layers"], parts[2:])[i % per]
        else:
            got = leaf(stacked, parts)
        check(bool(torch.isfinite(got).all()), f"pipeline {name} grad "
                                               f"not finite")
        # In chunks of 2^24 elements, as _par_param_err.
        got, r = got.reshape(-1), r.reshape(-1)
        d2 = r2 = 0.0
        for a in range(0, got.numel(), 1 << 24):
            g = got[a:a + (1 << 24)].float()
            rc = r[a:a + (1 << 24)].to(g.device).float()
            d2 += float(((g - rc) ** 2).sum())
            r2 += float((rc ** 2).sum())
        rel[name] = (d2 / r2) ** 0.5
    return {"wall_s": wall, "launches": counts, "comm": comm,
            "loss": float(loss.detach()),
            "ref_loss": ref["loss"], "grad_rel": rel}


def _par_moe(torch, rank: int, seed: int, tmp: str):
    """(e) the MoE step at ep 2 x tp 2 against the unsharded step, with
    the expert choices of its forward."""
    from ray_tpu_torch.models import moe as moe_mod
    from ray_tpu_torch.models.moe import (MoEConfig, moe_init, moe_loss,
                                          moe_sharding_rules)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    c = _PAR_MOE
    cfg = MoEConfig.mixtral_8x7b(n_layers=c["layers"])
    mesh = make_mesh(MeshConfig(**c["mesh"]))
    params = moe_init(cfg, _par_gen(torch, seed + 24), trainable=True)
    batch = _par_batch(torch, cfg.vocab_size, c["batch"], c["seq"],
                       seed + 25)
    rec, restore = _par_record_routes(moe_mod)
    _par_reset()
    try:
        state, losses, norms, step_s = _par_steps(
            torch, cfg, lambda p, b: moe_loss(cfg, p, b["tokens"],
                                              b["targets"]),
            params, batch, c["steps"], mesh, moe_sharding_rules())
    finally:
        restore()
    counts, comm = _par_read()
    del state  # AdamW's moments: room for the comparison
    ref = torch.load(os.path.join(tmp, "moe_ep.pt"), weights_only=True,
                     mmap=True)
    ratio, worst, n = _par_param_err(torch, params, ref["params"],
                                     c["steps"])
    top = ref["probs"].sort(dim=-1, descending=True).values
    margin = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
    flipped = (rec[0][1].sort(-1).values
               != ref["top_e"].sort(-1).values).any(-1)
    w1 = params.layers[0].moe.w1
    return {"step_s": step_s, "launches": counts, "comm": comm,
            "losses": losses,
            "norms": norms, "ref_losses": ref["losses"],
            "ref_norms": ref["norms"], "param_ratio": ratio,
            "param_max_abs_err": worst, "params_compared": n,
            "flipped_tokens": flipped.nonzero()[:, 0].tolist(),
            "flipped_margins": margin[flipped].tolist(),
            "min_margin": float(margin.min()),
            "w1_local": list(w1.to_local().shape), "w1": list(w1.shape)}


def _par_rank(rank: int, seed: int, tmp: str):
    """One rank of the parallel phase: the five sub-steps in turn, each
    with its launch counts zeroed just before its main path and read just
    after; the card freed between them."""
    import torch

    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in PAR_STEPS:
        if name == "ring":
            mesh = make_mesh(MeshConfig(fsdp=1, sp=PAR_WORLD))
            out[name] = _par_ring(torch, rank, seed, tmp, mesh)
        elif name in _PAR_LLAMA:
            out[name] = _par_llama_step(torch, rank, seed, tmp, name)
        elif name == "pipeline":
            out[name] = _par_pipeline(torch, rank, seed, tmp)
        else:
            out[name] = _par_moe(torch, rank, seed, tmp)
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["imports"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "ray_tpu"))
    return out


def _par_expected(name: str):
    """Launches of each kernel on one rank's main path of sub-step
    ``name``: per ring step and layer K1 forward, K2 and K3 backward."""
    n = PAR_WORLD
    if name == "ring":
        return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "rms_norm": 0, "rms_norm_bwd": 0}
    if name in _PAR_LLAMA:
        L, mcfg, _, _, steps, sp_shard_seq = _PAR_LLAMA[name]
        want = _train_launches(L, steps)
        ring = mcfg.get("sp", 1) if sp_shard_seq else 1
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            want[k] *= ring
        return want
    if name == "pipeline":
        c = _PAR_PIPE
        t = (c["n_micro"] + c["pp"] - 1) * c["layers"] // c["pp"]
        return {"flash_fwd": t, "flash_bwd_dq": t, "flash_bwd_dkv": t,
                "rms_norm": 2 * t + 1, "rms_norm_bwd": 2 * t + 1}
    return _train_launches(_PAR_MOE["layers"], _PAR_MOE["steps"])


def phase_parallel(torch, report, seed: int, card: str):
    """Ring attention, the sharded and sequence-sharded Llama steps, the
    GPipe pipeline and the expert-parallel MoE step, by four ranks on the
    one card, each against its unsharded reference computed first in this
    process (see the section's comment)."""
    from ray_tpu_torch import _build
    from ray_tpu_torch.parallel import spawn_ranks

    # The ranks load the kernels phase_build compiled; none may run nvcc.
    missing = [n for n in _build.KERNELS if not _build._lib_path(n).exists()]
    check(not missing, f"kernels not built before the ranks start: "
                       f"{missing}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ref_s = _par_refs(torch, seed, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = spawn_ranks(_par_rank, PAR_WORLD, seed, tmp,
                            store=os.path.join(tmp, "store"),
                            backend="gloo", cuda_device=0, timeout_s=600)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"refs_s": t1 - t0, "ranks_s": t2 - t1, "ref_times_s": ref_s,
           "peak_gb": [r["peak_gb"] for r in ranks], "card": card}
    check(all(not r["imports"] for r in ranks),
          f"a rank imported JAX or the JAX package: "
          f"{[r['imports'] for r in ranks]}")
    U = 2.0 ** -8
    tols = {"ring_rel_norm": 2 * U, "loss_rel": 1e-2, "grad_norm_rel": 2e-2,
            "pipeline_grad_rel": 5e-2, "param_ratio": 1.0}
    out["tolerances"] = tols
    for name in PAR_STEPS:
        per = [r[name] for r in ranks]
        want = _par_expected(name)
        counts = {k: sum(p["launches"][k] for p in per) for k in want}
        check(all(p["launches"] == want for p in per),
              f"parallel {name}: launches per rank "
              f"{[p['launches'] for p in per]}, expected {want} each")
        rec = {"launches": counts, "ranks": per,
               "ref_s": ref_s[name]}
        if name == "ring":
            worst = {k: max(p["errs"][k]["rel_norm_err"] for p in per)
                     for k in ("out", "dq", "dk", "dv")}
            rec["worst_rel_norm_err"] = worst
            rec["max_abs_err"] = max(p["errs"][k]["max_abs_err"]
                                     for p in per for k in worst)
            msg = (f"out/dQ/dK/dV relative norm error by chunk, worst "
                   f"{json.dumps({k: round(v, 6) for k, v in worst.items()})}"
                   f" (tol {tols['ring_rel_norm']})")
            check(max(worst.values()) <= tols["ring_rel_norm"],
                  f"ring attention disagrees with flash attention: {worst}")
            times = [p["wall_s"] for p in per]
        elif name == "pipeline":
            loss_rel = max(_par_rel(p["loss"], p["ref_loss"]) for p in per)
            grad = {}
            for p in per:
                grad.update({n: max(e, grad.get(n, 0.0))
                             for n, e in p["grad_rel"].items()})
            worst = sorted(grad.items(), key=lambda kv: -kv[1])[:3]
            rec.update(loss_rel=loss_rel, grad_rel=grad,
                       grads_compared=len(grad))
            msg = (f"loss {per[0]['loss']:.5f} vs {per[0]['ref_loss']:.5f} "
                   f"(rel {loss_rel:.3g}, tol {tols['loss_rel']}); "
                   f"{len(grad)} gradients, worst rel norm err "
                   + ", ".join(f"{n} {e:.4g}" for n, e in worst)
                   + f" (tol {tols['pipeline_grad_rel']})")
            check(loss_rel <= tols["loss_rel"]
                  and max(grad.values()) <= tols["pipeline_grad_rel"]
                  and len(grad) == 4 * 9 + 3,
                  f"the pipeline disagrees with llama_loss: {msg}")
            times = [p["wall_s"] for p in per]
        else:
            p0 = per[0]
            loss_rel = max(_par_rel(a, b) for p in per
                           for a, b in zip(p["losses"], p["ref_losses"]))
            norm_rel = max(_par_rel(a, b) for p in per
                           for a, b in zip(p["norms"], p["ref_norms"]))
            ratio = max(p["param_ratio"] for p in per)
            rec.update(loss_rel=loss_rel, grad_norm_rel=norm_rel,
                       param_ratio=ratio,
                       param_max_abs_err=max(p["param_max_abs_err"]
                                             for p in per))
            msg = (f"losses {[round(x, 5) for x in p0['losses']]} vs "
                   f"{[round(x, 5) for x in p0['ref_losses']]} (rel "
                   f"{loss_rel:.3g}, tol {tols['loss_rel']}); grad norms "
                   f"{[round(x, 4) for x in p0['norms']]} vs "
                   f"{[round(x, 4) for x in p0['ref_norms']]} (rel "
                   f"{norm_rel:.3g}, tol {tols['grad_norm_rel']}); "
                   f"{p0['params_compared']} parameters, worst error / "
                   f"bound {ratio:.3g} (max abs "
                   f"{rec['param_max_abs_err']:.3g})")
            check(loss_rel <= tols["loss_rel"]
                  and norm_rel <= tols["grad_norm_rel"] and ratio <= 1.0,
                  f"parallel {name} disagrees with the unsharded step: "
                  f"{msg}")
            if name == "sharded":
                check(all(p["wq_local"] == [d // 2 for d in p["wq"]]
                          for p in per),
                      f"a local wq shard is not a quarter of "
                      f"{p0['wq']}: {[p['wq_local'] for p in per]}")
                msg += f"; wq local {p0['wq_local']} of {p0['wq']}"
            if name == "moe_ep":
                rec.update({k: p0[k] for k in ("flipped_tokens",
                                               "flipped_margins",
                                               "min_margin")})
                msg += (f"; w1 local {p0['w1_local']} of {p0['w1']}; tokens "
                        f"whose experts differ from the reference's "
                        f"{p0['flipped_tokens'][:10]} with router margins "
                        f"{[round(x, 5) for x in p0['flipped_margins'][:10]]}"
                        f" (smallest margin {p0['min_margin']:.3g})")
            times = [p["step_s"] for p in per]
        rec["rank_times_s"] = times
        rec["comm"] = [p["comm"] for p in per]
        out[name] = rec
        shown = [[round(x * 1e3, 1) for x in t] if isinstance(t, list)
                 else round(t * 1e3, 1) for t in times]
        c0 = per[0]["comm"]
        msg += (f"; rank 0's collectives over the timed run: "
                f"{c0['seconds']:.3f} s in {c0['calls']} calls, "
                f"{c0['bytes'] / 1e9:.3f} GB handed in (gloo, through "
                f"pinned host memory)")
        print(f"[parallel] {name}: {msg}; per-rank "
              + ("step times (each step)" if name in ("sharded",
                                                      "seq_sharded",
                                                      "moe_ep")
                 else "time of a warm call")
              + f" {shown} ms (four ranks share one card, not a scaling "
              f"figure; {card}); unsharded reference "
              f"{ref_s[name] * 1e3:.1f} ms; launches {counts}", flush=True)
    print(f"[parallel] references {out['refs_s']:.1f} s, four ranks "
          f"{out['ranks_s']:.1f} s (spawn included); peak memory by rank "
          f"{[round(g, 2) for g in out['peak_gb']]} GB", flush=True)
    report["parallel"] = out


def _timed(report, name: str, fn, *args):
    """``fn(*args)``, its wall seconds printed and kept in the report."""
    t0 = time.perf_counter()
    out = fn(*args)
    secs = time.perf_counter() - t0
    report.setdefault("phase_s", {})[name] = secs
    print(f"[time] {name}: {secs:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", help="also write every phase's numbers "
                    "to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import ray_tpu_torch ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    report = {"card": card}
    t_all = time.perf_counter()
    seed = args.seed
    _timed(report, "build", phase_build, report)
    _timed(report, "rms", phase_rms, torch, report)
    _timed(report, "flash", phase_flash, torch, report)
    _timed(report, "flash_bwd", phase_flash_bwd, torch, report)
    _timed(report, "tiny_serve", phase_tiny_serve, torch, report, seed)
    cfg, params = _timed(report, "forward", phase_forward, torch, report,
                         seed)
    for name, phase in (("serve", phase_serve),
                        ("serve_profile", phase_serve_profile),
                        ("observe", phase_observe),
                        ("multitenant", phase_multitenant)):
        _timed(report, name, phase, torch, report, cfg, params, seed)
    _timed(report, "runtime", phase_runtime, torch, report, cfg, params,
           seed, card)
    _timed(report, "autoscale", phase_autoscale, torch, report, cfg, params,
           seed, card)
    _timed(report, "serve_front", phase_serve_front, torch, report, seed,
           card)
    del params  # the serving model makes room for training
    gc.collect()
    torch.cuda.empty_cache()
    cfg, tokens, state = _timed(report, "train", phase_train, torch, report,
                                seed)
    deferred = _timed(report, "remat", phase_remat, torch, report, cfg,
                      state, tokens)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _timed(report, "remat_shallow", phase_remat_shallow, torch, report, cfg,
           tokens, deferred, seed)
    _timed(report, "train_check", phase_train_check, torch, report, cfg,
           tokens, seed)
    _timed(report, "remat_check", phase_remat_check, torch, report, cfg,
           tokens, seed)
    gc.collect()
    torch.cuda.empty_cache()
    moe_cfg, moe_tokens = _timed(report, "moe", phase_moe, torch, report,
                                 seed)
    gc.collect()
    torch.cuda.empty_cache()
    _timed(report, "moe_check", phase_moe_check, torch, report, moe_cfg,
           moe_tokens, seed)
    _timed(report, "mlp", phase_mlp, torch, report, seed)
    gc.collect()
    torch.cuda.empty_cache()
    _timed(report, "rllib", phase_rllib, torch, report, seed)
    gc.collect()
    torch.cuda.empty_cache()
    _timed(report, "train_gang", phase_train_gang, torch, report, seed, card)
    _timed(report, "data_tune", phase_data_tune, torch, report, seed, card,
           tokens, report["train_gang"]["losses"][0])
    del tokens
    _timed(report, "rllib_algos", phase_rllib_algos, torch, report, seed,
           card)
    gc.collect()
    torch.cuda.empty_cache()
    _timed(report, "parallel", phase_parallel, torch, report, seed, card)
    report["total_s"] = time.perf_counter() - t_all

    paths = {path: report[path]["launches"]
             for path in ("tiny_serve", "forward", "serve", "observe",
                          "multitenant", "runtime", "autoscale",
                          "serve_front", "train",
                          "remat", "moe", "rllib", "train_gang",
                          "data_tune", "rllib_algos")}
    # The runtime phase's library paths, each counted in its own process:
    # the engine actor (dag), the workflow's GPU task, the job's task.
    paths.update({path: report["runtime"][path]["launches"]
                  for path in ("dag", "workflow", "job")})
    # The four ranks' launches on each parallel sub-step, summed.
    paths.update({f"parallel_{name}": report["parallel"][name]["launches"]
                  for name in PAR_STEPS})
    bwd = report["flash_bwd"]["main"]
    kernels = []
    for name, src, replaces, main in (
            ("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
             "ray_tpu/ops/attention.py:84", report["flash_fwd"]["main"]),
            ("flash_bwd_dq", "ray_tpu_torch/csrc/flash_bwd.cu",
             "ray_tpu/ops/attention.py:174", bwd["flash_bwd_dq"]),
            ("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_bwd.cu",
             "ray_tpu/ops/attention.py:214", bwd["flash_bwd_dkv"]),
            ("rms_norm", "ray_tpu_torch/csrc/rms_norm.cu",
             "ray_tpu/ops/norms.py:20", report["rms_norm"]["main"]),
            # No Pallas kernel: XLA's fusion of jax.vjp of rms_norm.
            ("rms_norm_bwd", "ray_tpu_torch/csrc/rms_norm.cu",
             "ray_tpu/ops/norms.py:56", report["rms_norm"]["bwd"]["main"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            **{f"launches_{path}": c[name] for path, c in paths.items()},
            "max_abs_err": main["max_abs_err"],
            # Device time from the profiler.
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # Host per-call time (CUDA events over back-to-back calls).
            "call_ms": main["call_ms"]})
    suffix = report["multitenant"]["k1_suffix"]
    kernels[0]["suffix_prefill"] = {
        k: suffix[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                               "library_ms", "bound_ms", "bound_by")}
    report["kernels"] = kernels
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[done] all phases passed in {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
