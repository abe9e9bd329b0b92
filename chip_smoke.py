#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and each prints its wall
time:

1. the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
2. LeNet kernels: each at the shapes phase 4's runs give it (derived
   from their hparams: C=32 clients, B=32, S=19 selected, projection
   width 64; the streamed runs' client steps at their chunks' 8 and 12
   rows), at phase 4b's (C=256, and a 32-row chunk: the GEMMs, NT-Xent
   and client Adam over 256 rows, masked Adam over the server and S=154
   mask rows), and the GEMMs at the main run's shapes with the split
   after conv block 2 and 4, against its plain PyTorch version on the
   card, with its device time (torch.profiler), the plain version's,
   that of one PyTorch library call where one computes the same
   function, and the bound (bytes over 3.35 TB/s or FLOPs over 67
   TFLOP/s fp32): the panel GEMMs (each with the tile and K splits it
   ran, two launches bit-equal, ``torch.bmm`` beside it, and the host
   time per call of the wrapper and of ``torch.bmm``), the multi-tensor
   Adam kernel as the global step launches it (server and mask leaves,
   one launch each) and as the client step does (all clients' leaves,
   one launch, the client order), each bit-equal to its plain version
   and timed against one ``torch._fused_adam_`` call over the same
   leaves, the fused NT-Xent forward and backward (and the loss's
   gradient through them against the CPU's autograd path) and
   soft-threshold (1024x1024 in float32 and bfloat16, and phase 4's
   split activations).  Each profile starts with marker kernels that
   take the profiler's loss of a session's first device records; one
   that lost more is taken again with more markers, and after three the
   time comes from CUDA events around the same loop, and the output says
   so;
3. one teacher-forced LeNet iteration, and one global round on the
   round rung, from the same state on the card and on the CPU, compared;
4. ``AdaSplitTrainer`` on ``lenet-cifar`` at full width (C=32, B=32, 4
   rounds) on the round rung (the default), with every kernel's launch
   count from that run; the same hparams on the eager and the epoch
   rungs, which must select and bill alike; a shorter run with
   ``fused_epilogue=True`` and per-scalar masks drives the bias+ReLU
   epilogue kernel.  Streamed residency (``streamed=True``): the main
   run in 4 chunks of 8 clients, the epoch run likewise, and the fused
   per-scalar run on the disk store (chunks of 12, 12 and 8, under
   ``build/``, removed after) must each select and bill as its resident
   twin (the store's traffic on ``host_device_bytes`` besides) and end
   within the Adam sign-flip bound of its state; two witnesses, one
   chunk of all 32 rows and the 8-row chunks on the eager rung (no
   ring), must end bit-equal to main and to the 8-row run (every pair of
   runs whose client steps take the same rows must);
   ``batched_conv=False`` (2 rounds) must launch no panel GEMM and bill
   per round as the main run;
   ``fused_mask_adam=fused_server_adam=False`` (2 rounds) moves the
   global step's two masked-Adam launches to the client order.  Every
   run's launches are derived from its hparams (the client step's once
   per chunk, streamed).  Each run's global-iteration wall time, the
   runs timed in turn.  One global and one local round, and one global
   and one local epoch, run under ``torch.cuda.set_sync_debug_mode(
   "error")`` with the mode lifted only around the trainer's one fetch,
   so that any other host sync fails the run; one global and one local
   streamed round on the round and on the eager rung run under
   ``"warn"`` with every warning counted, and the count must be the
   formula of ``_stream_one_round``'s docstring. Then the port's kernel
   API (``kernels/ops.py``, the path of soft-threshold) on the main
   run's own tensors;
4b. a population of 256 clients at full width (``mixed_noniid(256, 128,
   64)``, one local and one global round), resident on the round rung
   and streamed in chunks of 32: each one's iteration wall ms, peak
   device memory and memory held between the rounds, and its launches,
   which must be as derived from its hparams; the streamed run must hold
   at least C x a client's store row less and peak lower, select and
   bill alike and end within phase 4's streamed state bound;
4c. cohort-sharded training (``shard_clients=True``): the main run's
   hparams on 2 ranks over gloo on the one card (``launch.distributed.
   run_ranks``: spawned ranks that load the kernels phase 1 built, a
   ``file://`` rendezvous, the job under ``SHARD_TIMEOUT_S``; a failing
   rank fails the phase), 16 clients a rank, on the round rung and the
   epoch rung (``epoch_chunk_rounds`` 0 and 1): each must select, bill
   and train as phase 4's ``main`` (selections and the protocol meters
   equal, CE within 1e-5, state within 1e-4 or phase 4's chunked
   bound), bill interconnect by the reference's formula, equal to the
   bytes the exchange moved, end with every rank's state (the server
   included) bit-equal, and launch as derived from its hparams; each
   rank's global-iteration wall ms over 5 more global rounds, host
   round trips a round (all-gathers and fetches, counted), interconnect
   GB, launches, and one global round profiled (busy share).  Phase 2
   checks the kernels at a rank's 16-row client-step shapes;
5. the flash-attention kernel at every prefill shape of phase 7's
   serving runs (derived from ``serving_runs()`` through the engines'
   own batching and bucketing; bf16, causal, kv_len where ragged; each
   distinct B=1 admission prefill of the continuous runs, buckets 8 to
   512, with its totals on a line of their own), at every prefill shape
   of phase 7b's and 7c's runs (``arch_runs()``: hd 128 and 96, GQA
   32/8, MHA 16/16 and 32/32 and qwen3's group of 8, 32/4; totals per
   head dim), at phase 7d's jamba session shape (32/8, hd 128), at
   phase 7e's (qwen2-vl's 64/8 at hd 128, S = 1,280, and its B=1
   admissions; seamless's non-causal encoder, 16/16 at hd 64, and its
   decoder's S = 1 BOS prefill, at the session's S = 1,024 and at each
   equal-length sub-batch of its mixed FIFO) and at phase 6's f32
   shapes (the reduced jamba's 4/4 at hd 64 among them), against its
   plain version, with device times,
   one ``scaled_dot_product_attention`` call as the library yardstick
   (and the kernel's ratio to it), host times per call of the wrapper
   and of SDPA, and the bound (bytes over 3.35 TB/s or the causal FLOPs
   over 989 TFLOP/s bf16).  In bf16 the kernel must also beat a control
   that rounds P once to bf16 before P V: it splits P into two bf16
   halves, so fewer of its outputs may differ from the plain version's
   and by less on average;
6. qwen2-0.5b, granite-3-8b, phi3-mini-3.8b, deepseek-moe-16b (its
   dense layer 0 on the client, an MoE layer on the server) and
   qwen3-moe-30b-a3b and mamba2-370m at full width cut to 2 layers,
   qwen2-vl-72b at 2 layers (16 patches at distinct M-RoPE streams) and
   seamless-m4t-large-v2 at 2 + 2 (64 source frames; cross-attention in
   the prefill and every decode step), and
   jamba-v0.1-52b's reduced config (``m a m a``), strict fp32: a
   prefill and teacher-forced decode steps on the card and on the CPU,
   compared (MoE: the smallest top-K router margin, and the margin of
   any token the two devices route differently; SSM: the final mamba
   states); one global train step of the reduced deepseek-moe-16b and
   mamba2-370m on both (losses, router aux, Adam moments); then
   (qwen2-0.5b) a
   ragged
   six-request trace of mixed clients through
   ``ContinuousEngine`` (3 slots), ``ServeEngine`` one request at a
   time and ``ServeEngine`` with mixed batches, on the card: the greedy
   tokens must be equal (the solo runs' smallest top-2 logit gap is
   printed, and where an engine parts from solo, the gap there);
7. serving qwen2-0.5b at full width, all 24 layers, bf16: the session
   CLI (``repro_torch.launch.serve``, client 0's mask folded, B=8,
   prompt 512, 32 new tokens), ``ServeEngine`` on 16 ragged requests
   from 4 clients with mixed (gated) and per-client (folded) batches,
   and ``ContinuousEngine`` (8 slots, cache 576) on the same 16
   requests and on 24 requests that reach every prompt bucket and
   arrive between steps; each continuous run's ``EngineStats`` must be
   its scheduler dry run's, every step that neither admits nor
   completes runs under ``sync_debug_mode("error")``, and one
   eight-slot gated decode step is profiled; the flash launches of
   each run must be 24 per prefill;
7b. dense serving at head dims 128 and 96, full width, all layers,
   bf16, each run followed by its peak device memory: granite-3-8b (40
   layers, GQA 32/8) through the session CLI, the mixed FIFO engine and
   ``ContinuousEngine`` on phase 7's 16 requests (``EngineStats`` equal
   to the dry run, steady steps under ``sync_debug_mode("error")``), a
   prefill and a decode step profiled; phi3-mini-3.8b (32 layers, hd 96)
   and olmo-1b (16 layers) through the session CLI; flash launches one a
   layer per prefill;
7c. MoE serving at full width, all layers, bf16, each run followed by
   its peak device memory and its share of dropped (token, slot)
   assignments (counted on the device, read once after the run):
   deepseek-moe-16b (28 layers, 64 experts top-6, 2 shared) through the
   session CLI, the mixed FIFO engine and ``ContinuousEngine`` on phase
   7's 16 requests (``EngineStats`` equal to the dry run, steady steps
   under ``sync_debug_mode("error")``), a prefill and a decode step
   profiled; then, its params, caches and engines freed,
   qwen3-moe-30b-a3b (48 layers, 128 experts top-8, GQA 32/4, 61.1 GB
   of bf16 weights) through the session CLI alone; flash launches one a
   layer per prefill;
7d. SSM and hybrid serving, bf16, each config's reckoned bytes printed
   before it allocates and its peak after: mamba2-370m at full width
   and depth (48 layers) through the session CLI and the mixed FIFO
   engine on phase 7's 16 requests, which it splits into equal-length
   sub-batches (each with its SSD chunk and carry blocks printed), a
   prefill and a decode step profiled, and ``ContinuousEngine``'s
   refusal; jamba-v0.1-52b at published widths cut to 16 layers (two
   8-layer periods, 52.0 GB; a prefill and a decode step profiled from
   params freed before the session) through the session CLI; flash
   launches one an attention layer per prefill (jamba 2, mamba2 0);
7e. vision-text and encoder-decoder serving, bf16, reckoned bytes
   before and peaks after: qwen2-vl-72b at published widths cut to 24
   of its 80 layers (~47 GB; 80 do not fit) through the session CLI
   alone (B=8, 1,280-token prompts, 32 new, client 0 folded; its params
   freed), then one init for a prefill of the same shape with 1,024
   patch embeddings spliced over the prefix at distinct (t, h, w)
   M-RoPE streams and 31 decode steps (logits finite and moved by the
   patches; prefill and decode profiled) and ``ContinuousEngine`` on 8
   requests arriving between steps (``EngineStats`` equal to the dry
   run, steady steps under ``sync_debug_mode("error")``);
   seamless-m4t-large-v2 at full width and depth (24 + 24 layers)
   through the session CLI (1,024 source frames a row) and the mixed
   FIFO engine on phase 7's 16 requests (equal-length sub-batches, zero
   source frames), prefill and decode profiled, and
   ``ContinuousEngine``'s refusal; flash launches one a self-attention
   layer per prefill (24; seamless 24 + 24: cross-attention never takes
   the kernel);
8. Table 1 through ``launch/compare.py`` and the baselines card vs CPU
   (phase 8);
8b. the AdaSplit LM trainer (``repro_torch.launch.train``) on
   qwen2-0.5b at full width, all 24 layers (split after 5), bf16, C=4
   cohorts, B=16, S=128, kappa 0.5, eta 0.6, 20 steps in windows of 10,
   on the per-step and the windowed driver: NT-Xent at (4, 4, 64) and
   client Adam over the LM's own trainables against their plain
   versions first; each run under ``sync_debug_mode("error")`` lifted
   only in its fetch (one fetch a window), finite losses, the phases
   local then global, per step one NT-Xent forward and one backward, the
   client Adam launches ``plan_launches`` predicts and no flash launch;
   its wall ms per step, tokens/s and peak device memory, one steady
   global window profiled (busy share); equal selections and losses
   within ``LM_DRIVER_TOL`` across the drivers; a ``requires_grad`` q
   refused by the flash wrapper; then 2 layers, strict fp32, 2 steps (a
   local and a global one) on the card and the CPU (equal selections, losses within
   ``LM_TRAIN_REL_TOL``);
8c. MoE and SSM training as 8b (C=4, B=16, S=128, 20 steps in windows
   of 10, both drivers, one step profiled): mamba2-370m at full width
   cut to 24 of 48 layers and deepseek-moe-16b at published widths cut
   to 2 layers (its dense layer 0 on the client, one MoE layer on the
   server), each state's reckoned size printed before it allocates, the
   router aux loss beside the CE;
8d. encoder-decoder training as 8b: seamless-m4t-large-v2 at published
   widths cut to 12 + 12 layers (~1.46 B elements, reckoned ~43.5 GiB;
   24 + 24 do not fit at C=4), source frames drawn as the reference's
   trainer draws them;
9. a ``kernels`` JSON line (all eight kernels; flash's launches those of
   every phase 7, 7b, 7c, 7d and 7e run, its times the hd-64 session and
   FIFO totals; NT-Xent's and client Adam's launches include phases
   8b's, 8c's and 8d's; the panel GEMM's, masked Adam's, client Adam's
   and NT-Xent's both ranks' training in phase 4c),
   then the final ``{"ok": true, ...}`` line.

It needs a CUDA card and the repository around it, and imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
GEMM_TOL = 1e-4                 # f32 FMA sums of <=1600 terms, other order
ADAM_TOL = 1e-6                 # same f32 ops in the same order (-fmad=false)
# the library's Adam takes sqrt(nu)/sqrt(1-b2^t) and lerps mu: the same
# function in other f32 ops, one ULP of |p| < 8 apart
LIBRARY_ADAM_TOL = 1e-6
N_CLIENTS = 32                  # phase 4's clients; phase 2's shapes follow
SMI = "card not read"           # nvidia-smi's name and power limit, phase 1
# flash attention against its plain version: both f32 math, other order
# and exp2 for exp; bf16 output rounds to 8 bits (one step ~ 2**-8..2**-7
# on values of order 1)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# bf16 flash against a control that rounds P once to bf16: the kernel's
# share of outputs that differ from the plain version's, and its mean
# error, must each be at most this fraction of the control's
SPLIT_P_MARGIN = 0.25
# card vs CPU, qwen2-0.5b, granite-3-8b and phi3-mini-3.8b at full width,
# 2 layers, strict fp32: other summation orders in f32 GEMMs of width
# <= 12,800
LM_REL_TOL = 1e-4
# NT-Xent statistics against their plain version: f32 dots of D terms and
# f32 sums of B terms in another order, relative to the largest magnitude
NTXENT_TOL = 1e-5


def trainer_runs():
    """Phase 4's trainer runs by label: the main run on the round rung
    (the default), the same hparams on the eager and the epoch rung (one
    round per staged chunk), a shorter run with the bias+ReLU epilogue
    and per-scalar masks; the joint step (``server_grad_to_client``, the
    Table-5 ablation) on the three rungs, and on a shorter per-scalar
    run with the fused epilogue (the per-client form); serialized server
    updates on the round rung, and the per-client loop
    (``global_batch=False``, the eager rung); streamed residency
    (``streamed=True``) on the round rung (4 chunks of 8 clients), the
    epoch rung, and the per-scalar fused run on the disk store (chunks
    of 12, 12 and 8), and two witnesses (one chunk of 32 rows; the 8-row
    chunks on the eager rung, without the ring); the library conv
    (``batched_conv=False``) and ``adam_update``'s order for the server
    and the masks (``fused_*_adam=False``).  Phase 2 checks every kernel
    at the shapes these runs give it."""
    import dataclasses
    from repro_torch.core.adasplit import AdaSplitHParams
    main = AdaSplitHParams(rounds=4, kappa=0.5, eta=0.6, batch_size=32)
    joint = dataclasses.replace(main, server_grad_to_client=True)
    epoch = dataclasses.replace(main, epoch_scan=True, epoch_chunk_rounds=1)
    fused = dataclasses.replace(main, rounds=2, mask_mode="per_scalar",
                                fused_epilogue=True)
    stream = dataclasses.replace(main, streamed=True, stream_chunk=8)
    return {"main": main,
            "eager": dataclasses.replace(main, round_scan=False),
            "epoch": epoch,
            "fused_epilogue+per_scalar": fused,
            "joint": joint,
            "joint_eager": dataclasses.replace(joint, round_scan=False),
            "joint_epoch": dataclasses.replace(joint, epoch_scan=True,
                                               epoch_chunk_rounds=1),
            "joint+per_scalar+fused_epilogue": dataclasses.replace(
                joint, rounds=2, mask_mode="per_scalar",
                fused_epilogue=True),
            # one local and one global round: 19 server steps in turn an
            # iteration make ~11,000 device ops
            "serialized": dataclasses.replace(
                main, rounds=2, serialize_server_updates=True),
            "loop": dataclasses.replace(main, rounds=2, global_batch=False),
            "stream": stream,
            # witnesses: one chunk of all 32 rows (the resident step's
            # shapes, no second chunk on the ring) and the 8-row chunks
            # without the ring (eager rung): each must equal its twin
            # bit for bit
            "stream_whole": dataclasses.replace(stream,
                                                stream_chunk=N_CLIENTS),
            "stream_eager": dataclasses.replace(stream, round_scan=False),
            "stream_epoch": dataclasses.replace(epoch, streamed=True,
                                                stream_chunk=8),
            "stream_disk": dataclasses.replace(
                fused, streamed=True, store_backend="disk", stream_chunk=12,
                store_dir=str(STORE_DIR)),
            "conv_ref": dataclasses.replace(main, rounds=2,
                                            batched_conv=False),
            "adam_unfused": dataclasses.replace(
                main, rounds=2, fused_mask_adam=False,
                fused_server_adam=False)}


# runs that must select and bill as another run does: (run, reference);
# a streamed run against a resident one bills the store's traffic on
# host_device_bytes besides
SAME_SELECTIONS = (("eager", "main"), ("epoch", "main"),
                   ("joint_eager", "joint"), ("joint_epoch", "joint"),
                   ("loop", "serialized"), ("stream", "main"),
                   ("stream_epoch", "epoch"),
                   ("stream_disk", "fused_epilogue+per_scalar"),
                   ("stream_whole", "main"), ("stream_eager", "stream"))
# the disk store's directory (removed after phase 4)
STORE_DIR = ROOT / "build" / "client_store"
# phase 4b: a population whose client state outgrows a chunk many times
POPULATION = {"clients": 256, "n_per_client": 128, "n_test": 64,
              "stream_chunk": 32}


def rung(hp) -> str:
    if not (hp.round_scan and hp.global_batch):
        return "eager"
    return "epoch" if hp.epoch_scan else "round"


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, iters: int) -> float:
    """Host-clock ms per call of ``fn`` (CUDA events around ``iters``
    back-to-back calls after two warm-ups): launch cost included."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 50) -> float:
    """Host us per call of ``fn``: the median of ``calls`` calls issued
    back to back after a warm-up, each timed on the host clock alone (the
    device queue far from full, so no call waits for the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(ts)


# On an H100, once the trainer runs had gone, each torch.profiler
# session lost the first few device records it should have held: the
# first one or two kernels of a ten-launch loop, however long the
# session first waited, and once every one of the ten.  So a session
# starts with marker kernels (``torch.cuda._sleep``'s) that take that
# loss: it is sound when some marker was recorded, so that the loss
# ended before the work, and is taken again with more markers when
# not.
PROFILE_MARKERS = (64, 1024, 16384)
MARKER = "spin_kernel"
MARKERS_LOST = {"sessions": 0, "lossy": 0, "most": 0}


def tally_markers(n_markers: int, markers: int):
    lost = n_markers - markers
    MARKERS_LOST["sessions"] += 1
    MARKERS_LOST["lossy"] += lost > 0
    MARKERS_LOST["most"] = max(MARKERS_LOST["most"], lost)


@contextlib.contextmanager
def primed_profile(n_markers: int):
    """A torch.profiler session over CPU and CUDA whose first device
    work is ``n_markers`` marker kernels, finished before the body
    runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_markers):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


def device_records(prof):
    """(name, device us, count) of the device-side events of a
    torch.profiler run (kernels, copies, fills), the markers apart: a
    CPU op's self device time would repeat the time of the kernels it
    launched.  Returns them with the number of markers recorded."""
    import torch
    dev = [(e.key, getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0), e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    markers = sum(d[2] for d in dev if MARKER in d[0])
    return [d for d in dev if d[1] > 0 and MARKER not in d[0]], markers


def device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: the summed duration of the device
    work that ``iters`` calls issue (torch.profiler), after a warm-up.
    Gaps between launches are not counted.

    Every ``fn`` here launches at least one kernel per call on one
    stream, so a session is sound only if some of its markers were
    recorded, and besides them at least ``iters`` device ops whose summed
    time fits inside the CUDA-event time of the same loop.  A session
    that is not sound is taken again with more markers; after the last,
    the time is the CUDA-event time of its loop (launch gaps included),
    and the output says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for n_markers in PROFILE_MARKERS:
        with primed_profile(n_markers) as prof:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
        dev, markers = device_records(prof)
        tally_markers(n_markers, markers)
        busy_ms = sum(d[1] for d in dev) / 1e3
        ops = sum(d[2] for d in dev)
        event_ms = start.elapsed_time(end)
        if markers > 0 and ops >= iters \
                and 0 < busy_ms <= event_ms * 1.05 + 0.01:
            return busy_ms / iters
        print(f"  profile with {n_markers} markers ({markers} recorded): "
              f"{ops} device ops, {busy_ms} ms device time for {iters} "
              f"calls taking {event_ms} ms between CUDA events: not sound")
    print(f"  timed with CUDA events instead: {event_ms / iters} ms/call "
          "(launch gaps included)")
    return event_ms / iters


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, at phase 4's shapes
# ---------------------------------------------------------------------------


def conv_blocks(cfg):
    """(client blocks, server blocks) of the model: (K*K*Cin, Cout,
    output H=W) of each conv."""
    import torch
    from repro_torch.models import lenet
    gen = torch.Generator().manual_seed(0)
    hw, out = cfg.image_size, []
    for params in (lenet.init_client_params(cfg, gen),
                   lenet.init_server_params(cfg, gen)):
        part = []
        for bp in params["blocks"]:
            k, _, cin, cout = bp["w"].shape
            part.append((k * k * cin, cout, hw))
            hw //= 2
        out.append(part)
    return out


def per_client_global(hp) -> bool:
    """The global step runs one selected client at a time (serialized
    server updates, or the per-client loop)."""
    return hp.serialize_server_updates or not hp.global_batch


def chunk_rows(hp, n_clients=None):
    """Client rows of each client-step launch of one iteration: all the
    clients at once, or each ``stream_chunk`` rows of a streamed run (the
    trainer's ``_stream_chunk``)."""
    n_clients = n_clients or N_CLIENTS
    if not hp.streamed:
        return [n_clients]
    from repro_torch.core.orchestrator import n_selected
    chunk = min(n_clients, hp.stream_chunk
                or max(32, n_selected(n_clients, hp.eta)))
    return [min(chunk, n_clients - i0) for i0 in range(0, n_clients, chunk)]


def gemm_shapes(cfg, hp, n_clients=None):
    """(name, C, M, K, N, launches) of every conv GEMM shape that one
    global iteration of the trainer run with ``hp`` on ``n_clients``
    clients launches, and how often: the client blocks over all the
    clients (over each chunk's rows, streamed); then the global step's
    over the S selected ones -- the joint step's client blocks stacked
    over S, the server blocks as one flattened S*B batch (per_unit,
    either joint form) or stacked over S (per_scalar); one client at a
    time (C=1, B rows) S times when serialized or looped.  None under
    ``batched_conv=False`` (every conv the library's)."""
    from collections import Counter
    from repro_torch.core.orchestrator import n_selected
    if not hp.batched_conv:
        return []
    n_clients = n_clients or N_CLIENTS
    S, B = n_selected(n_clients, hp.eta), hp.batch_size
    client, server = conv_blocks(cfg)
    joint = hp.server_grad_to_client
    out = [(f"client_block{i + 1}", m, B * hw * hw, kd, cout, k)
           for m, k in sorted(Counter(chunk_rows(hp, n_clients)).items(),
                              reverse=True)
           for i, (kd, cout, hw) in enumerate(client)]
    if per_client_global(hp):
        out += [(f"joint_client_block{i + 1}", 1, B * hw * hw, kd, cout, S)
                for i, (kd, cout, hw) in enumerate(client) if joint]
        out += [(f"server_block{i + 1}", 1, B * hw * hw, kd, cout, S)
                for i, (kd, cout, hw) in enumerate(server)]
        return out
    out += [(f"joint_client_block{i + 1}", S, B * hw * hw, kd, cout, 1)
            for i, (kd, cout, hw) in enumerate(client) if joint]
    stack, rows = (S, B) if hp.mask_mode == "per_scalar" else (1, S * B)
    out += [(f"server_block{i + 1}", stack, rows * hw * hw, kd, cout, 1)
            for i, (kd, cout, hw) in enumerate(server)]
    return out


def iteration_launches(cfg, hp, global_phase=True, n_clients=None):
    """Kernel launches of one iteration of the run with ``hp``, derived
    from its hparams: the client step's (its GEMMs, one client Adam, one
    NT-Xent forward and backward; once per chunk, streamed); in the
    global phase the global step's too.  Batched, the server and the
    masks take masked Adam once each (client Adam's order, each that
    ``fused_server_adam`` / ``fused_mask_adam`` sets False), and the
    joint step adds one client Adam over the S rows and one NT-Xent
    forward and backward; one client at a time, each selected client's
    step takes masked Adam for the server and client Adam for its mask,
    and the joint step adds one client Adam and one NT-Xent forward and
    backward each."""
    from repro_torch.core.orchestrator import n_selected
    n_clients = n_clients or N_CLIENTS
    S = n_selected(n_clients, hp.eta)
    chunks = len(chunk_rows(hp, n_clients))
    shapes = gemm_shapes(cfg, hp, n_clients)
    if not global_phase:
        shapes = [s for s in shapes if s[0].startswith("client_block")]
    joint = hp.server_grad_to_client and global_phase
    server = hp.fused_server_adam is not False
    if not global_phase:
        masked, client, nt = 0, chunks, chunks
    elif per_client_global(hp):
        masked, client, nt = S * server, 1 + S * (2 if joint else 1) \
            + S * (not server), 1 + (S if joint else 0)
    else:
        fused = server + (hp.fused_mask_adam is not False)
        masked, client, nt = fused, chunks + joint + 2 - fused, \
            chunks + joint
    gemm = "panel_gemm_bias_relu" if hp.fused_epilogue else "panel_gemm"
    other = "panel_gemm" if hp.fused_epilogue else "panel_gemm_bias_relu"
    return {gemm: sum(s[-1] for s in shapes), other: 0,
            "masked_adam": masked, "client_adam": client,
            "ntxent_stats": nt, "ntxent_backward": nt}


def check_gemm(cfg, hp, gen, shapes=None, run=""):
    """The panel GEMM at every conv shape of one global iteration of the
    run with ``hp`` (or at ``shapes``, some of them), against its plain
    version, two launches bit-equal;
    the plan it ran (tile, K splits), its device time, the plain
    version's, ``torch.bmm``'s (the library time of the product alone;
    for the fused variant printed as a yardstick only: no one call adds
    the bias and the ReLU), the bound, and the host time per call of the
    wrapper and of ``torch.bmm``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import client_conv as cc
    fused = hp.fused_epilogue
    label = ("panel_gemm_bias_relu" if fused else "panel_gemm") \
        + (f" [{run}]" if run else "")
    shapes = gemm_shapes(cfg, hp) if shapes is None else shapes
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": None if fused else 0.0, "bmm_ms": 0.0,
           "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0}
    for name, C, M, K, N, _ in shapes:
        a = torch.randn((C, M, K), device="cuda", generator=gen)
        b = torch.randn((C, K, N), device="cuda", generator=gen) / math.sqrt(K)
        bias = torch.randn((C, N), device="cuda", generator=gen) \
            if fused else None
        got = cc.panel_gemm_cuda(a, b, bias)
        again = cc.panel_gemm_cuda(a, b, bias)
        want = cc.panel_gemm_plain(a, b, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        if not err <= GEMM_TOL * max(1.0, float(want.abs().max())):
            raise AssertionError(f"{label} {name}: max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label} {name}: two launches differ")
        block_m, block_n, splits = cc.plan_panel_gemm(
            C, M, K, N, _build.sm_count(a.device))
        ms = device_ms(lambda: cc.panel_gemm_cuda(a, b, bias), 10)
        plain_ms = device_ms(lambda: cc.panel_gemm_plain(a, b, bias), 3)
        bmm_ms = device_ms(lambda: torch.bmm(a, b), 10)
        host = host_us(lambda: cc.panel_gemm_cuda(a, b, bias))
        bmm_host = host_us(lambda: torch.bmm(a, b))
        tot["bmm_ms"] += bmm_ms
        if not fused:
            tot["library_ms"] += bmm_ms
        nbytes = 4.0 * (C * M * K + C * K * N + C * M * N
                        + (C * N if fused else 0))
        flops = 2.0 * C * M * K * N + (2.0 * C * M * N if fused else 0)
        bms, _ = bound(nbytes, flops)
        print(f"  {label} {name} C={C} M={M} K={K} N={N} tile={block_m}x"
              f"{block_n} splits={splits} ctas="
              f"{-(-M // block_m) * -(-N // block_n) * C * splits}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} (two launches "
              f"bit-equal) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bmm_ms={bmm_ms:.4f}{' (product alone)' if fused else ''} "
              f"bound_ms={bms:.4f} ms/bmm={ms / bmm_ms:.3f} "
              f"host_us={host:.1f} bmm_host_us={bmm_host:.1f}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bms
        tot["bytes"] += nbytes
        tot["flops"] += flops
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del a, b, bias, got, again, want
    print(f"  {label} total over {len(shapes)} shapes: "
          f"ms={tot['ms']:.4f} bmm_ms={tot['bmm_ms']:.4f} "
          f"bound_ms={tot['bound_ms']:.4f}")
    return tot


def adam_leaves(cfg, hp, n_clients=N_CLIENTS):
    """(server leaf shapes, mask leaf shapes) of one global step of the
    trainer run with ``hp`` on ``n_clients`` clients (unmasked): the
    server params, with one step, and the S selected clients' masks, with
    a step per row -- unit masks (per_unit) or server-shaped ones
    (per_scalar).  The step launches the Adam kernel once for each
    list."""
    import torch
    from repro_torch.core import masks
    from repro_torch.core.orchestrator import n_selected
    from repro_torch.models import lenet
    from repro_torch.weights import tree_leaves
    S = n_selected(n_clients, hp.eta)
    server = lenet.init_server_params(cfg, torch.Generator().manual_seed(0))
    if hp.mask_mode == "per_scalar":
        m = masks.init_scalar_masks(server, S)
    else:
        m = masks.init_lenet_unit_masks(cfg, S, device="cpu")
    return ([tuple(l.shape) for l in tree_leaves(server)],
            [tuple(l.shape) for l in tree_leaves(m)])


def client_adam_leaves(cfg, hp, rows=N_CLIENTS):
    """Leaf shapes of the client step's Adam over all N_CLIENTS clients
    (client towers and projection heads, a step per client), as the
    trainer run with ``hp`` stacks them; with ``rows`` that many of them
    (the joint step's S selected clients)."""
    import dataclasses
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    from repro_torch.weights import tree_leaves
    clients = mixed_noniid(N_CLIENTS, n_per_client=1, n_test=1)
    tr = AdaSplitTrainer(cfg, dataclasses.replace(hp, rounds=1), clients,
                         device="cpu")
    return [(rows,) + tuple(l.shape[1:]) for l in tree_leaves(
        {"c": tr.client_params, "p": tr.proj_params})]


def adam_inputs(shapes, per_row, gen):
    """(p, g, mu, nu, None) per leaf of ``shapes`` on the card, and the
    step: a scalar, or one per row of the leading axis."""
    import torch
    leaves = []
    for shape in shapes:
        p = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen) * 1e-2
        mu = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        nu = torch.rand(shape, device="cuda", generator=gen) * 1e-4
        leaves.append((p, g, mu, nu, None))
    step = torch.randint(1, 50, shapes[0][:1], device="cuda", generator=gen,
                         dtype=torch.int32) if per_row else \
        torch.tensor(7, device="cuda", dtype=torch.int32)
    return leaves, step


def library_adam(groups, kw):
    """One ``torch._fused_adam_`` call (a multi-tensor launch) over the
    leaves of ``groups`` (a list of (leaves, step)), each stacked leaf of
    a per-row step split into its rows so that every row takes its own
    step; it updates copies in place.  Returns the call and the copies
    (p, mu, nu) per leaf, in the groups' order."""
    import torch
    lists = ([], [], [], [], [])
    copies = []
    for leaves, step in groups:
        for p, g, mu, nu, _ in leaves:
            cp, cm, cv = p.clone(), mu.clone(), nu.clone()
            copies.append((cp, cm, cv))
            rows = (lambda t: list(t.unbind(0))) if step.ndim else \
                (lambda t: [t])
            stepf = step.to(torch.float32)
            for out, t in zip(lists, (cp, g, cm, cv, stepf)):
                out.extend(rows(t))
    ps, gs, ms, vs, steps = lists
    steps = [s.clone() for s in steps]

    def call():
        torch._fused_adam_(ps, gs, ms, vs, [], steps, lr=kw["lr"],
                           beta1=kw["b1"], beta2=kw["b2"], weight_decay=0.0,
                           eps=kw["eps"], amsgrad=False, maximize=False)
    return call, copies


def adam_row(groups, kw, client_order, what):
    """The multi-tensor Adam kernel over ``groups`` (a list of (leaves,
    step), one launch each) against its plain version on the same inputs
    (bit-equal, and two launches bit-equal) and against one
    ``torch._fused_adam_`` call over the same leaves; device times of the
    kernel, the plain version and the library call, and the bound."""
    import torch
    from repro_torch.kernels import masked_adam as ma
    prepared = []
    tot = {"bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0}
    for leaves, step in groups:
        b1t, b2t = ma.bias_corrections(step, kw["b1"], kw["b2"])
        prepared.append((leaves, dict(kw, b1t=b1t, b2t=b2t)))
        for p, *_ in leaves:
            tot["bytes"] += 4.0 * 7 * p.numel()
            tot["flops"] += 15.0 * p.numel()
        tot["bytes"] += 4.0 * 2 * b1t.numel()

    def kernel_step():
        return [ma.adam_multi_cuda(leaves, client_order=client_order, **k)
                for leaves, k in prepared]

    def plain_step():
        return [ma.adam_multi_plain(leaves, client_order=client_order, **k)
                for leaves, k in prepared]
    got, again, want = kernel_step(), kernel_step(), plain_step()
    torch.cuda.synchronize()
    for outs in (got, again):
        for a, b in zip(outs, want):
            for x, y in zip(a, b):
                err = max(float((u - v).abs().max())
                          for u, v in zip(x, y))
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                if not all(torch.equal(u, v) for u, v in zip(x, y)):
                    raise AssertionError(f"{what}: kernel not bit-equal to "
                                         f"its plain version ({err})")
    call, copies = library_adam(groups, kw)
    call()
    flat_want = [t for outs in want for t in outs]
    lib_err = max(max(float((x - y).abs().max())
                      for x, y in zip(got_l, want_l))
                  for got_l, want_l in zip(copies, flat_want))
    if not lib_err <= LIBRARY_ADAM_TOL:
        raise AssertionError(f"torch._fused_adam_ disagrees: {lib_err}")
    tot["ms"] = device_ms(kernel_step, 10)
    tot["plain_ms"] = device_ms(plain_step, 10)
    tot["library_ms"] = device_ms(call, 10)
    tot["bound_ms"] = bound(tot["bytes"], tot["flops"])[0]
    host_ms, lib_host_ms = time_ms(kernel_step, 10), time_ms(call, 10)
    n = sum(len(leaves) for leaves, _ in groups)
    print(f"  {what}, {n} leaves ({len(groups)} launches, bit-equal to "
          f"plain, repeats bit-equal): device ms={tot['ms']:.4f} "
          f"plain_ms={tot['plain_ms']:.4f} fused_adam_ms="
          f"{tot['library_ms']:.4f} (one call, max_abs_err vs plain "
          f"{lib_err:.3e}; kernel below it: "
          f"{tot['ms'] < tot['library_ms']}) bound_ms={tot['bound_ms']:.4f}"
          f" ratio={tot['ms'] / tot['bound_ms']:.1f}x; host clock incl. "
          f"launches: kernel {host_ms:.4f} ms, fused_adam {lib_host_ms:.4f}"
          " ms")
    return tot


def check_adam(cfg, hp, gen, label):
    """Masked Adam over one global step's leaves as the step launches it
    (the server leaves with one step, the mask leaves with a step per
    row: two launches) against its plain version and the library's
    multi-tensor Adam; then the masked variant on the largest mask
    leaf."""
    import torch
    from repro_torch.kernels import masked_adam as ma
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    server, masks = adam_leaves(cfg, hp)
    groups = [adam_inputs(server, False, gen), adam_inputs(masks, True, gen)]
    tot = adam_row(groups, kw, False, f"masked_adam [{label}] one global "
                   "step")

    # the masked variant (tests and kernels/ops.py use it; the path does not)
    leaves, step = groups[1]
    p, g, mu, nu, _ = max(leaves, key=lambda lf: lf[0].numel())
    mask = torch.rand(p.shape, device="cuda", generator=gen)
    b1t, b2t = ma.bias_corrections(step, kw["b1"], kw["b2"])
    got = ma.masked_adam_cuda(p, g, mu, nu, mask, b1t=b1t, b2t=b2t, **kw)
    want = ma.masked_adam_plain(p, g, mu, nu, mask, b1t=b1t, b2t=b2t, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"masked_adam masked {tuple(p.shape)}: not "
                             "bit-equal to its plain version")
    ms = device_ms(lambda: ma.masked_adam_cuda(
        p, g, mu, nu, mask, b1t=b1t, b2t=b2t, **kw), 10)
    n = p.numel()
    print(f"  masked_adam [{label}] masked variant {tuple(p.shape)}: "
          f"bit-equal to plain, device ms={ms:.4f} bound_ms="
          f"{bound(4.0 * 8 * n + 8 * p.shape[0], 16.0 * n)[0]:.4f}")
    return tot


def check_client_adam(cfg, hp, gen):
    """The client step's Adam (``optim.adam.adam_update``'s rounding
    order) over all clients' leaves with a step per client: one launch,
    against its plain version and the library's multi-tensor Adam."""
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    return adam_row([adam_inputs(client_adam_leaves(cfg, hp), True, gen)],
                    kw, True, f"client_adam C={N_CLIENTS} one client step")


def check_ntxent(cfg, hp, gen, C=N_CLIENTS):
    """The fused NT-Xent forward (row norms, statistics, loss) and
    backward (dq with respect to the raw projections) at the client
    step's (C, B, D), each against its plain version on the card, and the
    loss's gradient through ``ntxent_loss`` on the card against CPU
    autograd of the same loss in float64 (``ntxent_loss_f64``), so that
    the witness's own rounding stays far below the tolerance; the float32
    CPU path's distance from it is printed.  On a failure the inputs and
    the gradients go to ``build/ntxent_grad_failure.pt``.  One library
    call computes neither, so there is no library time.  ``C`` rows: the
    client step's N_CLIENTS, or the joint step's S.  Returns the two
    rows."""
    import torch
    from repro_torch.kernels import ntxent as nt
    B, D = hp.batch_size, hp.proj_dim
    raw = torch.randn((C, B, D), device="cuda", generator=gen)
    y = torch.randint(0, cfg.n_classes, (C, B), device="cuda",
                      generator=gen, dtype=torch.int32)
    d_loss = torch.ones((C,), device="cuda")      # the trainer's sum
    got = nt.ntxent_forward_cuda(raw, y, hp.tau)
    want = nt.ntxent_loss_forward_plain(raw, y, hp.tau)
    again = nt.ntxent_forward_cuda(raw, y, hp.tau)
    norms, cnt = got[4], got[3]
    dq = nt.ntxent_backward_cuda(raw, y, norms, cnt, d_loss, hp.tau)
    dq_again = nt.ntxent_backward_cuda(raw, y, norms, cnt, d_loss,
                                       hp.tau)
    dq_plain = nt.ntxent_loss_backward_plain(raw, y, d_loss, hp.tau)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(1.0, max(float(b.abs().max()) for b in want))
    if not err <= NTXENT_TOL * scale:
        raise AssertionError(f"ntxent forward: max abs err {err}")
    b_err = float((dq - dq_plain).abs().max())
    b_scale = float(dq_plain.abs().max())
    if not b_err <= NTXENT_TOL * b_scale:
        raise AssertionError(f"ntxent backward: max abs err {b_err}")
    if not (all(torch.equal(a, b) for a, b in zip(got, again))
            and torch.equal(dq, dq_again)):
        raise AssertionError("ntxent: two launches differ")
    qg = raw.clone().requires_grad_(True)
    nt.ntxent_loss(qg, y, hp.tau).sum().backward()
    qc = raw.cpu().requires_grad_(True)
    nt.ntxent_loss(qc, y.cpu(), hp.tau).sum().backward()
    q64 = raw.detach().cpu().double().requires_grad_(True)
    ntxent_loss_f64(q64, y.cpu(), hp.tau).sum().backward()
    g64 = q64.grad
    g_err = float((qg.grad.cpu().double() - g64).abs().max())
    g_scale = float(g64.abs().max())
    # the closed form in torch ops on the card and the float32 CPU path
    # against the same witness
    plain_err = float((dq_plain.cpu().double() - g64).abs().max())
    cpu_err = float((qc.grad.double() - g64).abs().max())
    print(f"  ntxent loss gradient vs float64 CPU autograd: through the "
          f"kernels max_abs_err={g_err:.3e}, the closed-form plain version "
          f"on the card {plain_err:.3e}, the float32 CPU path {cpu_err:.3e} "
          f"(of {g_scale:.3e})")
    if not g_err <= NTXENT_TOL * g_scale:
        dump = ROOT / "build" / "ntxent_grad_failure.pt"
        dump.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"raw": raw.cpu(), "y": y.cpu(), "tau": hp.tau,
                    "grad_card": qg.grad.cpu(), "grad_cpu_f32": qc.grad,
                    "grad_cpu_f64": g64, "dq_plain": dq_plain.cpu(),
                    "dq_kernel": dq.cpu()}, dump)
        raise AssertionError(f"ntxent_loss gradient: max abs err {g_err} "
                             f"(inputs and gradients in {dump})")
    rows = {}
    q_bytes, stat_bytes = 4.0 * C * B * D, 4.0 * C * B
    for name, fn, plain, nbytes, flops in (
            ("ntxent_stats", lambda: nt.ntxent_forward_cuda(raw, y, hp.tau),
             lambda: nt.ntxent_loss_forward_plain(raw, y, hp.tau),
             q_bytes + stat_bytes * 5 + 4.0 * C, 2.0 * C * B * B * D),
            ("ntxent_backward",
             lambda: nt.ntxent_backward_cuda(raw, y, norms, cnt, d_loss,
                                             hp.tau),
             lambda: nt.ntxent_loss_backward_plain(raw, y, d_loss, hp.tau),
             2 * q_bytes + stat_bytes * 3 + 4.0 * C, 4.0 * C * B * B * D)):
        ms = device_ms(fn, 20)
        plain_ms = device_ms(plain, 20)
        bms, by = bound(nbytes, flops)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by, "library_ms": None, "bytes": nbytes,
                      "flops": flops,
                      "max_abs_err": err if name == "ntxent_stats" else b_err}
        print(f"  {name} C={C} B={B} D={D} tau={hp.tau}: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bms:.6f} ({by}) "
              f"ratio={ms / bms:.0f}x library: none computes it")
    print(f"  ntxent forward max_abs_err={err:.3e} (tol {NTXENT_TOL} x "
          f"{scale:.3g}) backward max_abs_err={b_err:.3e} (of "
          f"{b_scale:.3e}); two launches bit-equal; loss gradient through "
          f"the kernels vs float64 CPU autograd max_abs_err={g_err:.3e} (of "
          f"{g_scale:.3e})")
    return rows


def check_slice_kernels(cfg, runs, gen, checked):
    """Every kernel at the shapes the joint, serialized and loop runs
    give it beyond those of the main and fused runs (``checked``: their
    (fused, C, M, K, N) GEMM shapes): the GEMMs of the joint step's
    client blocks stacked over S and of one client's server and client
    blocks, NT-Xent and the client Adam over the joint step's S rows,
    and the per-client step's Adam launches (the server's masked Adam,
    one mask row's client Adam)."""
    from repro_torch.core.orchestrator import n_selected
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    for label, hp in runs.items():
        new = []
        for shape in gemm_shapes(cfg, hp):
            key = (hp.fused_epilogue,) + tuple(shape[1:5])
            if key not in checked:
                checked.add(key)
                new.append(shape)
        if new:
            check_gemm(cfg, hp, gen, shapes=new, run=label)
    joint = runs["joint"]
    S = n_selected(N_CLIENTS, joint.eta)
    check_ntxent(cfg, joint, gen, C=S)
    adam_row([adam_inputs(client_adam_leaves(cfg, joint, rows=S), True,
                          gen)], kw, True,
             f"client_adam [joint] S={S} rows of the joint step")
    server, masks = adam_leaves(cfg, runs["serialized"])
    adam_row([adam_inputs(server, False, gen)], kw, False,
             "masked_adam [serialized] one client's server step")
    adam_row([adam_inputs([m[1:] for m in masks], False, gen)], kw, True,
             "client_adam [serialized] one client's mask row")
    # the streamed runs' client steps, a chunk's rows at a time
    for rows in sorted({m for hp in runs.values() if hp.streamed
                        for m in chunk_rows(hp)} - {N_CLIENTS}):
        check_ntxent(cfg, runs["main"], gen, C=rows)
        adam_row([adam_inputs(client_adam_leaves(cfg, runs["main"],
                                                 rows=rows), True, gen)],
                 kw, True, f"client_adam [stream] {rows} rows of a chunk")


# ---------------------------------------------------------------------------
# phase 4c: cohort-sharded AdaSplit, SHARD_WORLD ranks on the one card
# ---------------------------------------------------------------------------

# ranks on the one card (gloo: NCCL refuses two ranks on one device)
SHARD_WORLD = 2
# the whole job's limit; a rank that fails or stalls fails the phase
SHARD_TIMEOUT_S = 300.0
# global rounds timed after training, taken in turn on every rank
SHARD_TIMED_ROUNDS = 5


def shard_runs():
    """Phase 4c's runs: the main run's hparams with ``shard_clients`` on
    the round rung and on the epoch rung, the whole epoch at once
    (``epoch_chunk_rounds`` 0) and a round per chunk (1)."""
    import dataclasses
    main = trainer_runs()["main"]
    sharded = dataclasses.replace(main, shard_clients=True)
    return {"shard_round": sharded,
            "shard_epoch0": dataclasses.replace(sharded, epoch_scan=True,
                                                epoch_chunk_rounds=0),
            "shard_epoch1": dataclasses.replace(sharded, epoch_scan=True,
                                                epoch_chunk_rounds=1)}


def check_shard_shapes(cfg, gen, checked):
    """The kernels at the shapes a rank of phase 4c gives them beyond
    phase 4's: its client step over C/SHARD_WORLD rows (the client
    blocks' GEMMs, NT-Xent, client Adam); its global step is the main
    run's, over the S selected of all C clients."""
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    hp = shard_runs()["shard_round"]
    rows = N_CLIENTS // SHARD_WORLD
    new = []
    for name, _, m, k, n, launches in gemm_shapes(cfg, hp):
        key = (hp.fused_epilogue, rows, m, k, n)
        if name.startswith("client_block") and key not in checked:
            checked.add(key)
            new.append((name, rows, m, k, n, launches))
    if new:
        check_gemm(cfg, hp, gen, shapes=new, run=f"shard {rows} rows")
    check_ntxent(cfg, hp, gen, C=rows)
    adam_row([adam_inputs(client_adam_leaves(cfg, hp, rows=rows), True,
                          gen)], kw, True,
             f"client_adam [shard] {rows} rows of a rank")


def shard_rank(runs):
    """One rank of phase 4c (in a spawned process, the kernels loaded
    from ``build/``, which phase 1 built): each run trained as phase 4
    trains its own, its launches read; then SHARD_TIMED_ROUNDS more
    global rounds timed, their collectives and fetches counted, and one
    profiled.  Returns what the parent checks and prints."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    from repro_torch.weights import strict_fp32
    strict_fp32()
    cfg = get_config("lenet-cifar")
    clients = mixed_noniid(N_CLIENTS, n_per_client=128, n_test=64)
    out = {}
    for label, hp in runs.items():
        tr = AdaSplitTrainer(cfg, hp, clients, device="cuda")
        assert tr._shard, f"[{label}] sharding did not engage"
        selections = log_selections(tr.orch)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hist = tr.train(eval_every=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        res = {"state": tr.get_state(), "meter": dataclasses.replace(
                   tr.meter), "selections": list(selections),
               "L": tr.orch.L.copy(), "history": hist, "wall_s": wall,
               "launches": launches, "accuracy": tr.evaluate(),
               "iteration_bytes": tr._iteration_interconnect_bytes(),
               "moved": dict(tr._xchg.bytes),
               "collectives": dict(tr._xchg.collectives)}
        # more global rounds of fixed batches, this rank's rows
        T = len(clients[0].x) // hp.batch_size
        mine = clients[tr._lo:tr._lo + tr._n_local]
        run = one_round(tr, fixed_iters(mine, hp.batch_size, T))
        fetch, fetches = tr._fetch, [0]

        def counted(tensors):
            fetches[0] += 1
            return fetch(tensors)
        tr._fetch = counted
        tr._xchg.reset()
        reset_launches()
        ms = []
        for _ in range(SHARD_TIMED_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / T)
        res["round_launches"] = read_launches()
        res["round_ms"] = ms
        res["round_collectives"] = dict(tr._xchg.collectives)
        res["round_fetches"] = fetches[0]
        res["T"] = T
        # one global round profiled on every rank at once (one session,
        # no retake: the ranks' collectives must stay in step)
        n_markers = PROFILE_MARKERS[1]
        with primed_profile(n_markers) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev, markers = device_records(prof)
        busy = sum(d[1] for d in dev)
        res["profile"] = {"markers": markers, "n_markers": n_markers,
                          "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                          "ops": sum(d[2] for d in dev),
                          "top": sorted(dev, key=lambda d: -d[1])[:8]}
        del tr._fetch
        out[label] = res
    return out


def shard_phase(cfg, main):
    """Phase 4c: ``shard_runs()`` on SHARD_WORLD ranks over gloo on the
    one card (``launch.distributed.run_ranks``: spawned ranks, a
    ``file://`` rendezvous, the job bounded by SHARD_TIMEOUT_S; a failing
    rank fails the phase).  Each run against phase 4's unsharded ``main``
    snapshot: equal selections, ``_n_selects`` and protocol meters
    (bandwidth, client and server FLOPs, host<->device bytes); the
    interconnect bill > 0, equal to the reference's formula for the run's
    global iterations and to the bytes the exchange moved; CE history
    and ``orch.L`` within 1e-5; state within 1e-4, or within phase 4's
    bound for client steps over other row counts (``chunked_state_close``:
    a rank's client step runs C/world rows); every rank's state, server
    included, bit-equal to rank 0's.  Prints each run's global-iteration
    wall ms, busy share, host round trips a global round, interconnect
    GB and launches per rank; returns the launches of the ranks'
    training, summed."""
    import numpy as np
    from repro_torch.launch.distributed import run_ranks
    from repro_torch.weights import tree_leaves
    runs = shard_runs()
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARD_WORLD, backend="gloo", args=(runs,),
                      timeout=SHARD_TIMEOUT_S)
    print(f"  {SHARD_WORLD} ranks over gloo on one card, job wall "
          f"{time.perf_counter() - t0:.2f} s (spawn and CUDA init included)")
    total = {}
    for label, hp in runs.items():
        res = ranks[0][label]
        T = res["T"]
        n_global = (hp.rounds - int(round(hp.kappa * hp.rounds))) * T
        same_sel = len(res["selections"]) == len(main["selections"]) and \
            all(np.array_equal(a, b) for a, b in zip(res["selections"],
                                                     main["selections"]))
        meter = {f: (getattr(res["meter"], f), getattr(main["meter"], f))
                 for f in ("bandwidth_bytes", "client_flops", "server_flops",
                           "host_device_bytes")}
        same_meter = all(a == b for a, b in meter.values())
        ic = res["meter"].interconnect_bytes
        bill_ok = ic > 0 and ic == res["iteration_bytes"] * n_global \
            == res["moved"].get("iteration")
        ce_ok = np.allclose(res["L"], main["L"], rtol=1e-5, atol=1e-5) and \
            all(a["ce"] is None and b["ce"] is None
                or abs(a["ce"] - b["ce"]) <= 1e-5 + 1e-5 * abs(b["ce"])
                for a, b in zip(res["history"], main["history"]))
        worst, flips, total_el = state_diff(res["state"], main["state"])
        close, what = chunked_state_close(worst, flips, total_el, hp.lr,
                                          hp.rounds * T)
        close = close or worst <= 1e-4
        ranks_equal = all(
            np.array_equal(a, b) for r in ranks[1:]
            for a, b in zip(tree_leaves(r[label]["state"]),
                            tree_leaves(res["state"])))
        n_local = int(round(hp.kappa * hp.rounds))
        local = iteration_launches(cfg, hp, global_phase=False)
        glob = iteration_launches(cfg, hp)
        want = {k: T * (n_local * local[k] + (hp.rounds - n_local) * glob[k])
                for k in ("masked_adam", "client_adam", "ntxent_stats",
                          "ntxent_backward")}
        want_round = {k: SHARD_TIMED_ROUNDS * T * v for k, v in glob.items()}
        for r, rr in enumerate(ranks):
            got, got_round = rr[label]["launches"], rr[label]["round_launches"]
            if any(got[k] != v for k, v in want.items()) or any(
                    got_round[k] != v for k, v in want_round.items()):
                raise AssertionError(
                    f"[{label}] rank {r} launched {got} in training and "
                    f"{got_round} in {SHARD_TIMED_ROUNDS} global rounds; "
                    f"derived from the hparams: {want}, {want_round}")
        print(f"  [{label}] rung={rung(hp)} vs main (round rung, "
              f"unsharded): {len(res['selections'])} selections equal="
              f"{same_sel} meters equal={same_meter} interconnect {ic} B = "
              f"{n_global} global iterations x {res['iteration_bytes']} B "
              f"(the formula; moved {res['moved'].get('iteration')} B) "
              f"ce within 1e-5={ce_ok} {what}; every rank's state (server "
              f"included) bit-equal to rank 0's={ranks_equal}")
        if not (same_sel and same_meter and bill_ok and ce_ok and close
                and ranks_equal):
            raise AssertionError(f"[{label}] sharded run parts from main: "
                                 f"meters {meter}, interconnect {ic}")
        for r, rr in enumerate(ranks):
            x = rr[label]
            per_round = x["round_collectives"]
            syncs = (sum(per_round.values()) + x["round_fetches"]) \
                / SHARD_TIMED_ROUNDS
            prof = x["profile"]
            share = (f"{prof['busy_ms'] / prof['wall_ms']:.4f}"
                     if prof["markers"] else "not measured (no marker "
                     "recorded)")
            print(f"  [{label}] rank {r}: training {x['wall_s']:.3f} s, "
                  f"accuracy {x['accuracy']}; global iteration wall ms "
                  f"(host clock, synced, {SHARD_TIMED_ROUNDS} rounds of "
                  f"{T}): median {float(np.median(x['round_ms']))} (min "
                  f"{min(x['round_ms'])}, max {max(x['round_ms'])}); host "
                  f"round trips a global round {syncs} (all-gathers "
                  f"{json.dumps(per_round)} / {SHARD_TIMED_ROUNDS} + "
                  f"fetches {x['round_fetches']} / {SHARD_TIMED_ROUNDS}); "
                  f"interconnect {x['meter'].interconnect_gb} GB in "
                  f"training; launches in training {json.dumps(x['launches'])}"
                  f", a global round {json.dumps(x['round_launches'])}")
            print(f"  [{label}] rank {r} profile of one global round: wall "
                  f"{prof['wall_ms']:.3f} ms, device busy "
                  f"{prof['busy_ms']:.3f} ms, busy share {share}, "
                  f"{prof['ops']} device ops ({prof['n_markers'] - prof['markers']}"
                  f" of {prof['n_markers']} markers lost; {SMI})")
            for key, us, count in prof["top"]:
                print(f"    {us / 1e3:9.4f} ms {count:5d} calls  {key[:90]}")
            for k, v in x["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def population_runs():
    """Phase 4b's runs: the main run's hparams on POPULATION's clients for
    one local and one global round, resident on the round rung and
    streamed ``stream_chunk`` rows at a time."""
    import dataclasses
    main = trainer_runs()["main"]
    resident = dataclasses.replace(main, rounds=2)
    return {"resident": resident,
            "streamed": dataclasses.replace(
                resident, streamed=True,
                stream_chunk=POPULATION["stream_chunk"])}


def check_more_shapes(cfg, runs, gen, checked):
    """The kernels at the shapes of phase 4b's runs that phase 4's do not
    give them: the panel GEMM at C=256 clients (resident, and a 32-row
    chunk), NT-Xent and the client step's Adam over all 256 rows (the
    resident client step; a 32-row chunk's are phase 4's main shapes),
    and masked Adam as the global step launches it over the server leaves
    and the S=n_selected(256, eta) mask rows; then the panel GEMM at every
    conv shape of the main run's hparams with the split after conv block
    2 (mu 0.5) and 4 (mu 0.75), whose plans no run of this script reaches
    otherwise."""
    import dataclasses
    from repro_torch.core.orchestrator import n_selected
    from repro_torch.models import lenet
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    n = POPULATION["clients"]
    for label, hp in population_runs().items():
        new = []
        for shape in gemm_shapes(cfg, hp, n):
            key = (hp.fused_epilogue,) + tuple(shape[1:5])
            if key not in checked:
                checked.add(key)
                new.append(shape)
        if new:
            check_gemm(cfg, hp, gen, shapes=new, run=f"C={n} {label}")
    check_ntxent(cfg, runs["main"], gen, C=n)
    hp = population_runs()["resident"]
    adam_row([adam_inputs(client_adam_leaves(cfg, hp, rows=n), True, gen)],
             kw, True, f"client_adam C={n} one client step")
    server, masks = adam_leaves(cfg, hp, n)
    adam_row([adam_inputs(server, False, gen), adam_inputs(masks, True, gen)],
             kw, False, f"masked_adam C={n} one global step "
             f"(S={n_selected(n, hp.eta)} mask rows)")
    for mu in (0.5, 0.75):
        cfg_mu = dataclasses.replace(cfg, mu=mu)
        check_gemm(cfg_mu, runs["main"], gen,
                   run=f"mu={mu} split after block "
                   f"{lenet.split_index(cfg_mu)}")


def ntxent_loss_f64(q, y, tau):
    """The supervised NT-Xent loss of q (C, B, D) in float64 torch ops,
    differentiable: the rows normalised by norm + 1e-8, the diagonal
    masked with -1e30 inside the logsumexp, per client ``sum(cnt * lse -
    pos_sum) / max(sum(cnt), 1)`` -> (C,)."""
    import torch
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    sim = q @ q.transpose(-1, -2) / tau
    eye = torch.eye(q.shape[-2], dtype=torch.bool)
    lse = torch.logsumexp(sim.masked_fill(eye, -1e30), dim=-1)
    pos = (y[..., :, None] == y[..., None, :]) & ~eye
    cnt = pos.sum(dim=-1).to(q.dtype)
    pos_sum = torch.where(pos, sim, torch.zeros((), dtype=q.dtype)).sum(-1)
    return (cnt * lse - pos_sum).sum(-1) / cnt.sum(-1).clamp(min=1.0)


def soft_threshold_cases(cfg, hp):
    """(label, shape, dtype, t) of the soft-threshold checks: a
    1024x1024 panel in float32 and bfloat16 (the reference benchmark's
    shape), and one client step's split activations of the runs with
    ``hp`` at its payload threshold -- what phase 4 hands
    ``ops.soft_threshold``."""
    import torch
    from repro_torch.models import lenet
    s = lenet.split_index(cfg)
    hw = cfg.image_size // 2 ** s
    acts = (N_CLIENTS, hp.batch_size, hw, hw, cfg.conv_channels[s - 1])
    return [("panel f32", (1024, 1024), torch.float32, 0.1),
            ("panel bf16", (1024, 1024), torch.bfloat16, 0.1),
            ("split acts f32", acts, torch.float32, hp.act_threshold)]


def check_soft_threshold(cfg, hp, gen):
    """Soft-threshold against its plain version (bit-equal), with
    ``torch.nn.functional.softshrink`` (the same function in one call)
    as the library yardstick.  Totals are over the three cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import soft_threshold as st
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0}
    for label, shape, dtype, t in soft_threshold_cases(cfg, hp):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        got = st.soft_threshold_cuda(x, t)
        want = st.soft_threshold_plain(x, t)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"soft_threshold {label}: not bit-equal "
                                 f"to its plain version (max {err})")
        lib_err = float((F.softshrink(x, t).float() - want.float())
                        .abs().max())
        ms = device_ms(lambda: st.soft_threshold_cuda(x, t), 20)
        plain_ms = device_ms(lambda: st.soft_threshold_plain(x, t), 10)
        lib_ms = device_ms(lambda: F.softshrink(x, t), 20)
        nbytes = 2.0 * x.numel() * x.element_size()
        flops = 4.0 * x.numel()
        bms, by = bound(nbytes, flops)
        print(f"  soft_threshold {label} {tuple(shape)} t={t}: "
              f"max_abs_err={err:.3e} (bit-equal) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} softshrink_ms={lib_ms:.4f} "
              f"(max_abs_err vs plain {lib_err:.3e}) bound_ms={bms:.4f} "
              f"({by}) ratio={ms / bms:.1f}x")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms),
                         ("bytes", nbytes), ("flops", flops)):
            tot[key] += val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del x, got, want
    return tot


# ---------------------------------------------------------------------------
# phase 3: one teacher-forced iteration and one round, card against CPU
# ---------------------------------------------------------------------------


def iteration_on_two_devices(cfg, main_hp):
    """One global iteration of the main run's hparams, with act_l1 on,
    over 8 clients (the CPU side stays small)."""
    import dataclasses
    import numpy as np
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    from repro_torch.weights import tree_leaves
    hp = dataclasses.replace(main_hp, rounds=1, act_l1=1e-4)
    B = hp.batch_size
    clients = mixed_noniid(8, n_per_client=B, n_test=8, seed=3)
    gpu = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    cpu = AdaSplitTrainer(cfg, hp, clients, device="cpu")
    cpu.set_state(gpu.get_state())
    xs = np.stack([c.x[:B] for c in clients])
    ys = np.stack([c.y[:B] for c in clients])
    out = {}
    for name, tr in (("gpu", gpu), ("cpu", cpu)):
        sel, ces, closs = tr.train_iteration(xs, ys, global_phase=True)
        out[name] = (sel, np.asarray(ces), closs.cpu().numpy(),
                     tr.get_state())
    (sg, cg, lg, stg), (sc, cc_, lc, stc) = out["gpu"], out["cpu"]
    if not np.array_equal(sg, sc):
        raise AssertionError(f"selections differ: {sg} vs {sc}")
    ce_err = float(np.max(np.abs(cg - cc_) / np.abs(cc_)))
    cl_err = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    worst, flips, total = state_diff(stg, stc)
    print(f"  iteration: selection={sg.tolist()} ce_rel_err={ce_err:.3e} "
          f"client_loss_rel_err={cl_err:.3e} state_max_abs_diff={worst:.3e} "
          f"state_elements_off={flips}/{total}")
    if not (ce_err < 1e-4 and cl_err < 1e-4 and worst <= 2.5 * hp.lr
            and flips <= 1e-3 * total):
        raise AssertionError("card and CPU iterations disagree")


def state_diff(a_state, b_state):
    """(max abs difference, elements off by more than 1e-5 + 1e-4 |b|,
    elements) over the float leaves of two state trees; integer leaves
    must be equal.  Adam's early steps are ~lr * sign(g): an element
    whose gradient is ~0 may flip sign between two summation orders and
    move by <= 2*lr per step."""
    import numpy as np
    from repro_torch.weights import tree_leaves
    worst, flips, total = 0.0, 0, 0
    for a, b in zip(tree_leaves(a_state), tree_leaves(b_state)):
        if a.dtype.kind != "f":
            if not np.array_equal(a, b):
                raise AssertionError("integer state differs")
            continue
        d = np.abs(a.astype(np.float64) - b)
        worst = max(worst, float(d.max()) if d.size else 0.0)
        flips += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    return worst, flips, total


def fixed_iters(clients, B, T):
    """Per-client lists of T fixed (x, y) batches: a round's data that
    every trainer and device can be handed alike."""
    return [[(c.x[t * B:(t + 1) * B], c.y[t * B:(t + 1) * B])
             for t in range(T)] for c in clients]


def round_on_two_devices(cfg, main_hp):
    """One global round (T=2 iterations) of the main run's hparams on the
    round rung, act_l1 on, over 8 clients, from one state on the card and
    on the CPU: equal selections, CE to 1e-4, state within the Adam
    sign-flip bound for T steps."""
    import dataclasses
    import numpy as np
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    hp = dataclasses.replace(main_hp, rounds=1, act_l1=1e-4)
    T, B = 2, hp.batch_size
    clients = mixed_noniid(8, n_per_client=T * B, n_test=8, seed=4)
    gpu = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    cpu = AdaSplitTrainer(cfg, hp, clients, device="cpu")
    assert rung(hp) == "round"
    cpu.set_state(gpu.get_state())
    iters = fixed_iters(clients, B, T)
    for tr in (gpu, cpu):
        tr.orch.new_round()
        tr._run_round_scan(iters, T, True)
    sel_g, sel_c = gpu.orch.S[:, 2:], cpu.orch.S[:, 2:]
    if not np.array_equal(sel_g, sel_c):
        raise AssertionError(f"round selections differ: {sel_g} vs {sel_c}")
    on = sel_c > 0
    ce_g, ce_c = gpu.orch.L[:, 2:][on], cpu.orch.L[:, 2:][on]
    ce_err = float(np.max(np.abs(ce_g - ce_c) / np.abs(ce_c)))
    worst, flips, total = state_diff(gpu.get_state(), cpu.get_state())
    print(f"  global round on the round rung, T={T}: selections "
          f"{[np.flatnonzero(sel_c[:, t]).tolist() for t in range(T)]} "
          f"equal; ce_rel_err={ce_err:.3e} state_max_abs_diff={worst:.3e} "
          f"state_elements_off={flips}/{total}")
    if not (ce_err < 1e-4 and worst <= 2.5 * hp.lr * T
            and flips <= 1e-3 * total):
        raise AssertionError("card and CPU rounds disagree")


# ---------------------------------------------------------------------------
# phase 4: the trainer at full width
# ---------------------------------------------------------------------------


LAUNCH_MODULES = ("client_conv", "masked_adam", "ntxent", "soft_threshold")


def reset_launches():
    import importlib
    for m in LAUNCH_MODULES:
        importlib.import_module(f"repro_torch.kernels.{m}").reset_launches()


def read_launches():
    import importlib
    out = {}
    for m in LAUNCH_MODULES:
        out.update(importlib.import_module(f"repro_torch.kernels.{m}")
                   .LAUNCHES)
    return out


def log_selections(orch):
    """Record every selection the orchestrator is handed, on any rung
    (``update`` eagerly, ``ingest_round`` from the rungs' fetches)."""
    import numpy as np
    log = []
    update, ingest = orch.update, orch.ingest_round

    def logged_update(selected, losses):
        log.append(np.array(selected))
        update(selected, losses)

    def logged_ingest(sel_idx, losses, state=None):
        log.extend(np.array(sel_idx))
        ingest(sel_idx, losses, state=state)
    orch.update, orch.ingest_round = logged_update, logged_ingest
    return log


def one_round(tr, iters, global_phase=True, n_rounds=1):
    """A callable running ``n_rounds`` rounds of ``iters`` on ``tr``'s
    rung: T eager iterations per round, round-rung rounds, or one epoch
    of ``n_rounds`` rounds; streamed rounds where ``tr`` streams."""
    T = min(len(it) for it in iters)
    if rung(tr.hp) == "epoch":
        if tr._streamed:
            return lambda: tr._run_epoch_streamed(n_rounds, T, global_phase,
                                                  lambda: iters)
        return lambda: tr._run_epoch_scan([iters] * n_rounds, T,
                                          global_phase)
    run = tr._run_round_streamed if tr._streamed \
        else tr._run_round_scan if rung(tr.hp) == "round" \
        else tr._run_round_eager

    def rounds():
        for _ in range(n_rounds):
            tr.orch.new_round()
            run(iters, T, global_phase)
    return rounds


def run_trainer(cfg, hp, clients, label):
    """Train, evaluate and bill one run on its rung; the Adam and NT-Xent
    kernels must have launched as ``iteration_launches`` derives from the
    hparams for its local and global iterations.  Then one more global
    round, whose launches must be T times one global iteration's (its
    GEMMs those phase 2 checked); its wall time per iteration, and its
    profile (of one global iteration where the global step takes one
    client at a time).  Returns the run's launch counts and a snapshot of its
    state, meter and selections right after training."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.adasplit import AdaSplitTrainer
    t_run = time.perf_counter()
    tr = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    selections = log_selections(tr.orch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    hist = tr.train(eval_every=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = {"state": tr.get_state(), "meter": dataclasses.replace(tr.meter),
            "selections": list(selections), "L": tr.orch.L.copy(),
            "history": [dict(h) for h in hist]}
    T = len(clients[0].x) // hp.batch_size
    for rec in hist:
        print(f"  [{label}] " + json.dumps(rec))
    acc = tr.evaluate()
    c3 = tr.c3(max(tr.meter.bandwidth_gb, 1e-12),
               max(tr.meter.client_tflops, 1e-12))
    print(f"  [{label}] rung={rung(hp)} accuracy={acc} c3(own totals as "
          f"budgets)={c3} meter={json.dumps(tr.meter.summary())}")
    print(f"  [{label}] iterations={hp.rounds * T} wall_s={wall} "
          f"steps_per_s={hp.rounds * T / wall} (evaluation included) "
          f"launches={json.dumps(launches)}")
    losses = [v for rec in hist for v in (rec["client_loss"], rec["ce"])
              if v is not None]
    if not all(np.isfinite(losses)) or not np.isfinite(acc):
        raise AssertionError(f"[{label}] non-finite loss or accuracy")
    n_local = int(round(hp.kappa * hp.rounds))
    local = iteration_launches(cfg, hp, global_phase=False)
    glob = iteration_launches(cfg, hp)
    # the GEMMs launch in evaluation too; the Adam and NT-Xent kernels not
    want = {k: T * (n_local * local[k] + (hp.rounds - n_local) * glob[k])
            for k in ("masked_adam", "client_adam", "ntxent_stats",
                      "ntxent_backward")}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"[{label}] launches {launches} in training, "
                             f"derived from the hparams: {want}")
    if not hp.batched_conv and (launches["panel_gemm"]
                                or launches["panel_gemm_bias_relu"]):
        raise AssertionError(f"[{label}] batched_conv=False launched the "
                             f"panel GEMM: {launches}")

    # one more global round on the run's rung: launches, time, profile
    run = one_round(tr, fixed_iters(clients, hp.batch_size, T))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    per_round = read_launches()
    print(f"  [{label}] launches per global round of {T} iterations: "
          f"{json.dumps(per_round)}; global iteration wall ms (host clock, "
          f"synced, this one round): {round_ms / T}")
    want = {k: T * v for k, v in glob.items()}
    if any(per_round[k] != v for k, v in want.items()):
        raise AssertionError(f"[{label}] the path launched other kernels "
                             f"than phase 2 checked: want {want}")
    if per_client_global(hp):
        # one client at a time a global iteration is ~11,000 device ops:
        # profile one iteration (a round of T=1), not a round of T
        profile_calls(one_round(tr, fixed_iters(clients, hp.batch_size, 1)),
                      1, label, "global iterations (a round of 1)",
                      "iteration")
    else:
        profile_calls(run, 2, label, f"global rounds ({T} iterations each)",
                      "round")
    print(f"  [{label}] seconds for this run (training, one more round, "
          f"its profile): {time.perf_counter() - t_run:.2f}")
    return launches, tr, snap


def time_rungs(results, clients, repeats=7):
    """Global-iteration wall time of each batched run's rung (host clock
    around one synchronised global round, divided by its T iterations),
    the runs taken in turn ``repeats`` times so that drift of the host
    hits them alike; prints the median and the spread.  The serialized
    and loop runs (~1.4 s a round) are timed once, in ``run_trainer``."""
    import numpy as np
    import torch
    runs = {}
    for label, (_, tr, _) in results.items():
        if per_client_global(tr.hp):
            continue
        T = len(clients[0].x) // tr.hp.batch_size
        runs[label] = (one_round(tr, fixed_iters(clients, tr.hp.batch_size,
                                                 T)), T)
    ms = {label: [] for label in runs}
    for i in range(repeats):
        order = list(runs)[i % len(runs):] + list(runs)[:i % len(runs)]
        for label in order:
            run, T = runs[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3 / T)
    for label, v in ms.items():
        med = float(np.median(v))
        print(f"  [{label}] rung={rung(results[label][1].hp)} global "
              f"iteration wall ms (host clock, synced; median of "
              f"{repeats} rounds taken in turn with the other runs): {med} "
              f"(min {min(v)}, max {max(v)}) steps_per_s={1e3 / med}")


def compare_rungs(results, cfg, clients):
    """Each run of ``SAME_SELECTIONS`` against its reference run: the
    main run (round rung) against the eager and the epoch rung, the
    joint run likewise, the per-client loop against the serialized
    batched step: equal selections and Meter totals, and the state
    difference (the rungs run the same ops in the same order, and so do
    the loop and the serialized step).  The joint runs must bill the
    activation gradient down: S payloads of activations + labels up and
    activations down per global iteration."""
    import numpy as np
    from repro_torch.core.accounting import split_payload_bytes
    from repro_torch.core.orchestrator import n_selected
    from repro_torch.weights import tree_leaves
    for label, ref in SAME_SELECTIONS:
        base, other = results[ref][2], results[label][2]
        tr = results[label][1]
        same_sel = len(other["selections"]) == len(base["selections"]) and \
            all(np.array_equal(a, b) for a, b in zip(other["selections"],
                                                     base["selections"]))
        # a streamed run against a resident one bills the store's traffic
        # on host_device_bytes besides
        store = store_bill(tr, clients) \
            if tr._streamed and not results[ref][1]._streamed else 0.0
        meter = {f: (getattr(other["meter"], f), getattr(base["meter"], f)
                     + (store if f == "host_device_bytes" else 0.0))
                 for f in ("bandwidth_bytes", "client_flops", "server_flops",
                           "host_device_bytes", "interconnect_bytes")}
        same_meter = all(a == b for a, b in meter.values())
        worst, flips, total = state_diff(other["state"], base["state"])
        if chunk_rows(tr.hp) == chunk_rows(results[ref][1].hp):
            # the same ops at the same shapes: bit-equal
            close = worst == 0.0
            what = f"state max abs diff={worst:.3e} (must be 0)"
        else:
            steps = tr.hp.rounds * (len(clients[0].x) // tr.hp.batch_size)
            close, what = chunked_state_close(worst, flips, total,
                                              tr.hp.lr, steps)
        if store:
            what += f"; store traffic {store} B on host_device_bytes besides"
        kind = rung(tr.hp) + (" rung, streamed" if tr._streamed
                              else " rung")
        print(f"  {label} ({kind}) vs {ref} ({rung(results[ref][1].hp)} "
              f"rung): "
              f"{len(base['selections'])} selections equal={same_sel} "
              f"meter totals equal={same_meter} {what}")
        if not (same_sel and same_meter and close):
            raise AssertionError(f"{label} selected, billed or trained "
                                 f"otherwise than {ref}")
    check_conv_ref(results, clients)
    for label in ("joint", "joint_eager", "joint_epoch"):
        hp, meter = results[label][1].hp, results[label][2]["meter"]
        T = len(clients[0].x) // hp.batch_size
        s = cfg.image_size // 2 ** len(conv_blocks(cfg)[0])
        acts = (hp.batch_size, s, s, conv_blocks(cfg)[0][-1][1])
        n_global = (hp.rounds - int(round(hp.kappa * hp.rounds))) * T
        want = n_global * n_selected(N_CLIENTS, hp.eta) * \
            split_payload_bytes(acts, hp.batch_size, grad_down=True)
        print(f"  [{label}] bandwidth {meter.bandwidth_bytes} B = "
              f"{n_global} global iterations x S x (activations + labels "
              f"up, activation gradient down): {want} B")
        if meter.bandwidth_bytes != want:
            raise AssertionError(f"[{label}] bills {meter.bandwidth_bytes} "
                                 f"bytes, not {want}")


def chunked_state_close(worst, flips, total, lr, steps):
    """Whether a streamed run whose client steps take other row counts
    than its resident twin's (chunks against all C rows) ended close to
    it after ``steps`` Adam steps: phase 3's card-vs-CPU bound, 2.5 lr a
    step and 0.1% of the elements off for a round of 2 iterations,
    scaled to the steps.  A chunk's rows take other GEMM plans (cuBLAS's
    backward among them) than all C rows: float32 sums in other orders,
    through Adam's early ~lr*sign(g) steps.  The element count is what
    binds the params: Adam moves a parameter by at most ~lr a step, so
    two runs part by at most ~2 lr a step, under the max-abs bound, which
    binds only the Adam moments.  The ``stream_whole`` and
    ``stream_eager`` witnesses, bit-equal to their twins, show that the
    store, the ring and pass B add no difference of their own.  Returns
    (close, what to print)."""
    tol, off = 2.5 * lr * steps, 5e-4 * steps
    close = worst <= tol and flips <= off * total
    return close, (f"state max abs diff={worst:.3e} (bound {tol:.1e}, binds "
                   f"the Adam moments) elements_off={flips}/{total} (bound "
                   f"{off:.1%})")


def store_bill(tr, clients):
    """The store traffic a streamed run billed on ``host_device_bytes``
    over its training (``_stream_store_bytes`` of each round)."""
    T = len(clients[0].x) // tr.hp.batch_size
    n_local = int(round(tr.hp.kappa * tr.hp.rounds))
    return (n_local * tr._stream_store_bytes(T, False)
            + (tr.hp.rounds - n_local) * tr._stream_store_bytes(T, True))


def check_conv_ref(results, clients):
    """The library-conv run bills per round as the main run does (per
    global round its bandwidth and server FLOPs, per round its client
    FLOPs and host<->device bytes); its selections printed beside the
    main run's first global round's."""
    main, conv = results["main"], results["conv_ref"]
    rounds = {}
    for label, (_, tr, _) in (("main", main), ("conv_ref", conv)):
        n_local = int(round(tr.hp.kappa * tr.hp.rounds))
        rounds[label] = {"all": tr.hp.rounds,
                         "global": tr.hp.rounds - n_local}
    bad = []
    for f, per in (("bandwidth_bytes", "global"), ("server_flops", "global"),
                   ("client_flops", "all"), ("host_device_bytes", "all")):
        want = getattr(main[2]["meter"], f) / rounds["main"][per] \
            * rounds["conv_ref"][per]
        if getattr(conv[2]["meter"], f) != want:
            bad.append((f, getattr(conv[2]["meter"], f), want))
    T = len(clients[0].x) // conv[1].hp.batch_size
    print(f"  conv_ref (batched_conv=False) bills per round as main: "
          f"{not bad}; its selections "
          f"{[s.tolist() for s in conv[2]['selections']]}, main's first "
          f"global round's {[s.tolist() for s in main[2]['selections'][:T]]}")
    if bad:
        raise AssertionError(f"conv_ref bills otherwise than main: {bad}")


def check_stream_syncs(results, clients):
    """One global and one local streamed round on the round rung (the
    ``stream`` run) and on the eager rung (``stream_eager``) with
    ``sync_debug_mode("warn")`` and every warning recorded: the host
    syncs must be those ``_stream_one_round``'s docstring states,
    ceil(C / stream_chunk) + 2T and the round's one fetch in a global
    round, ceil(C / stream_chunk) in a local one."""
    for label in ("stream", "stream_eager"):
        count_stream_syncs(label, results[label][1], clients)


def count_stream_syncs(label, tr, clients):
    import warnings
    import torch
    T = len(clients[0].x) // tr.hp.batch_size
    chunks = -(-tr.n // tr._stream_chunk)
    iters = fixed_iters(clients, tr.hp.batch_size, T)
    for phase, want in ((True, chunks + 2 * T + 1), (False, chunks)):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                one_round(tr, iters, phase)()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        what = "global" if phase else "local"
        print(f"  [{label}] one {what} round on the {rung(tr.hp)} rung "
              f"({T} iterations, {chunks} chunks) under sync_debug_mode="
              f"warn: {syncs} host syncs, the formula gives {want}")
        if syncs != want:
            raise AssertionError(f"[{label}] {syncs} host syncs in a {what} "
                                 f"round, not {want}")


def population(cfg):
    """Phase 4b: POPULATION's clients at full width, one local and one
    global round, resident on the round rung and then streamed (its
    chunks of ``stream_chunk`` rows): each one's global-iteration wall
    ms, its peak device memory and the memory it holds between the two
    rounds, both above what was allocated before the trainer was made.
    The streamed run must hold at least C x a client's store row (params,
    Adam moments, masks, mask-Adam) less between rounds, and peak lower;
    each run's kernel launches must be those ``iteration_launches``
    derives from its hparams at C clients (the client step's once per
    chunk, streamed); both must select and bill the protocol alike, and
    end within ``chunked_state_close`` of each other."""
    import numpy as np
    import torch
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    p = POPULATION
    n = p["clients"]
    clients = mixed_noniid(n, n_per_client=p["n_per_client"],
                           n_test=p["n_test"])
    out = {}
    for label, hp in population_runs().items():
        T = p["n_per_client"] // hp.batch_size
        iters = fixed_iters(clients, hp.batch_size, T)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_make = time.perf_counter()
        tr = AdaSplitTrainer(cfg, hp, clients, device="cuda")
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t_make
        selections = log_selections(tr.orch)
        held, ms = [], {}
        reset_launches()
        for phase in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_round(tr, iters, phase)()
            torch.cuda.synchronize()
            ms[phase] = (time.perf_counter() - t0) * 1e3 / T
            held.append(torch.cuda.memory_allocated() - base)
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_launches()
        local = iteration_launches(cfg, hp, False, n_clients=n)
        want = {k: T * (v + local[k])
                for k, v in iteration_launches(cfg, hp, n_clients=n).items()}
        print(f"  [population {label}] launches over the two rounds "
              f"{json.dumps(launches)}, derived from the hparams "
              f"{json.dumps(want)}")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"[population {label}] launches {launches}"
                                 f", derived from the hparams: {want}")
        row = tr.store.row_nbytes(("cp", "co", "m", "mo")) \
            if tr._streamed else None
        out[label] = {"held": held, "peak": peak, "row": row,
                      "selections": selections, "meter": tr.meter,
                      "state": tr.get_state(), "lr": hp.lr, "steps": 2 * T}
        print(f"  [population {label}] C={tr.n} B={hp.batch_size} T={T}"
              f"{f' chunk={tr._stream_chunk}' if tr._streamed else ''}: "
              f"made in {made_s:.2f} s; local iteration wall ms "
              f"{ms[False]:.3f}, global iteration wall ms {ms[True]:.3f} "
              f"(host clock, synced, one round each); memory_allocated "
              f"after the local round {held[0]} B, after the global round "
              f"{held[1]} B; peak {peak} B (max_memory_allocated, above "
              f"the {base} B held before)")
        del tr
    res, st = out["resident"], out["streamed"]
    need = p["clients"] * st["row"]
    saved = res["held"][0] - st["held"][0]
    same_sel = len(res["selections"]) == len(st["selections"]) > 0 and \
        all(np.array_equal(a, b) for a, b in
            zip(res["selections"], st["selections"]))
    same_bill = all(getattr(res["meter"], f) == getattr(st["meter"], f)
                    for f in ("bandwidth_bytes", "client_flops",
                              "server_flops"))
    worst, flips, total = state_diff(st["state"], res["state"])
    close, what = chunked_state_close(worst, flips, total, st["lr"],
                                      st["steps"])
    print(f"  [population] between rounds the streamed run holds {saved} B "
          f"less (C x store row = {n} x {st['row']} = {need} B);"
          f" peak {st['peak']} B against {res['peak']} B "
          f"({st['peak'] / res['peak']:.3f}); {len(st['selections'])} "
          f"selections equal={same_sel}; protocol meters equal={same_bill};"
          f" streamed vs resident {what}")
    if not (saved >= need and st["peak"] < res["peak"] and same_sel
            and same_bill and close):
        raise AssertionError("the streamed population does not hold less "
                             "than the resident one, or selects, bills or "
                             "trains otherwise")


def fetches_under_sync_check(tr, fn):
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("error")``, the
    mode lifted only inside the trainer's one fetch point, so that any
    other host sync raises; returns the fetches made."""
    import torch
    fetch, n = tr._fetch, [0]

    def lifted(tensors):
        n[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(tensors)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    tr._fetch = lifted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del tr._fetch
    torch.cuda.synchronize()
    return n[0]


def check_syncs(results, clients):
    """One global and one local round on the round rung, one global and
    one local epoch of two rounds on the epoch rung (one round per
    chunk, so the side-stream ring turns), for the main run and the
    joint run, and one global and one local round of the serialized run:
    one fetch per global round or epoch, none in a local one, and no
    other host sync."""
    for label, n_rounds in (("main", 1), ("epoch", 2), ("joint", 1),
                            ("joint_epoch", 2), ("serialized", 1)):
        tr = results[label][1]
        T = len(clients[0].x) // tr.hp.batch_size
        iters = fixed_iters(clients, tr.hp.batch_size, T)
        for phase, want in ((True, 1), (False, 0)):
            got = fetches_under_sync_check(
                tr, one_round(tr, iters, phase, n_rounds))
            what = ("global" if phase else "local") + \
                (" epoch" if rung(tr.hp) == "epoch" else " round")
            print(f"  [{label}] one {what} ({n_rounds} round(s) of {T}) "
                  f"under sync_debug_mode=error: {got} fetch(es), no other "
                  "host sync")
            if got != want:
                raise AssertionError(f"[{label}] {got} fetches in a {what}")


def check_loop_reads(tr, clients):
    """One global round of the per-client loop (eager rung) with
    ``sync_debug_mode("warn")`` on inside the loop only: it must read
    each selected client's CE once (and its nnz fraction under act_l1),
    as the reference does, and sync for nothing else."""
    import warnings
    import torch
    from repro_torch.core.orchestrator import n_selected
    hp = tr.hp
    T = len(clients[0].x) // hp.batch_size
    loop, seen = tr._global_iteration_loop, []

    def counted(*args):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return loop(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                seen.extend(str(w.message) for w in caught)
    tr._global_iteration_loop = counted
    try:
        one_round(tr, fixed_iters(clients, hp.batch_size, T))()
    finally:
        del tr._global_iteration_loop
    syncs = sum(SYNC_WARNING in m for m in seen)
    want = T * n_selected(N_CLIENTS, hp.eta) * (2 if hp.act_l1 else 1)
    print(f"  [loop] one global round ({T} iterations) under "
          f"sync_debug_mode=warn inside the loop: {syncs} syncs = "
          f"{want} reads of a selected client's CE")
    if syncs != want:
        raise AssertionError(f"[loop] {syncs} syncs in the per-client "
                             f"loop, not {want}")


def kernel_api(cfg, tr, clients, hp):
    """The port's public kernel API (``kernels/ops.py``) on the main
    run's own tensors: soft-threshold on one client step's split
    activations at the payload threshold, NT-Xent on their projections,
    one client conv and one masked Adam step, each against its plain
    version.  Returns the launches of these calls."""
    import numpy as np
    import torch
    from repro_torch.core.losses import ntxent_supervised
    from repro_torch.kernels import ops
    from repro_torch.kernels import soft_threshold as st
    from repro_torch.kernels.client_conv import client_proj
    from repro_torch.models import lenet
    B = hp.batch_size
    xs = torch.from_numpy(np.stack([c.x[:B] for c in clients])).cuda()
    ys = torch.from_numpy(np.stack([c.y[:B] for c in clients])).cuda()
    w = tr.client_params["blocks"][0]["w"]
    leaf = tr.server_params["fc1"]["w"]
    g = torch.full_like(leaf, 1e-3)
    mask = (torch.arange(leaf.numel(), device="cuda") % 3 > 0).to(
        leaf.dtype).reshape(leaf.shape)
    zero = torch.zeros_like(leaf)
    step = torch.tensor(1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        acts = lenet.client_forward(cfg, tr.client_params, xs)
        q = client_proj(tr.proj_params, acts.reshape(acts.shape[:2] + (-1,)))
        reset_launches()
        shrunk = ops.soft_threshold(acts, hp.act_threshold)
        loss = ops.ntxent_loss(q, ys, hp.tau)
        conv = ops.client_conv(xs, w)
        adam = ops.masked_adam(leaf, g, zero, zero, mask, step, lr=hp.lr)
        torch.cuda.synchronize()
        launches = read_launches()
        want_loss = ntxent_supervised(q, ys, hp.tau)
        want_conv = ops.client_conv(xs.cpu(), w.cpu())
        want_adam = ops.masked_adam(leaf.cpu(), g.cpu(), zero.cpu(),
                                    zero.cpu(), mask.cpu(), step.cpu(),
                                    lr=hp.lr)
    errs = {
        "soft_threshold": float((shrunk - st.soft_threshold_plain(
            acts, hp.act_threshold)).abs().max()),
        "ntxent_loss": float(((loss - want_loss).abs()
                              / want_loss.abs()).max()),
        "client_conv": float((conv.cpu() - want_conv).abs().max()),
        "masked_adam": max(float((a.cpu() - b).abs().max())
                           for a, b in zip(adam, want_adam))}
    print(f"  kernels/ops.py on the main run's tensors (split activations "
          f"{tuple(acts.shape)}, projections {tuple(q.shape)}): "
          f"launches={json.dumps(launches)} errors vs plain "
          f"{json.dumps(errs)}")
    if not (errs["soft_threshold"] == 0.0 and errs["ntxent_loss"] < 1e-4
            and errs["client_conv"] <= GEMM_TOL
            and errs["masked_adam"] <= ADAM_TOL):
        raise AssertionError("kernels/ops.py disagrees with the plain "
                             "versions")
    if not all(launches[k] > 0 for k in ("soft_threshold", "ntxent_stats",
                                         "panel_gemm", "masked_adam")):
        raise AssertionError(f"kernels/ops.py missed a kernel: {launches}")
    return launches


def profile_calls(fn, n, label, what, unit):
    """Device time by kernel over ``n`` calls of ``fn``, and the device's
    busy share of their wall time (torch.profiler; a session that
    recorded none of its markers is taken again with more).  Returns the
    wall and busy ms per call and the busy share (None when no device
    time was recorded)."""
    import torch
    for n_markers in PROFILE_MARKERS:
        torch.cuda.synchronize()
        with primed_profile(n_markers) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev, markers = device_records(prof)
        tally_markers(n_markers, markers)
        if markers > 0:
            break
        print(f"  [{label}] profile with {n_markers} markers: {markers} "
              "recorded")
    busy = sum(d[1] for d in dev)
    if not dev:
        print(f"  [{label}] profile: no device time recorded (not measured)")
        return None
    print(f"  [{label}] profile over {n} {what}: wall "
          f"{wall_us / n / 1e3:.3f} ms/{unit}, device busy "
          f"{busy / n / 1e3:.3f} ms/{unit}, busy share {busy / wall_us:.4f}, "
          f"{sum(d[2] for d in dev) // n} device ops/{unit} "
          f"({n_markers - markers} of {n_markers} markers lost; {SMI})")
    for key, us, count in sorted(dev, key=lambda d: -d[1])[:12]:
        print(f"    {us / n / 1e3:9.4f} ms/{unit} {count // n:5d} "
              f"calls/{unit}  {key[:90]}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy / n / 1e3,
            "busy_share": busy / wall_us}


# ---------------------------------------------------------------------------
# phase 8: Table 1 at full width, and the baselines on the card and the CPU
# ---------------------------------------------------------------------------

COMPARE = {"protocol": "noniid", "n_per_client": 128, "n_test": 64,
           "rounds": 4, "batch": 32}


def method_launches(cfg, result):
    """Launches of one comparison run, derived from its method and
    hparams: per baseline step the five conv GEMMs (the backward is
    ``torch.bmm``) and one client Adam a side (FedAvg, FedProx, FedNova
    one, the split baselines two, Scaffold's SGD none); AdaSplit as
    ``iteration_launches``; and each evaluation's GEMMs (one forward per
    client; AdaSplit's stacked over the clients, one GEMM a block)."""
    tr, name = result["trainer"], result["name"]
    n_c, n_s = (len(b) for b in conv_blocks(cfg))
    n_evals = sum("accuracy" in h for h in tr.history) \
        + (not tr.history[-1].get("accuracy"))
    if name == "adasplit":
        hp = tr.hp
        T = min(len(c.x) for c in tr.clients) // hp.batch_size
        n_local = int(round(hp.kappa * hp.rounds))
        local = iteration_launches(cfg, hp, global_phase=False)
        glob = iteration_launches(cfg, hp)
        want = {k: T * (n_local * local[k] + (hp.rounds - n_local) * glob[k])
                for k in glob}
        want["panel_gemm"] += n_evals * (n_c + n_s)
        return want
    adam = {"scaffold": 0, "sl-basic": 2, "splitfed": 2}.get(name, 1)
    return {"panel_gemm": (n_c + n_s) * (result["steps"]
                                         + n_evals * len(tr.clients)),
            "panel_gemm_bias_relu": 0, "masked_adam": 0,
            "client_adam": adam * result["steps"], "ntxent_stats": 0,
            "ntxent_backward": 0}


def compare_methods(cfg):
    """Table 1 (Mixed-NonIID) through ``launch/compare.py`` at
    ``lenet-cifar``'s published widths on N_CLIENTS clients: the six
    baselines and AdaSplit at (0.6, 0.6, 1e-3) and (0.75, 0.6, 1e-3),
    each run's launches held to ``method_launches``; the table, each
    run's wall s, steps/s and launches per step; a profile of one FedAvg
    local epoch and one SL-basic client turn."""
    import torch
    from repro_torch.launch import compare
    c = COMPARE
    clients = compare.dataset(c["protocol"], N_CLIENTS, c["n_per_client"],
                              c["n_test"], image_size=cfg.image_size)
    counts = {}

    def counted(tag, run):
        torch.cuda.synchronize()
        reset_launches()
        result = run()
        counts[tag] = read_launches()
        return result
    results = compare.run_table(c["protocol"], cfg, clients, c["rounds"],
                                device="cuda", batch_size=c["batch"],
                                on_method=counted)
    print(f"  table1_mixed_noniid: {N_CLIENTS} clients x "
          f"{c['n_per_client']} examples ({c['n_test']} test), "
          f"{c['rounds']} rounds, B={c['batch']}, lenet-cifar, card")
    for line in compare.format_table(results).splitlines():
        print(f"    {line}")
    for r in results:
        got, want = counts[r["method"]], method_launches(cfg, r)
        per_step = {k: v / r["steps"] for k, v in got.items() if v}
        print(f"  [{r['method']}] wall_s={r['wall_s']} steps={r['steps']} "
              f"steps_per_s={r['steps'] / r['wall_s']} (evaluation "
              f"included) launches={json.dumps(got)} per step "
              f"(evaluation included)={json.dumps(per_step)}")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"[{r['method']}] launches {got}, derived "
                                 f"from its method: {want}")
    by = {r["method"]: r["trainer"] for r in results}
    fed, sl = by["fedavg"], by["sl-basic"]
    T = len(clients[0].x) // c["batch"]
    profile_calls(lambda: fed._local_epoch(0, fed.global_params), 2,
                  "fedavg", f"local epochs ({T} steps each)", "epoch")
    profile_calls(lambda: sl._client_turn(0), 2, "sl-basic",
                  f"client turns ({T} steps each)", "turn")
    return results


def baselines_on_two_devices(cfg):
    """One round of each baseline at full width on 4 clients (T=2 steps
    each), on the card and on the CPU from one initial state, strict
    fp32: the state within the CPU tests' Adam bound (2.5 lr, at most
    0.1% of elements off by more than 1e-5 + 1e-4 |x|), the meters
    equal, the accuracies within one test example per client."""
    import numpy as np
    from repro_torch.baselines import BASELINES, make_trainer
    from repro_torch.launch import compare
    clients = compare.dataset("noniid", 4, 64, 16,
                              image_size=cfg.image_size, seed=5)
    for name in BASELINES:
        gpu = make_trainer(name, cfg, clients, device="cuda", rounds=1)
        cpu = make_trainer(name, cfg, clients, device="cpu", rounds=1)
        cpu.set_state(gpu.get_state())
        gpu.train()
        cpu.train()
        worst, flips, total = state_diff(gpu.get_state(), cpu.get_state())
        tol = 2.5 * gpu.hp.lr
        same_meter = all(getattr(gpu.meter, f) == getattr(cpu.meter, f)
                         for f in ("bandwidth_bytes", "client_flops",
                                   "server_flops", "host_device_bytes",
                                   "interconnect_bytes"))
        acc_off = float(np.max(np.abs(gpu.client_accuracies()
                                      - cpu.client_accuracies())))
        print(f"  [{name}] card vs CPU, one round: state_max_abs_diff="
              f"{worst:.3e} (bound {tol:.1e}) "
              f"state_elements_off={flips}/{total} meters equal="
              f"{same_meter} accuracy max diff={acc_off}")
        if not (worst <= tol and flips <= 1e-3 * total
                and same_meter and acc_off <= 1.0 / 16 + 1e-6):
            raise AssertionError(f"[{name}] card and CPU rounds disagree")


# ---------------------------------------------------------------------------
# phase 8b: the AdaSplit LM trainer on qwen2-0.5b at full width
# ---------------------------------------------------------------------------

# all 24 layers (split after 5), bf16 params, C=4 cohorts (the reference
# on a data axis of 4), B=16 (b=4 a cohort), S=128, kappa 0.5, eta 0.6
# (k=2), 20 steps logged in windows of 10, on both drivers
LM_TRAIN = {"cohorts": 4, "batch": 16, "seq": 128, "steps": 20,
            "log_every": 10, "kappa": 0.5, "eta": 0.6, "seed": 0}
# the two drivers on the card, bf16: the same steps on the same data, so
# equal selections; l_client and CE within this relative distance (the
# backward's accumulation order may differ run to run on the card)
LM_DRIVER_TOL = 1e-2
# card vs CPU: the same configuration at full width cut to 2 layers,
# strict fp32, 2 steps (a local and a global one; 4 until phase 4c came:
# their CPU half took 64 s of the script's time limit); f32 sums in
# other orders, and Adam's first steps move weights whose gradient is
# near eps by up to 2 lr on one side only
LM_TRAIN_TWO = {"n_layers": 2, "steps": 2}
LM_PROFILED_WINDOW = 2
LM_TRAIN_REL_TOL = 1e-3


def lm_train_setup(cfg, dtype="bfloat16"):
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import LaunchPolicy
    shape = InputShape("smoke_train", LM_TRAIN["seq"], LM_TRAIN["batch"],
                       "train")
    return shape, LaunchPolicy(param_dtype=dtype)


def lm_trainer(cfg, shape, policy, device="cuda", **kw):
    from repro_torch.launch.train import LMAdaSplitTrainer
    return LMAdaSplitTrainer(cfg, shape, policy,
                             n_cohorts=LM_TRAIN["cohorts"],
                             kappa=LM_TRAIN["kappa"], eta=LM_TRAIN["eta"],
                             seed=LM_TRAIN["seed"], device=device, **kw)


def lm_step_launches(state):
    """Launches one train step makes: NT-Xent forward and backward once,
    client Adam as ``plan_launches`` splits the trainables, nothing
    else."""
    from repro_torch.kernels.masked_adam import plan_launches
    from repro_torch.weights import tree_leaves
    sizes = [t.numel() for t in tree_leaves(state["trainables"])]
    return {"panel_gemm": 0, "panel_gemm_bias_relu": 0, "masked_adam": 0,
            "client_adam": len(plan_launches(sizes)), "ntxent_stats": 1,
            "ntxent_backward": 1, "soft_threshold": 0,
            "flash_attention": 0}


def check_lm_kernels(cfg, gen, ntxent=True):
    """The path's kernels at its shapes against their plain versions:
    NT-Xent at (C, b, proj_dim) with one label a cohort (``check_ntxent``:
    forward, backward, the loss gradient vs float64 CPU autograd; only
    with ``ntxent``, as phase 8c's configs give it the shape phase 8b
    checked), and
    client Adam over the LM's own trainables (bf16 weights and
    gradients, float32 moments) through ``adam_multi`` as the step
    calls it, one launch per ``plan_launches`` group, bit-equal to
    ``adam_multi_plain``; the Adam call's CUDA-event time and its peak
    device memory."""
    import types
    import torch
    from repro_torch.kernels import masked_adam as ma
    from repro_torch.launch.steps import init_train_state
    from repro_torch.weights import tree_leaves
    shape, policy = lm_train_setup(cfg)
    C = LM_TRAIN["cohorts"]
    hp = types.SimpleNamespace(batch_size=LM_TRAIN["batch"] // C,
                               proj_dim=policy.proj_dim, tau=policy.tau)
    if ntxent:
        check_ntxent(types.SimpleNamespace(n_classes=1), hp, gen, C=C)
    state = init_train_state(cfg, C, policy, 1, device="cuda")
    params = tree_leaves(state["trainables"])
    del state
    leaves = []
    for p in params:
        g = torch.randn(p.shape, device="cuda", generator=gen).to(p.dtype)
        mu = torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
        nu = torch.rand(p.shape, device="cuda", generator=gen) * 1e-6
        leaves.append((p, g, mu, nu, None))
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    b1t, b2t = ma.bias_corrections(step, 0.9, 0.999)
    kw = dict(lr=policy.lr, b1=0.9, b2=0.999, eps=1e-8, b1t=b1t, b2t=b2t)
    plans = ma.plan_launches([p.numel() for p in params])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ma.reset_launches()
    start.record()
    outs = [ma.adam_multi([leaves[i] for i, _ in entries], client_order=True,
                          **kw) for entries, _ in plans]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if ma.LAUNCHES["client_adam"] != len(plans):
        raise AssertionError(f"client Adam: {ma.LAUNCHES['client_adam']} "
                             f"launches for {len(plans)} groups")
    worst = 0.0
    for (entries, _), got in zip(plans, outs):
        for (i, _), o in zip(entries, got):
            want = ma.adam_multi_plain([leaves[i]], client_order=True,
                                       **kw)[0]
            for a, b in zip(o, want):
                worst = max(worst, float((a.float() - b.float()).abs().max()))
                if not torch.equal(a, b):
                    raise AssertionError(f"client Adam leaf {i} "
                                         f"{tuple(a.shape)}: not bit-equal "
                                         "to its plain version")
            del want
    n = sum(p.numel() for p in params)
    print(f"  client_adam over the LM trainables ({len(params)} leaves, "
          f"{n / 1e9:.3f} B elements, bf16 weights and gradients, {len(plans)}"
          f" launch(es)): bit-equal to plain (max_abs_err {worst:.3e}); one "
          f"call through adam_multi {ms:.2f} ms (CUDA events, bf16 staging "
          f"included), its peak above its inputs {peak:.2f} GiB")
    ma.reset_launches()


def lm_train_run(cfg, epoch_scan):
    """One 20-step run of ``LMAdaSplitTrainer`` on the card from the seed:
    the run under ``set_sync_debug_mode("error")``, lifted only in the
    trainer's fetch; its history, launches, fetches, wall time and peak
    device memory, and the trainer."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    shape, policy = lm_train_setup(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = lm_trainer(cfg, shape, policy, epoch_scan=epoch_scan)
    torch.cuda.synchronize()
    print(f"  trainer construction (random init on the card): "
          f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    fetches = fetches_under_sync_check(
        tr, lambda: tr.run(LM_TRAIN["steps"], log_every=LM_TRAIN["log_every"]))
    wall = time.perf_counter() - t0
    counts = dict(read_launches(), **fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return tr, counts, fetches, wall, peak


def check_lm_run(label, tr, counts, fetches, wall, peak):
    import math as m
    steps, W = LM_TRAIN["steps"], LM_TRAIN["log_every"]
    hist = tr.history
    n_local = int(round(LM_TRAIN["kappa"] * steps))
    phases = [h["phase"] for h in hist]
    want_launches = {k: v * steps for k, v in
                     lm_step_launches(tr.state).items()}
    got = {k: counts.get(k, 0) for k in want_launches}
    finite = all(m.isfinite(h["ce"]) and m.isfinite(h["l_client"])
                 for h in hist)
    tokens = steps * LM_TRAIN["batch"] * LM_TRAIN["seq"]
    print(f"  [{tr.cfg.name} {label}] {steps} steps: {wall:.2f} s wall from "
          f"the trainer's construction's end ({wall / steps * 1e3:.1f} "
          f"ms/step, {tokens / wall:.0f} tokens/s, cold); {fetches} fetch(es)"
          f" under sync_debug_mode=error, no other host sync; peak "
          f"max_memory_allocated {peak:.2f} GiB ({SMI}); launches {got}")
    for h in hist[::5]:
        print(f"    step {h['step']:2d} {h['phase']:6s} l_client="
              f"{h['l_client']:.5f} ce={h['ce']:.5f} aux={h['aux']:.5f} "
              f"selected={h['selected']}")
    if phases != ["local"] * n_local + ["global"] * (steps - n_local):
        raise AssertionError(f"[{label}] phases {phases}")
    if not finite:
        raise AssertionError(f"[{label}] non-finite losses")
    if fetches != -(-steps // W):
        raise AssertionError(f"[{label}] {fetches} fetches")
    if got != want_launches:
        raise AssertionError(f"[{label}] launches {got}, want "
                             f"{want_launches}")
    if any(len(h["selected"]) != (tr.k if h["phase"] == "global" else 0)
           for h in hist):
        raise AssertionError(f"[{label}] selections of the wrong size")


def lm_train_on_two_devices(cfg_full):
    """The phase's configuration at full width cut to 2 layers, strict
    fp32, LM_TRAIN_TWO's steps (half global) on the card and on the CPU
    from the card's
    initial state, with the same jitter: equal selections, l_client and
    CE within LM_TRAIN_REL_TOL."""
    import dataclasses
    two = LM_TRAIN_TWO
    cfg = dataclasses.replace(cfg_full, n_layers=two["n_layers"],
                              dtype="float32")
    shape, policy = lm_train_setup(cfg, "float32")
    t0 = time.perf_counter()
    gpu = lm_trainer(cfg, shape, policy)
    cpu = lm_trainer(cfg, shape, policy, device="cpu", state=gpu.state)
    print(f"  card and CPU trainers built, the CPU's from the card's "
          f"state: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gpu.run(two["steps"], log_every=two["steps"])
    t1 = time.perf_counter()
    cpu.run(two["steps"], log_every=two["steps"])
    t2 = time.perf_counter()
    worst, same = 0.0, True
    for a, b in zip(gpu.history, cpu.history):
        same &= a["selected"] == b["selected"] and a["phase"] == b["phase"]
        for key in ("l_client", "ce"):
            worst = max(worst, abs(a[key] - b[key]) / max(abs(b[key]), 1e-30))
    print(f"  card vs CPU, {two['n_layers']} layers of width {cfg.d_model}, "
          f"strict fp32, {two['steps']} steps "
          f"({[h['phase'] for h in cpu.history]}): selections equal {same} "
          f"({[h['selected'] for h in cpu.history]}); l_client and CE max "
          f"rel diff {worst:.3e} (tol {LM_TRAIN_REL_TOL}); card "
          f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")
    if not (same and worst <= LM_TRAIN_REL_TOL):
        raise AssertionError("LM trainer: card and CPU steps disagree")


def check_flash_refuses_grad():
    import torch
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, 2, 64, 64), device="cuda", requires_grad=True)
    k = torch.randn((1, 2, 64, 64), device="cuda")
    try:
        fa.flash_attention_cuda(q, k, k)
    except ValueError as e:
        print(f"  flash_attention_cuda on a q that requires grad: raises "
              f"({e})")
    else:
        raise AssertionError("flash_attention_cuda took a q that requires "
                             "grad")
    with torch.no_grad():
        fa.flash_attention_cuda(q, k, k)
    fa.reset_launches()


def lm_trainer_phase(gen, cfg, phase_8b=True):
    """Phase 8b (``cfg`` qwen2-0.5b; with ``phase_8b`` the flash kernel's
    grad refusal and the 2-layer card-vs-CPU run too) and each config of
    phase 8c; returns the launches of the two 20-step runs."""
    import torch
    print(f"  {cfg.name}: {cfg.n_layers} layers, split after "
          f"{cfg.split_layer}, C={LM_TRAIN['cohorts']} B={LM_TRAIN['batch']}"
          f" S={LM_TRAIN['seq']}, bf16 params")
    t0 = time.perf_counter()
    check_lm_kernels(cfg, gen, ntxent=phase_8b)
    torch.cuda.empty_cache()
    print(f"  kernels at the path's shapes: {time.perf_counter() - t0:.2f} s")
    if phase_8b:
        check_flash_refuses_grad()
    runs, launches = {}, {}
    for label, epoch_scan in (("per-step", False), ("windowed", True)):
        tr, counts, fetches, wall, peak = lm_train_run(cfg, epoch_scan)
        check_lm_run(label, tr, counts, fetches, wall, peak)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        runs[label] = list(tr.history)
        if label == "per-step":
            # one steady window of global steps, profiled (its ~12,000
            # device ops a step, ~24,000 for mamba2, take the profiler
            # long to sum, so the window is short: one step in 8c)
            W = LM_PROFILED_WINDOW if phase_8b else 1
            t0 = time.perf_counter()
            prof = profile_calls(lambda: tr.run(W, local_frac=0.0,
                                                log_every=W),
                                 1, "lm_train", "windows", "window")
            if prof:
                tokens = W * LM_TRAIN["batch"] * LM_TRAIN["seq"]
                print(f"  [{cfg.name} per-step] steady global window of {W} "
                      "steps, "
                      f"profiled: {prof['wall_ms'] / W:.2f} ms/step, "
                      f"{tokens / prof['wall_ms'] * 1e3:.0f} tokens/s, "
                      f"device busy {prof['busy_ms'] / W:.2f} ms/step, "
                      f"share {prof['busy_share']:.4f} (profile taken and "
                      f"read in {time.perf_counter() - t0:.2f} s)")
        del tr
        torch.cuda.empty_cache()
    a, b = runs["per-step"], runs["windowed"]
    same_sel = [h["selected"] for h in a] == [h["selected"] for h in b]
    rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
              for x, y in zip(a, b) for k in ("l_client", "ce"))
    bit = all(x["l_client"] == y["l_client"] and x["ce"] == y["ce"]
              for x, y in zip(a, b))
    print(f"  per-step vs windowed driver: selections equal {same_sel}; "
          f"l_client and CE max rel diff {rel:.3e} (tol {LM_DRIVER_TOL}); "
          f"bit-equal {bit}")
    if not (same_sel and rel <= LM_DRIVER_TOL):
        raise AssertionError("LM trainer: the two drivers disagree")
    if phase_8b:
        lm_train_on_two_devices(cfg)
    return launches


# phase 8c: MoE and SSM training as phase 8b runs it (C=4, B=16, S=128,
# 20 steps in windows of 10, both drivers): mamba2-370m at full width cut
# to 24 of its 48 layers (all 48 fit, ~23 GiB, but their host-bound steps
# and profile took 63-125 s of this script's time limit beside an H100
# 80GB HBM3 at 700 W), deepseek-moe-16b at published widths cut to 2
# layers (the dense layer 0 on the client, one MoE layer of 64 routed and
# 2 shared experts on the server); a run's state must reckon to at most
# TRAIN_FIT_GIB
TRAIN_ARCHS = (("mamba2-370m", 24), ("deepseek-moe-16b", 2))
# bytes a trainable element holds at the peak (bf16 weight and grad, f32
# moments, Adam's f32 staging), as phase 8b's qwen2 peak reads
TRAIN_BYTES_PER_ELEMENT = 32
TRAIN_FIT_GIB = 72


def train_elements(cfg, C):
    """The trainables of ``init_train_state(cfg, C)`` by the analytic
    count (matrices and embeddings; norms, biases and masks left out):
    C clients' embeddings and layers, the server's layers and LM head."""
    import dataclasses
    emb = cfg.padded_vocab() * cfg.d_model
    if cfg.is_encoder_decoder:
        # the client: the frontend projector and its encoder layers; the
        # server: the rest of the encoder, the decoder (each layer with
        # its cross-attention), its token embedding and the LM head
        d = cfg.d_model
        attn = 2 * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim * d
        enc = attn + 3 * d * cfg.d_ff
        s = cfg.split_layer
        return C * (d * d + s * enc) + (cfg.n_encoder_layers - s) * enc \
            + cfg.n_layers * (enc + attn) + 2 * emb

    def layers(n):      # the first n layers
        return dataclasses.replace(cfg, n_layers=n, tie_embeddings=True) \
            .param_count() - cfg.vocab_size * cfg.d_model
    client = emb + layers(cfg.split_layer)
    return C * client + layers(cfg.n_layers) - layers(cfg.split_layer) + emb


def moe_ssm_trainer_phase(gen):
    """Phase 8c; returns the launches of its runs."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    launches = {}
    for arch, layers in TRAIN_ARCHS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        n = train_elements(cfg, LM_TRAIN["cohorts"])
        gib = n * TRAIN_BYTES_PER_ELEMENT / 2**30
        print(f"  [{arch}] reckoned before allocating: {n / 1e9:.3f} B "
              f"trainable elements x {TRAIN_BYTES_PER_ELEMENT} B = {gib:.2f} "
              f"GiB at C={LM_TRAIN['cohorts']} ({SMI})")
        if gib > TRAIN_FIT_GIB:
            raise AssertionError(f"[{arch}] reckoned {gib:.2f} GiB > "
                                 f"{TRAIN_FIT_GIB}")
        for k, v in lm_trainer_phase(gen, cfg, phase_8b=False).items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 5-7: personalized LM serving on qwen2-0.5b
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2-0.5b"
ADMISSION = "admission"         # label of the continuous runs' B=1 prefills
# what sync_debug_mode("warn") says of each host sync it sees
SYNC_WARNING = "called a synchronizing CUDA operation"
LM_TWO_DEVICE = {"n_layers": 2, "batch": 2, "prompt_len": 64, "decode": 4}
# phase 7b: dense serving at head dims 128 and 96, full width, all layers,
# bf16: granite-3-8b on every path but the folded per-client FIFO mode,
# the other two through the session CLI
DENSE_ARCHS = ("granite-3-8b", "phi3-mini-3.8b", "olmo-1b")
# phase 7c: MoE serving, full width, all layers, bf16: deepseek-moe-16b on
# the same paths as granite, qwen3-moe-30b-a3b (61.1 GB of bf16 weights)
# through the session CLI alone
MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
ALL_PATHS_ARCHS = ("granite-3-8b", "deepseek-moe-16b")
# phase 7d: SSM and hybrid serving, bf16: mamba2-370m at full width and
# depth through the session and the mixed FIFO engine on phase 7's 16
# requests (split into equal-length sub-batches), its continuous refusal
# asserted; jamba-v0.1-52b at published widths cut to JAMBA_LAYERS (two
# 8-layer periods: 52.0 GB of bf16 weights; all 32 layers, ~103 GB, do
# not fit one card) through the session alone
SSM_ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
JAMBA_LAYERS = 16
# phase 6's card-vs-CPU configs, full width cut to 2 layers, strict fp32
# (the reduced jamba, ``m a m a``, is checked beside them)
TWO_DEVICE_ARCHS = (SERVE_ARCH, "granite-3-8b", "phi3-mini-3.8b") \
    + MOE_ARCHS + ("mamba2-370m",)
# phase 7e: the vision-text and encoder-decoder families, bf16:
# qwen2-vl-72b at published widths cut to VLM_LAYERS (its 80 layers,
# ~144 GB of bf16 weights, do not fit one card; 24 are ~47 GB) through
# the session CLI (B=8, 1,280-token prompts, 32 new), one direct prefill
# of the same shape with VLM_GRID**2 = 1,024 patch embeddings spliced
# over the prefix at distinct (t, h, w) streams and 31 decode steps, and
# the continuous engine on VLM_TRACE; seamless-m4t-large-v2 at full
# width and depth (24 + 24 layers, ~4.1 GB) through the session (1,024
# source frames a row) and the mixed FIFO engine on phase 7's 16
# requests (equal-length sub-batches), its continuous refusal asserted
VLM_ARCH, VLM_LAYERS, VLM_GRID = "qwen2-vl-72b", 24, 32
ENCDEC_ARCH = "seamless-m4t-large-v2"
MM_ARCHS = (VLM_ARCH, ENCDEC_ARCH)
# the continuous engine's trace: 8 requests from 4 clients, arriving in
# chunks of 3, 1, 2 between steps (client, prompt length, budget)
VLM_TRACE = [(0, 211, 12), (1, 64, 9), (2, 390, 16), (3, 120, 8),
             (0, 33, 14), (1, 301, 10), (2, 75, 11), (3, 160, 13)]
# phase 6's multimodal inputs at 2 layers: 16 patches (a 4 x 4 grid) at
# distinct streams, and 64 source frames a row
MM_TWO_GRID = 4
# flash totals on lines of their own (the `kernels` line keeps qwen2's)
OWN_TOTALS = MOE_ARCHS + ("jamba-v0.1-52b",) + MM_ARCHS


def serving_runs():
    """Phase 7's serving runs: the session CLI (client 0 of 4, its mask
    folded), the FIFO engine's 16 requests from 4 clients (prompt lengths
    128-512, 16-32 new tokens) in both batching modes, and two
    continuous-engine runs (8 slots, cache 576): the same 16 requests,
    and 24 requests whose prompts reach every bucket (5-512 tokens,
    budgets 1-48) arriving in chunks of 5, 3, 1, 7 before each step.
    Phase 5 checks the flash kernel at the shapes these runs give it."""
    import numpy as np
    rng = np.random.default_rng(0)
    n_clients = 4
    requests = [(i % n_clients, int(rng.integers(128, 513)),
                 int(rng.integers(16, 33))) for i in range(16)]
    lens = [5, 12, 23, 47, 90, 170, 300, 512]
    budgets = [1, 48, 7, 33, 2, 20, 40, 12]
    return {
        "profile": True,
        "session": {"batch": 8, "prompt_len": 512, "gen": 32, "client": 0,
                    "n_clients": n_clients},
        "requests": requests,
        "n_clients": n_clients,
        "engines": {"mixed": {"max_batch": 8, "mixed_batches": True},
                    "per_client": {"max_batch": 8, "mixed_batches": False}},
        "continuous": {
            "fifo traffic": {"requests": requests, "seed": 1, "chunks": None,
                             "max_batch": 8, "cache_len": 576},
            "every bucket": {
                "requests": [(i % n_clients, lens[i % 8], budgets[3 * i % 8])
                             for i in range(24)],
                "seed": 2, "chunks": [5, 3, 1, 7], "max_batch": 8,
                "cache_len": 576}}}


def attn_layers(cfg) -> int:
    """The self-attention layers of ``cfg``'s stack: the flash launches of
    one prefill (a pure SSM stack has none; jamba one of each 8; an
    encoder-decoder its encoder's at the source length and its decoder's
    at the BOS token; cross-attention never takes the kernel)."""
    n = sum(bool(cfg.n_heads) and cfg.is_attn_layer(i)
            for i in range(cfg.n_layers))
    return n + cfg.n_encoder_layers if cfg.is_encoder_decoder else n


def jamba_reduced():
    """Phase 6's jamba: its ``reduced()`` config in fp32."""
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(SSM_ARCHS[1]).reduced(),
                               dtype="float32")


def ssm_flash_cases():
    """Phase 5's cases of jamba: its phase 7d session in bf16 and phase
    6's reduced config in f32."""
    import torch
    jamba = SSM_ARCHS[1]
    return flash_cases(ssm_cfg(jamba), ssm_runs(jamba), [], jamba + " ") + [
        (jamba_reduced(), f"{jamba} reduced {name}", B, S, lens,
         torch.float32, True) for name, B, S, lens in [two_device_shape()]]


def ssm_cfg(arch):
    """Phase 7d's config of ``arch``: jamba cut to ``JAMBA_LAYERS``."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    return cfg


def ssm_runs(arch):
    """Phase 7d's runs: mamba2's session and mixed FIFO engine (phase 7's
    16 requests), jamba's session alone; each profiled (jamba's
    prefill and decode before its session, from params freed after)."""
    runs = serving_runs()
    runs["engines"] = {k: v for k, v in runs["engines"].items()
                       if arch == "mamba2-370m" and k == "mixed"}
    runs["continuous"] = {}
    return runs


def arch_runs(arch):
    """Phase 7b's and 7c's runs of ``arch``: phase 7's session and, for
    ``ALL_PATHS_ARCHS``, the mixed (gated) FIFO engine and the continuous
    engine on the FIFO engines' 16 requests, its prefill and decode
    profiled.  The folded per-client FIFO mode is left out: granite's
    four folded servers (~52.6 GB) beside the model (~16.7 GB) leave no
    margin on 80 GB, nor do deepseek's four folded expert ``w_down``s
    (~32 GB) beside its 32.8 GB, and qwen2-0.5b covers the mode."""
    runs = serving_runs()
    every = arch in ALL_PATHS_ARCHS
    runs["engines"] = {k: v for k, v in runs["engines"].items()
                       if every and k == "mixed"}
    runs["continuous"] = {k: v for k, v in runs["continuous"].items()
                          if every and k == "fifo traffic"}
    runs["profile"] = every
    return runs


def session_argv(cfg, runs):
    s = runs["session"]
    return ["--arch", cfg.name, "--fold-mask", "--client", str(s["client"]),
            "--n-clients", str(s["n_clients"]), "--batch", str(s["batch"]),
            "--prompt-len", str(s["prompt_len"]), "--gen", str(s["gen"]),
            "--n-layers", str(cfg.n_layers)]


def make_requests(spec, vocab_size, seed=1):
    """Requests of ``spec`` ((client, prompt length, budget) each), their
    prompts drawn from ``seed``."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(i, c, rng.integers(0, vocab_size, n).astype(np.int32),
                    new)
            for i, (c, n, new) in enumerate(spec)]


def fifo_shapes(spec, label, split=False, **kw):
    """(label, B, S, kv_len) of each prefill ``ServeEngine(**kw)`` gives
    the flash kernel on the requests of ``spec``: each batch as the
    engine's own policy forms it, right-padded to its longest prompt
    (kv_len the prompt lengths when ragged, else None); with ``split``
    (a stack ``slot_serving_ok`` refuses) a ragged batch's equal-length
    sub-batches instead, in the order of their first request."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(None, None, device="cpu", **kw)
    for r in make_requests(spec, 2):
        eng.submit(r)
    out, n = [], 0
    while eng.queue:
        lens = [len(r.prompt) for r in eng._next_batch()]
        if len(set(lens)) == 1:
            out.append((f"{label} batch {n}", len(lens), lens[0], None))
        elif split:
            out += [(f"{label} batch {n} L={L}", lens.count(L), L, None)
                    for L in dict.fromkeys(lens)]
        else:
            out.append((f"{label} batch {n}", len(lens), max(lens), lens))
        n += 1
    return out


def admission_shapes(lens_and_caps, label):
    """(label, B, S, kv_len) of each distinct admission prefill of the
    continuous engine, for prompts of length L into an engine of
    ``cache_len`` cap ((L, cap) each): B=1 right-padded to the engine's
    own bucket, kv_len [L] (the engine always passes its last index)."""
    from repro_torch.serve.continuous import _bucket
    out = {}
    for L, cap in lens_and_caps:
        S = _bucket(L, cap)
        out.setdefault((S, L), (f"{label} L={L}", 1, S, [L]))
    return list(out.values())


def prefill_shapes(runs, split=False):
    """(label, B, S, kv_len) of every prefill phase 7's serving runs give
    the flash kernel: the session's equal-length batch, each FIFO engine
    batch (``fifo_shapes``, ``split`` as there), and each distinct
    admission prefill of the continuous runs."""
    s = runs["session"]
    out = [("session", s["batch"], s["prompt_len"], None)]
    for mode, kw in runs["engines"].items():
        out += fifo_shapes(runs["requests"], mode, split, **kw)
    return out + admission_shapes(
        [(L, run["cache_len"]) for run in runs["continuous"].values()
         for _, L, _ in run["requests"]], ADMISSION)


def fp32_prefill_shapes():
    """(label, B, S, kv_len) of every prefill phase 6's engines give the
    f32 kernel: the continuous engine's admissions, each solo request
    and the mixed FIFO engine's batches."""
    e = ENGINES_FP32
    return admission_shapes([(L, e["cache_len"]) for _, L, _ in e["spec"]],
                            f"fp32 {ADMISSION}") + [
        sh for name, kw in e["engines"].items()
        for sh in fifo_shapes(e["spec"], f"fp32 {name}", **kw)]


def flash_rounded_p(q, k, v, kv_len, causal=True):
    """GQA attention (causal unless asked otherwise) as the bf16 kernel
    would compute it if it rounded P once to bf16 before P V (the TPU
    kernel's and SDPA's choice) and kept everything else in f32: the
    control that its P = P_hi + P_lo split must beat."""
    import torch
    B, Hq, S, hd = q.shape
    G = Hq // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = q.float() @ kf.transpose(-1, -2) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    seen = (pos[None, :] <= pos[:, None] if causal else
            torch.ones((S, S), dtype=torch.bool, device=q.device))[None, None]
    if kv_len is not None:
        seen = seen & (pos[None, None, None, :] < kv_len[:, None, None, None])
    s = s.masked_fill(~seen, -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = p.to(torch.bfloat16).float() @ vf / p.sum(dim=-1, keepdim=True)
    return o.to(torch.bfloat16)


def split_p_check(label, got, want, control):
    """Hold the bf16 kernel's outputs to the plain version's more closely
    than the single-rounded-P control: the share of outputs that differ
    and the mean error, each at most ``SPLIT_P_MARGIN`` of the
    control's."""
    def stats(x):
        d = (x.float() - want.float()).abs()
        return float((d > 0).float().mean()), float(d.mean()), float(d.max())
    (frac, mean, _), (c_frac, c_mean, c_max) = stats(got), stats(control)
    print(f"    split P: outputs off the plain version {frac:.4%} (control "
          f"{c_frac:.4%}), mean abs err {mean:.3e} (control {c_mean:.3e}), "
          f"control max abs err {c_max:.3e}")
    if not (frac <= SPLIT_P_MARGIN * c_frac and mean <= SPLIT_P_MARGIN * c_mean):
        raise AssertionError(f"flash_attention {label}: no closer to the plain "
                             "version than a single-rounded P")


def flash_cases(cfg, runs, f32_shapes, label=""):
    """(cfg, label, B, S, kv_len, dtype, causal) of phase 5 for one
    config: bf16 at every prefill shape ``runs`` give the kernel (a
    stack ``slot_serving_ok`` refuses prefills a ragged FIFO batch by
    equal-length sub-batches), f32 at ``f32_shapes``; labels prefixed
    with ``label``.  An encoder-decoder's prefill of (B, S) launches the
    kernel twice a layer pair: its encoder's non-causal attention at
    (B, S) and its decoder's causal one over the BOS token at (B, 1),
    so each shape gives those two cases."""
    import torch
    from repro_torch.models.decode import slot_serving_ok
    split = not slot_serving_ok(cfg)
    out = []
    for shapes, dt in ((prefill_shapes(runs, split), torch.bfloat16),
                       (f32_shapes, torch.float32)):
        for name, B, S, lens in shapes:
            if cfg.is_encoder_decoder:
                out += [(cfg, f"{label}encoder {name}", B, S, None, dt,
                         False),
                        (cfg, f"{label}decoder BOS {name}", B, 1, None, dt,
                         True)]
            else:
                out.append((cfg, label + name, B, S, lens, dt, True))
    return out


def two_device_shape():
    two = LM_TWO_DEVICE
    return ("card-vs-CPU prefill", two["batch"], two["prompt_len"], None)


def check_flash(cases, gen):
    """The kernel at every case of ``flash_cases`` (kv_len where ragged;
    non-causal for an encoder's attention): phase 7's and 7b's serving
    prefill shapes in bf16 and phase 6's f32 ones (its engines' and the card-vs-CPU prefills),
    against its plain version; device times of the kernel, the plain
    version and one SDPA call (library yardstick only: the port never
    calls it); the bound from the bytes each call must move and the
    causal, kv_len-limited pairs it must compute; host times per call of
    the wrapper and of SDPA.  In bf16, ``split_p_check`` against
    ``flash_rounded_p``.  Totals per head dim over the bf16 session and
    FIFO shapes, and apart over the bf16 B=1 admission shapes; an MoE
    config's (``MOE_ARCHS``) apart from the dense ones.  Returns
    the hd-64 session and FIFO totals (the ``kernels`` line's) with the
    largest error of every case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")
    totals, worst = {}, 0.0
    for cfg, label, B, S, lens, dtype, causal in cases:
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (torch.randn((B, S, h, hd), device="cuda", generator=gen)
                   .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
        kv_len = None if lens is None else torch.tensor(
            lens, dtype=torch.int32, device="cuda")
        got = fa.flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        kv_len=kv_len)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        err = float((got.float() - want.float()).abs().max())
        if not err <= FLASH_TOL[name]:
            raise AssertionError(f"flash_attention {label}: max abs err {err}")
        pos = torch.arange(S, device="cuda")
        mask = None if lens is None else (
            (pos[None, :] <= pos[:, None] if causal else True)
            & (pos[None, None, None, :] < kv_len[:, None, None, None]))

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        lib_err = float((sdpa().float() - want.float()).abs().max())
        ms = device_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, kv_len=kv_len), 10)
        plain_ms = device_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, kv_len=kv_len), 3)
        lib_ms = device_ms(sdpa, 10)
        host = host_us(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, kv_len=kv_len))
        lib_host = host_us(sdpa)
        # each input read once, the output written once; QK^T and PV over
        # the (query, key) pairs causality and kv_len leave
        L = lens or [S] * B
        pairs = sum(n * (n + 1) // 2 + (S - n) * n if causal else S * n
                    for n in L)
        flops = 4.0 * hd * Hq * pairs
        nbytes = q.element_size() * B * S * hd * (2 * Hq + 2 * Hkv) \
            + (4 * B if lens else 0)
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        bms, by = bound(nbytes, flops, rate)
        kv = "full" if lens is None else (lens if B == 1 else "ragged")
        print(f"  flash_attention {label} {name} B={B} Hq={Hq} Hkv={Hkv} "
              f"S={S} hd={hd} kv_len={kv}"
              f"{'' if causal else ' non-causal'}: "
              f"max_abs_err={err:.3e} (tol {FLASH_TOL[name]}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} (max_abs_err vs plain {lib_err:.3e}) "
              f"bound_ms={bms:.4f} ({by}) ratio={ms / bms:.1f}x "
              f"ms/sdpa={ms / lib_ms:.3f} host_us={host:.1f} "
              f"sdpa_host_us={lib_host:.1f}")
        if dtype == torch.bfloat16:
            split_p_check(label, got, want,
                          flash_rounded_p(q, k, v, kv_len, causal))
            kind = "B=1 admission" if ADMISSION in label else \
                "session and FIFO prefill"
            # an MoE config's shapes total on lines of their own
            kind += "".join(f" of {a}" for a in OWN_TOTALS
                            if label.startswith(a + " "))
            into = totals.setdefault((hd, kind), dict.fromkeys(keys, 0.0))
            for key, val in zip(keys, (ms, plain_ms, lib_ms, bms, nbytes,
                                       flops)):
                into[key] += val
        worst = max(worst, err)
        del q, k, v, got, want, mask
    for (hd, what), t in sorted(totals.items()):
        t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOP_PER_S)[1]
        print(f"  flash_attention total over the bf16 {what} shapes at "
              f"hd={hd}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"sdpa_ms={t['library_ms']:.4f} "
              f"ms/sdpa={t['ms'] / t['library_ms']:.3f} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    return dict(totals.get((64, "session and FIFO prefill"), {}),
                max_abs_err=worst)


def vision_positions(B, S, grid):
    """(B, S, 3) int32 (t, h, w) position streams of a prompt whose first
    grid x grid tokens are patches: (0, row, col) there, then grid + i
    on all three streams for the text."""
    import torch
    f = grid * grid
    i = torch.arange(min(f, S), dtype=torch.int32)
    pos = torch.empty((S, 3), dtype=torch.int32)
    pos[:len(i)] = torch.stack([0 * i, i // grid, i % grid], dim=-1)
    pos[f:] = (grid + torch.arange(max(S - f, 0), dtype=torch.int32))[:, None]
    return pos.expand(B, S, 3).contiguous()


def mm_extras(cfg, B, S, grid, dtype, device, seed):
    """The modality inputs of a multimodal config, N(0, 1) from ``seed``
    on ``device``: an encoder-decoder's S source frames a row, a
    vision-text config's grid x grid patches and their distinct
    streams (``vision_positions``); None for a text config."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    if cfg.is_encoder_decoder:
        return {"src_embeds": draw((B, S, cfg.d_model))}
    if cfg.modality == "vision_text":
        return {"vision_embeds": draw((B, grid * grid, cfg.d_model)),
                "positions": vision_positions(B, S, grid).to(device)}
    return None


def lm_on_two_devices(arch, cfg=None):
    """``arch`` at full width cut to 2 layers (or ``cfg``), strict fp32:
    one prefill and teacher-forced decode steps on the card and on the
    CPU, from the same params (the port's own init, on the card) and
    the same modality inputs (``mm_extras``: a vision-text config's 16
    patches at distinct M-RoPE streams, an encoder-decoder's source
    frames, whose cross-attention runs in the prefill and every decode
    step); an SSM stack's final mamba states compared too."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    from repro_torch.weights import tree_map
    two = LM_TWO_DEVICE
    cfg = cfg or dataclasses.replace(get_config(arch),
                                     n_layers=two["n_layers"],
                                     dtype="float32")
    B, S = two["batch"], two["prompt_len"]
    gpu = init_serve_params(cfg, 0, "float32", device="cuda")
    cpu = tree_map(lambda t: t.cpu(), gpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    ex = mm_extras(cfg, B, S, MM_TWO_GRID, torch.float32, "cpu", 3)
    ex_gpu = None if ex is None else {k: v.cuda() for k, v in ex.items()}
    fa.reset_launches()
    with routes_on_two_devices() as routes:
        lg, cg = dec.prefill(cfg, gpu, toks.cuda(), ex_gpu,
                             cache_len=S + two["decode"])
        launches = fa.LAUNCHES["flash_attention"]
        lc, cc = dec.prefill(cfg, cpu, toks, ex,
                             cache_len=S + two["decode"])
        worst, same, steps = 0.0, True, []
        for t in range(two["decode"] + 1):
            if t:
                lg, cg = dec.decode_step(cfg, gpu, tok.cuda(), cg, S + t - 1)
                lc, cc = dec.decode_step(cfg, cpu, tok, cc, S + t - 1)
            worst, same, tok = logits_step(cfg, lg, lc, worst, same, steps)
    state = ""
    if cfg.ssm_state:
        st = []
        for side in ("client", "server"):
            for sa, sb in zip(cg[side], cc[side]):
                st += [(sa[j]["mixer"]["state"], sb[j]["mixer"]["state"])
                       for j in sa if "state" in sa[j]["mixer"]]
        err = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                  for a, b in st)
        state = (f"; final SSM states of {len(st)} segment positions max "
                 f"rel err {err:.3e}")
        worst = max(worst, err)
    inputs = ""
    if ex is not None:
        inputs = ", " + ", ".join(f"{k} {tuple(v.shape)}"
                                  for k, v in ex.items())
    print(f"  [{cfg.name}] prefill B={B} S={S} + {two['decode']} decode "
          f"steps, {cfg.n_layers} layers of width {cfg.d_model} (hd "
          f"{cfg.head_dim}{inputs}): flash launches "
          f"on the card {launches}; logits max rel err {worst:.3e}; greedy "
          f"tokens equal on both devices: {same} (card's: {steps})"
          + state + route_margins(cfg, routes))
    if launches != attn_layers(cfg):
        raise AssertionError(f"[{arch}] card prefill launched flash "
                             f"{launches} times")
    if not (worst < LM_REL_TOL and same):
        raise AssertionError(f"[{arch}] card and CPU LM steps disagree")


def train_step_on_two_devices(arch):
    """One global train step of ``arch``'s reduced config (float32, C=2
    cohorts of 4 rows, S=16) on the card and on the CPU from the card's
    state: the client loss, CE and router aux within LM_TRAIN_REL_TOL,
    the new Adam moments within LM_TRAIN_REL_TOL of each leaf's largest
    magnitude."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import steps as tsteps
    from repro_torch.weights import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    C, b, S = 2, 4, 16
    pol = tsteps.LaunchPolicy(param_dtype="float32")
    fn = tsteps.build_train_step(cfg, InputShape("t", S, C * b, "train"),
                                 pol, n_cohorts=C)
    state = tsteps.init_train_state(cfg, C, pol, 0, device="cuda")
    cpu_state = tree_map(lambda t: t.cpu(), state)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (C * b, S)),
             "labels": rng.integers(0, cfg.vocab_size, (C * b, S)),
             "seq_class": np.repeat(np.arange(C), b)}
    batch = {k: torch.from_numpy(v.astype(np.int32)) for k, v in
             batch.items()}
    batch["select"] = torch.ones((C,), dtype=torch.float32)
    new, mg = fn(state, {k: v.cuda() for k, v in batch.items()})
    new_c, mc = fn(cpu_state, batch)
    loss = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])),
                                                      1e-30)
               for k in ("l_client", "ce", "aux"))
    mom = max(float((a.cpu() - c).abs().max()) / (float(c.abs().max()) or 1)
              for key in ("mu", "nu")
              for a, c in zip(tree_leaves(new["opt"][key]),
                              tree_leaves(new_c["opt"][key])))
    terms = " ".join(f"{k}={float(mc[k]):.5f}"
                     for k in ("l_client", "ce", "aux"))
    print(f"  [{cfg.name} reduced train step] {terms}: card vs CPU losses "
          f"max rel diff {loss:.3e}, moments {mom:.3e} (tol "
          f"{LM_TRAIN_REL_TOL})")
    if not (loss <= LM_TRAIN_REL_TOL and mom <= LM_TRAIN_REL_TOL):
        raise AssertionError(f"[{arch}] card and CPU train steps disagree")


def logits_step(cfg, lg, lc, worst, same, steps):
    """One step of ``lm_on_two_devices``: the card's and the CPU's logits
    compared over the real vocabulary; returns the running worst
    relative error and token agreement (a near-tie within the error
    counts as agreement) and the card's greedy token, fed to both."""
    import torch
    # over the real vocabulary: the pad columns carry the -1e9 bias
    a, b = lg.cpu()[..., :cfg.vocab_size], lc[..., :cfg.vocab_size]
    scale = float(b.abs().max())
    rel = float((a - b).abs().max()) / scale
    worst = max(worst, rel)
    tok = a.argmax(-1).to(torch.int32)      # the card's, fed to both
    top2 = b.topk(2, dim=-1).values
    tie = bool(((top2[..., 0] - top2[..., 1]) <= 2 * rel * scale).any())
    eq = bool(torch.equal(tok, b.argmax(-1).to(torch.int32)))
    same &= eq or tie
    steps.append(tok[:, 0].tolist())
    return worst, same, tok


@contextlib.contextmanager
def routes_on_two_devices():
    """Record every MoE router call's expert indices and f32 softmax
    probabilities, per device, in call order."""
    from repro_torch.models import moe
    route, log = moe.route, {"cuda": [], "cpu": []}

    def recorded(p, x, cfg):
        out = route(p, x, cfg)
        log[x.device.type].append((out[1].cpu(), out[2].cpu()))
        return out
    moe.route = recorded
    try:
        yield log
    finally:
        moe.route = route


def route_margins(cfg, routes) -> str:
    """The smallest top-K router margin (the K-th largest probability
    less the (K+1)-th, on the CPU) over every MoE call of both runs, and
    each token the two devices route differently, with its margin."""
    import torch
    if not cfg.n_experts:
        return ""
    K, least, parted = cfg.experts_per_token, math.inf, []
    for call, ((ig, _), (ic, pc)) in enumerate(zip(routes["cuda"],
                                                   routes["cpu"])):
        top = torch.sort(pc, dim=-1, descending=True).values
        margin = top[..., K - 1] - top[..., K]
        least = min(least, float(margin.min()))
        for b, s_ in (ig != ic).any(-1).nonzero().tolist():
            parted.append((call, b, s_, float(margin[b, s_])))
    out = (f"; {len(routes['cuda'])} router calls a device, smallest top-"
           f"{K} router margin {least:.3e}; tokens routed differently: "
           f"{len(parted)}")
    for call, b, s_, m in parted:
        out += f"\n    router call {call} row {b} token {s_}: margin {m:.3e}"
    return out


# phase 6's engines: the reference test's SPEC (tests/test_serve_continuous.py)
# with its prompts scaled from 3-11 to 20-120 tokens
ENGINES_FP32 = {"spec": [(0, 82, 4), (1, 45, 2), (2, 120, 6), (0, 20, 1),
                         (1, 83, 3), (3, 57, 5)],
                "n_clients": 4, "max_batch": 3, "cache_len": 128,
                "engines": {"solo": {"max_batch": 1},
                            "mixed FIFO": {"mixed_batches": True}}}


def fresh(reqs):
    """New requests with the same ids, clients, prompts and budgets."""
    from repro_torch.serve import Request
    return [Request(r.req_id, r.client_id, r.prompt, r.max_new_tokens)
            for r in reqs]


def solo_gaps(cfg, params, masks, req):
    """The top-2 logit gap at each output position of ``req`` served
    alone as ``ServeEngine(max_batch=1)`` serves it (the client's mask
    folded), teacher-forced on its own greedy tokens."""
    import torch
    from repro_torch.core import masks as masks_mod
    from repro_torch.models import decode as dec
    p = {"client": params["client"], "server": masks_mod.fold_unit_masks(
        cfg, params["server"], masks, req.client_id)}
    L, n = len(req.prompt), req.max_new_tokens
    lg, cache = dec.prefill(cfg, p, torch.from_numpy(req.prompt[None]).cuda(),
                            cache_len=L + n + 1)
    gaps = []
    for t in range(n):
        top2 = lg[0, 0, :cfg.vocab_size].topk(2).values
        gaps.append(float(top2[0] - top2[1]))
        if t + 1 < n:
            tok = torch.full((1, 1), int(req.output[t]), dtype=torch.int32,
                             device="cuda")
            lg, cache = dec.decode_step(cfg, p, tok, cache, L + t)
    return gaps


def engines_agree_fp32():
    """qwen2-0.5b at full width cut to 2 layers, strict fp32, on the card:
    a ragged trace of mixed clients and 0/1 masks through
    ``ContinuousEngine`` (3 slots), ``ServeEngine(max_batch=1)`` one
    request at a time (solo) and ``ServeEngine(mixed_batches=True)``.
    The greedy tokens must be equal, and the continuous engine's stats
    those of its scheduler's dry run.  Prints the solo runs' smallest
    top-2 logit gap and, where an engine parts from solo, the position
    and the solo gap there."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.serve import ContinuousEngine, ServeEngine
    e = ENGINES_FP32
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=LM_TWO_DEVICE["n_layers"],
                              dtype="float32")
    params = init_serve_params(cfg, 0, "float32", device="cuda")
    masks = tserve.random_masks(cfg, e["n_clients"], device="cuda")
    reqs = make_requests(e["spec"], cfg.vocab_size, seed=4)

    def serve(eng, rs):
        for r in rs:
            eng.submit(r)
        eng.run_until_idle()
        return [r.output for r in rs]
    fa.reset_launches()
    cont = ContinuousEngine(cfg, params, masks, max_batch=e["max_batch"],
                            cache_len=e["cache_len"])
    outs = {"continuous": serve(cont, fresh(reqs))}
    launches = fa.LAUNCHES["flash_attention"]
    solo = fresh(reqs)
    outs["solo"] = [serve(ServeEngine(cfg, params, masks,
                                      **e["engines"]["solo"]), [r])[0]
                    for r in solo]
    outs["mixed FIFO"] = serve(ServeEngine(cfg, params, masks,
                                           **e["engines"]["mixed FIFO"]),
                               fresh(reqs))
    gaps = [solo_gaps(cfg, params, masks, r) for r in solo]
    gmin, at = min((g, (i, t)) for i, gs in enumerate(gaps)
                   for t, g in enumerate(gs))
    parted = [(name, i, int(np.argmax(outs[name][i] != outs["solo"][i])))
              for name in ("continuous", "mixed FIFO")
              for i in range(len(reqs))
              if not np.array_equal(outs[name][i], outs["solo"][i])]
    want, log = scheduler_dry_run({"requests": e["spec"], "chunks": None,
                                   "max_batch": e["max_batch"]})
    got = {k: getattr(cont.stats, k) for k in want}
    print(f"  {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}, budgets "
          f"{[r.max_new_tokens for r in reqs]}) from {e['n_clients']} "
          f"clients, {cfg.n_layers} layers of width {cfg.d_model}: "
          f"continuous (max_batch={e['max_batch']}), solo and mixed FIFO "
          f"tokens equal: {not parted}; solo top-2 logit gap min "
          f"{gmin:.4e} (request {at[0]}, position {at[1]}); continuous "
          f"EngineStats {got} (dry run {want}); flash launches {launches} "
          f"for {len(reqs)} admission prefills")
    for name, i, t in parted:
        print(f"  {name} parts from solo at request {i} position {t}: "
              f"{outs[name][i].tolist()} against {outs['solo'][i].tolist()};"
              f" solo top-2 logit gap there {gaps[i][t]:.4e}")
    if parted:
        raise AssertionError("continuous, solo and mixed FIFO tokens differ "
                             "in strict fp32")
    if got != want or cont.sched.admission_log != log:
        raise AssertionError("continuous EngineStats differ from the dry run")
    if launches != cfg.n_layers * len(reqs):
        raise AssertionError(f"{launches} flash launches for {len(reqs)} "
                             "admission prefills")


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(module, name):
    """Wrap ``module.name`` so that each call's wall time, synchronised
    before and after, is appended to the yielded list."""
    import torch
    fn, log = getattr(module, name), []

    def wrapper(*a, **kw):
        # the timer's own syncs are not the timed code's: out of any
        # sync-debug mode the caller set
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        _sync()
        torch.cuda.set_sync_debug_mode(mode)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.set_sync_debug_mode(0)
        _sync()
        torch.cuda.set_sync_debug_mode(mode)
        log.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapper)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def scheduler_dry_run(run):
    """The counting ``EngineStats`` fields and the admission log of a
    continuous run, from the port's ``SlotScheduler`` alone, driven by
    the engine's own loop (the chunk of arrivals, the admission chain,
    one step of the active slots) with no model."""
    from repro_torch.serve import SlotScheduler
    sched = SlotScheduler(run["max_batch"])
    st = dict.fromkeys(("requests", "tokens", "completed", "decode_steps",
                        "slot_steps"), 0)

    def finish(pairs):
        for _, r in pairs:
            st["requests"] += 1
            st["completed"] += r.max_new_tokens

    def step():
        while True:
            admitted = sched.admit()
            st["tokens"] += len(admitted)
            completed = sched.pop_completed()
            finish(completed)
            if not admitted and not completed:
                break
        if sched.active():
            n = sched.note_step()
            st["decode_steps"] += 1
            st["slot_steps"] += n
            st["tokens"] += n
            finish(sched.pop_completed())
    drive(sched, make_requests(run["requests"], 2), run["chunks"], step)
    return st, sched.admission_log


def drive(target, reqs, chunks, step):
    """Submit ``reqs`` to ``target`` (an engine or a scheduler) in chunks
    (sizes cycled; None: all at once) before each ``step()``, until
    nothing is queued or in flight."""
    sched = getattr(target, "sched", target)
    pending, k, chunks = list(reqs), 0, chunks or [len(reqs)]
    while pending or not sched.idle():
        n = chunks[k % len(chunks)]
        k += 1
        for r in pending[:n]:
            target.submit(r)
        pending = pending[n:]
        step()


def steady(sched) -> bool:
    """Whether the next ``step()`` neither admits nor completes: no queued
    request meets a free slot, and no request in flight reaches its
    budget in this step."""
    live = [s for s in sched.slots if s is not None]
    if sched.queue and len(live) < sched.n_slots:
        return False
    return bool(live) and all(s.gen + 1 < s.req.max_new_tokens for s in live)


def run_continuous(cfg, params, masks, runs, fifo_tokens, device="cuda"):
    """Phase 7's continuous runs at full width, bf16, each fed its
    arrivals between ``step()`` calls (run "fifo traffic": all before
    the first), its admission prefills timed, synchronised.  Each step
    that neither admits nor completes runs under
    ``sync_debug_mode("error")``, the others under "warn", whose sync
    warnings must be the engine's own.  Each run's ``EngineStats`` must
    be its scheduler dry run's, its admission log 0..n-1, its gate
    cache one miss a client, and each admission prefill one flash launch
    a layer (checked by the caller); each run's peak device memory is
    printed.  Then, where the runs hold "every bucket", one eight-slot
    gated decode step in steady state is profiled.  Returns per run its
    flash launches and admission prefills."""
    import dataclasses
    import warnings
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode as dec
    from repro_torch.serve import ContinuousEngine
    out = {}
    for name, run in runs["continuous"].items():
        eng = ContinuousEngine(cfg, params, masks, device=device,
                               max_batch=run["max_batch"],
                               cache_len=run["cache_len"])
        reqs = make_requests(run["requests"], cfg.vocab_size, run["seed"])
        syncs = {"steady": 0, "after_last_admission": 0, "warned": 0}

        def step():
            if steady(eng.sched):
                syncs["steady"] += 1
                syncs["after_last_admission"] += \
                    len(eng.sched.admission_log) == len(reqs)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                return
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng.step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs["warned"] += sum(SYNC_WARNING in str(w.message)
                                   for w in caught)
        fa.reset_launches()
        count_drops(cfg)
        _sync()
        t0 = time.perf_counter()
        with timed(dec, "prefill") as pre:
            drive(eng, reqs, run["chunks"], step)
        _sync()
        wall = time.perf_counter() - t0
        done, st = eng._done, eng.stats
        n_adm = eng.host_syncs["prompt_uploads"]
        launches = fa.LAUNCHES["flash_attention"]
        if sorted(r.req_id for r in done) != list(range(len(reqs))) or any(
                r.output.shape != (r.max_new_tokens,)
                or not ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
                for r in done):
            raise AssertionError(f"[continuous {name}] a request did not "
                                 "complete with in-vocab tokens")
        want, log = scheduler_dry_run(run)
        got = {k: getattr(st, k) for k in want}
        lat = np.array([r.latency_s for r in done])
        tag = f"  [{cfg.name} continuous {name}]"
        print(f"{tag} {len(done)} requests in {wall} s: tokens/s="
              f"{st.tokens / wall} completed/s={st.completed / wall} "
              f"latency_s p50={np.median(lat)} max={lat.max()} "
              f"occupancy={st.occupancy} flash_launches={launches} for "
              f"{n_adm} admission prefills{drops(cfg)}")
        print(f"{tag} decode_ms_per_step="
              f"{(wall - sum(pre)) / st.decode_steps * 1e3} admission "
              f"prefill_ms={[round(x * 1e3, 3) for x in pre]} (mean "
              f"{np.mean(pre) * 1e3}); admission log "
              f"{eng.sched.admission_log}; gate hits {st.gate_hits} misses "
              f"{st.gate_misses}; steady-state steps (no admission, no "
              f"completion) under sync_debug_mode=error: {syncs['steady']},"
              f" {syncs['after_last_admission']} of them after the last "
              f"admission: no host sync; host syncs warned in the other "
              f"steps: {syncs['warned']} (the engine's own: "
              f"{eng.host_syncs})")
        if run["requests"] == runs["requests"]:
            agree = np.mean([np.mean(r.output == fifo_tokens[r.req_id])
                             for r in done])
            print(f"{tag} tokens equal to the mixed FIFO engine's: "
                  f"{agree:.4f} (bf16 near-ties; f32 equality is held by "
                  "phase 6 and tests/test_torch_continuous.py)")
        print(f"{tag} EngineStats " + json.dumps(dataclasses.asdict(st))
              + f" dry run {json.dumps(want)}")
        if got != want or eng.sched.admission_log != log:
            raise AssertionError(f"[continuous {name}] EngineStats or "
                                 "admission log differ from the dry run")
        if not (syncs["after_last_admission"] >= 1
                and syncs["warned"] == sum(eng.host_syncs.values())
                and log == list(range(len(reqs)))
                and (st.gate_misses, st.gate_hits)
                == (runs["n_clients"], len(reqs) - runs["n_clients"])):
            raise AssertionError(f"[continuous {name}] no steady step after "
                                 "the last admission, host syncs other than "
                                 "the engine's own, or admission order or "
                                 "gate cache counts off")
        peak_memory(tag)
        out[f"continuous {name}"] = (launches, n_adm)
    if "every bucket" not in runs["continuous"]:
        return out

    # where a decode step's time goes: eight slots of four clients, gated
    run = runs["continuous"]["every bucket"]
    eng = ContinuousEngine(cfg, params, masks, device=device,
                           max_batch=run["max_batch"],
                           cache_len=run["cache_len"])
    spec = [(c, n, 64) for c, n, _ in run["requests"][:run["max_batch"]]]
    for r in make_requests(spec, cfg.vocab_size, seed=3):
        eng.submit(r)
    fa.reset_launches()
    eng.step()
    out["continuous profile"] = (fa.LAUNCHES["flash_attention"],
                                 eng.host_syncs["prompt_uploads"])
    if not steady(eng.sched) or len(eng.sched.active()) != run["max_batch"]:
        raise AssertionError("the profiled decode step is not eight slots "
                             "in steady state")
    _sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"  [continuous decode] one eight-slot gated step in steady state "
          "under sync_debug_mode=error: no host sync")
    profile_calls(eng.step, 4, "continuous decode", "decode steps", "step")
    return out


def count_drops(cfg):
    """Start counting an MoE config's dropped (token, slot) assignments
    from zero (a device tensor; nothing is read inside a step)."""
    from repro_torch.models import moe
    moe.count_drops(bool(cfg.n_experts))


def drops(cfg) -> str:
    """The share of the assignments since ``count_drops`` that capacity
    dropped (one host read, after the run), as printed; counting
    stops."""
    from repro_torch.models import moe
    if not cfg.n_experts:
        return ""
    share, n = moe.drop_share(), moe.DROPS["assigned"]
    moe.count_drops(False)
    return f" dropped_assignments={share:.6f} of {n}"


def peak_memory(tag):
    """Print the card's peak allocated memory since the last reset, and
    reset it."""
    import torch
    print(f"{tag} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({SMI})")
    torch.cuda.reset_peak_memory_stats()


def run_serving(cfg, runs, device="cuda"):
    """``cfg`` at full width, all layers, bf16: the session CLI, the FIFO
    engine in each mode of ``runs["engines"]`` and the continuous runs
    of ``runs["continuous"]``, each followed by its peak device memory
    (and, for an MoE config, its share of dropped assignments); then,
    where ``runs["profile"]``, a profiled prefill and decode step (taken
    before the session, and the params freed, where no engine runs:
    jamba's 52 GB do not fit twice).  The engines' own params are built
    only where a run beside the session needs them (the session CLI
    builds its own).  Returns per run its flash launches and prefill
    calls."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    from repro_torch.serve import ServeEngine
    from repro_torch.weights import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    own = runs["engines"] or runs["continuous"] or runs["profile"]
    if own:
        params = init_serve_params(cfg, 0, device=device)
        peak_memory(f"  [{cfg.name} init] {len(tree_leaves(params))} "
                    f"leaves, {sum(t.numel() for t in tree_leaves(params))}"
                    " params:")
        masks = tserve.random_masks(cfg, runs["n_clients"], device=device)
        warm = torch.ones((2, 64), dtype=torch.int32, device=device)
        tserve.serve_session(cfg, params, warm, 2, device=device,
                             extras=mm_extras(cfg, 2, 64, 1, torch.bfloat16,
                                              device, 0))  # warm-up
    out = {}
    s = runs["session"]
    if runs["profile"] and not (runs["engines"] or runs["continuous"]):
        profile_session(cfg, params, s, device)
        del params, masks
        torch.cuda.empty_cache()
        peak_memory(f"  [{cfg.name} profile] (its params freed after)")
        runs, own = dict(runs, profile=False), False
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    count_drops(cfg)
    with timed(dec, "prefill") as pre, timed(tserve, "serve_session") as ses:
        toks = tserve.main(session_argv(cfg, runs) + ["--device", device])
    if toks.shape != (s["batch"], s["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"session tokens {toks.shape} out of range")
    dec_ms = (ses[0] - pre[0]) / (s["gen"] - 1) * 1e3
    print(f"  [{cfg.name} session] B={s['batch']} prompt={s['prompt_len']} "
          f"gen={s['gen']}: tokens/s={s['batch'] * s['gen'] / ses[0]} "
          f"prefill_ms={pre[0] * 1e3} decode_ms_per_token={dec_ms} "
          f"session_s={ses[0]} flash_launches="
          f"{fa.LAUNCHES['flash_attention']} prefills={len(pre)}"
          f"{drops(cfg)} ({SMI})")
    peak_memory(f"  [{cfg.name} session] (its own params, init and fold "
                "included" + (", beside the engines')" if own else ")"))
    out["session"] = (fa.LAUNCHES["flash_attention"], len(pre))
    tokens = {}
    for mode, kw in runs["engines"].items():
        eng = ServeEngine(cfg, params, masks, device=device, **kw)
        reqs = make_requests(runs["requests"], cfg.vocab_size)
        for r in reqs:
            eng.submit(r)
        fa.reset_launches()
        count_drops(cfg)
        with timed(dec, "prefill") as pre:
            _sync()
            t0 = time.perf_counter()
            done = eng.run_until_idle()
            _sync()
            wall = time.perf_counter() - t0
        st = eng.stats
        if sorted(r.req_id for r in done) != list(range(len(reqs))) or any(
                r.output.shape != (r.max_new_tokens,)
                or not ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
                for r in done):
            raise AssertionError(f"[{mode}] a request did not complete "
                                 "with in-vocab tokens")
        tokens[mode] = {r.req_id: r.output for r in done}
        lat = np.array([r.latency_s for r in done])
        print(f"  [{cfg.name} engine {mode}] {len(done)} requests in "
              f"{wall} s: "
              f"tokens/s={st.tokens / wall} completed/s={st.completed / wall}"
              f" prefill_ms={[round(x * 1e3, 3) for x in pre]} "
              f"decode_ms_per_step={(wall - sum(pre)) / st.decode_steps * 1e3}"
              f" latency_s p50={np.median(lat)} max={lat.max()} "
              f"occupancy={st.occupancy} flash_launches="
              f"{fa.LAUNCHES['flash_attention']}{drops(cfg)} ({SMI})")
        print(f"  [{cfg.name} engine {mode}] EngineStats "
              + json.dumps(dataclasses.asdict(st)))
        peak_memory(f"  [{cfg.name} engine {mode}]")
        out[mode] = (fa.LAUNCHES["flash_attention"], st.batches)
    if len(tokens) == 2:
        a, b = tokens["mixed"], tokens["per_client"]
        agree = np.mean([np.mean(a[i] == b[i]) for i in a])
        print(f"  gated (mixed) vs folded (per-client) batches: {agree:.4f} "
              "of tokens equal (bf16 GEMMs of other batch shapes may tip a "
              "near-tie; equality is held in f32 by "
              "tests/test_torch_serve.py)")
    if runs["continuous"]:
        out.update(run_continuous(cfg, params, masks, runs, tokens["mixed"],
                                  device))
    if not runs["profile"]:
        return out

    profile_session(cfg, params, s, device)
    return out


def profile_session(cfg, params, s, device, extras=None):
    """Where the time goes: the session's prefill (with ``extras``, and an
    encoder-decoder's bf16 source frames) and its decode steps,
    profiled."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    S = s["prompt_len"]
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (s["batch"], S)).astype(np.int32)).to(device)
    if cfg.is_encoder_decoder:
        extras = mm_extras(cfg, s["batch"], S, 1, torch.bfloat16, device, 3)
    held = {}

    def prefill():
        held["out"] = dec.prefill(cfg, params, prompts, extras,
                                  cache_len=S + s["gen"] + 1)
    profile_calls(prefill, 2, f"{cfg.name} session prefill", "prefills",
                  "prefill")
    lg, cache = held.pop("out")
    tok = lg.argmax(-1).to(torch.int32)
    profile_calls(lambda: dec.decode_step(cfg, params, tok, cache, S), 4,
                  f"{cfg.name} session decode", "decode steps", "step")


def serve_archs(archs):
    """``run_serving`` for each (config, runs) of ``archs`` in turn, each
    run's flash launches held to one an attention layer per prefill
    (``attn_layers``); each arch's
    params, caches and engines freed (and the cache emptied) before the
    next is built.  Returns the flash launches of all runs."""
    import torch
    total = 0
    for arch, (cfg, runs) in archs.items():
        served = run_serving(cfg, runs)
        per = attn_layers(cfg)
        for run, (n, prefills) in served.items():
            if n != per * prefills:
                raise AssertionError(f"[{arch} {run}] {n} flash launches for"
                                     f" {prefills} prefills of {per} "
                                     "attention layers")
            print(f"  [{arch} {run}] flash launches {n} = {per} "
                  f"per prefill x {prefills} prefills")
        total += sum(n for n, _ in served.values())
        del served
        torch.cuda.empty_cache()
    return total


def serving_bytes(cfg):
    """Reckoned bf16 bytes of a session before allocating: the weights
    (the LM head apart from the embedding, padded vocab) and the copies
    ``fold_unit_masks`` makes of the server's gated projections (``wo``,
    ``out_proj``, ``w_down``; an MoE layer's every expert's)."""
    from repro_torch.models.transformer import server_plan
    d = cfg.d_model
    weights = cfg.param_count() + 2 * cfg.padded_vocab() * d \
        - cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    fold = 0
    for seg in server_plan(cfg):
        for desc in seg.body:
            fold += seg.n_rep * d * (
                cfg.n_heads * cfg.head_dim if desc.mixer == "attn"
                else cfg.d_inner)
            fold += seg.n_rep * d * {"dense": cfg.d_ff, "none": 0,
                                     "moe": cfg.n_experts * cfg.moe_d_ff
                                     }[desc.ffn]
    return 2 * weights, 2 * fold


def fifo_sub_batches(cfg, runs):
    """The mixed FIFO engine's prefills on an SSM stack: each batch of
    ``runs``'s requests split into equal-length sub-batches, in the order
    of their first request; per sub-batch (rows, L, the SSD chunk, the
    chunks, the carry's blocks a layer)."""
    from repro_torch.models.ssm import CARRY_BLOCK, chunk_size
    out = []
    for _, rows, L, _ in fifo_shapes(runs["requests"], "mixed", True,
                                     **runs["engines"]["mixed"]):
        chunk = chunk_size(cfg, L)
        nc = L // chunk
        out.append((rows, L, chunk, nc, -(-nc // CARRY_BLOCK)
                    if nc > 1 else 0))
    return out


def ssm_serving_phase():
    """Phase 7d: mamba2-370m and jamba-v0.1-52b (16 layers) served in
    bf16, each run's reckoned bytes printed before it allocates and its
    peak after; returns the flash launches of all runs."""
    import torch
    from repro_torch.serve import ContinuousEngine
    total = 0
    for arch in SSM_ARCHS:
        cfg, runs = ssm_cfg(arch), ssm_runs(arch)
        weights, fold = serving_bytes(cfg)
        print(f"  [{arch}] {cfg.n_layers} layers (split after "
              f"{cfg.split_layer}), {attn_layers(cfg)} attention: reckoned "
              f"before allocating {weights / 1e9:.2f} GB of bf16 weights, "
              f"+{fold / 1e9:.2f} GB folded server projections ({SMI})")
        if runs["engines"]:
            subs = fifo_sub_batches(cfg, runs)
            print(f"  [{arch}] the FIFO trace's {len(runs['requests'])} "
                  f"requests in {len(subs)} equal-length sub-batches "
                  "(rows, L, chunk, chunks, carry blocks a layer): "
                  f"{subs}")
            try:
                ContinuousEngine(cfg, None, device="cuda")
            except ValueError as e:
                print(f"  [{arch}] ContinuousEngine refuses: {e}")
            else:
                raise AssertionError(f"ContinuousEngine took {arch}")
        total += serve_archs({arch: (cfg, runs)})
    return total


def vlm_cfg():
    """Phase 7e's qwen2-vl-72b: published widths, ``VLM_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)


def vlm_runs():
    """Phase 7e's qwen2-vl runs: the session (B=8, 1,280-token prompts, 32
    new tokens, client 0's mask folded) and the continuous engine on
    ``VLM_TRACE`` (8 slots, cache 576)."""
    runs = serving_runs()
    runs.update(session=dict(runs["session"], prompt_len=1280), engines={},
                profile=False, continuous={"short": {
                    "requests": VLM_TRACE, "seed": 6, "chunks": [3, 1, 2],
                    "max_batch": 8, "cache_len": 576}})
    return runs


def encdec_runs():
    """Phase 7e's seamless runs: the session (B=8, 1,024 source frames a
    row, 32 new tokens) and the mixed FIFO engine on phase 7's 16
    requests, its prefill and decode profiled."""
    runs = serving_runs()
    runs.update(session=dict(runs["session"], prompt_len=1024),
                engines={"mixed": runs["engines"]["mixed"]}, continuous={})
    return runs


def mm_flash_cases():
    """Phase 5's cases of phase 7e and of phase 6's multimodal configs:
    qwen2-vl's session and vision prefill (one shape: B=8, S=1,280, GQA
    64/8 at hd 128, causal) and its continuous admissions in bf16, and
    its 2-layer f32 shape; seamless's encoder (16/16 at hd 64,
    non-causal) and decoder BOS prefill (S=1) at its session's shape
    (B=8, S=1,024) and at each equal-length sub-batch of its mixed FIFO
    in bf16, and both at phase 6's f32 shape."""
    from repro_torch.configs.base import get_config
    return (flash_cases(vlm_cfg(), vlm_runs(), [two_device_shape()],
                        VLM_ARCH + " ")
            + flash_cases(get_config(ENCDEC_ARCH), encdec_runs(),
                          [two_device_shape()], ENCDEC_ARCH + " "))


def mm_on_two_devices():
    """Phase 6's multimodal part: qwen2-vl-72b at 2 layers and
    seamless-m4t-large-v2 at 2 + 2, card against CPU in strict fp32."""
    import dataclasses
    from repro_torch.configs.base import get_config
    two = LM_TWO_DEVICE["n_layers"]
    lm_on_two_devices(VLM_ARCH)
    lm_on_two_devices(ENCDEC_ARCH, dataclasses.replace(
        get_config(ENCDEC_ARCH), n_layers=two, n_encoder_layers=two,
        dtype="float32"))


def vision_prefill(cfg, params, s, device="cuda"):
    """The session's shape with ``VLM_GRID**2`` patch embeddings spliced
    over the prefix at distinct (t, h, w) streams: one prefill and
    ``gen - 1`` greedy decode steps (from position S, one stream value
    on all three), synchronised and timed; its logits must be finite and
    differ from a text-only prefill of the same prompts (the splice and
    the streams reach the model), its tokens in the vocabulary.  Then
    the prefill and a decode step profiled.  Returns the flash launches
    of its prefill."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode as dec
    B, S, gen = s["batch"], s["prompt_len"], s["gen"]
    g = torch.Generator(device=device).manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device=device, dtype=torch.int32)
    ex = mm_extras(cfg, B, S, VLM_GRID, torch.bfloat16, device, 8)
    fa.reset_launches()
    _sync()
    t0 = time.perf_counter()
    lg, cache = dec.prefill(cfg, params, prompts, ex, cache_len=S + gen + 1)
    _sync()
    t1 = time.perf_counter()
    launches = fa.LAUNCHES["flash_attention"]
    tok = lg.argmax(-1).to(torch.int32)
    outs, finite = [tok], bool(torch.isfinite(lg).all())
    for t in range(gen - 1):
        lg, cache = dec.decode_step(cfg, params, tok, cache, S + t)
        tok = lg.argmax(-1).to(torch.int32)
        outs.append(tok)
    _sync()
    t2 = time.perf_counter()
    finite &= bool(torch.isfinite(lg).all())
    out = torch.cat(outs, dim=1)
    text, _ = dec.prefill(cfg, params, prompts, cache_len=S + 1)
    moved = float((text - dec.prefill(cfg, params, prompts, ex,
                                      cache_len=S + 1)[0]).abs().max())
    print(f"  [{cfg.name} vision prefill] B={B} S={S} with "
          f"{VLM_GRID ** 2} patches spliced, distinct (t, h, w) streams, "
          f"then {gen - 1} decode steps: prefill_ms={(t1 - t0) * 1e3} "
          f"decode_ms_per_token={(t2 - t1) / (gen - 1) * 1e3} "
          f"tokens/s={B * gen / (t2 - t0)} flash_launches={launches}; "
          f"logits finite {finite}, max change from a text-only prefill "
          f"{moved:.3e} ({SMI})")
    if out.shape != (B, gen) or not finite or not moved > 0 or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"[{cfg.name} vision prefill] tokens "
                             f"{tuple(out.shape)}, finite {finite}, the "
                             f"patches moved the logits by {moved}")
    del cache, text
    profile_session(cfg, params, s, device, ex)
    return launches


def vlm_serving_phase():
    """Phase 7e's qwen2-vl-72b part: the session CLI alone (its own
    params, freed after), then one serving init for the vision prefill
    and the continuous engine; each run's flash launches held to one an
    attention layer per prefill.  Returns the flash launches."""
    import torch
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.steps import init_serve_params
    cfg, runs = vlm_cfg(), vlm_runs()
    weights, fold = serving_bytes(cfg)
    print(f"  [{VLM_ARCH}] {cfg.n_layers} of 80 layers (split after "
          f"{cfg.split_layer}): reckoned before allocating "
          f"{weights / 1e9:.2f} GB of bf16 weights, +{fold / 1e9:.2f} GB "
          f"folded server projections ({SMI})")
    total = serve_archs({VLM_ARCH: (cfg, dict(runs, continuous={}))})
    params = init_serve_params(cfg, 0, device="cuda")
    peak_memory(f"  [{VLM_ARCH} init]")
    per = attn_layers(cfg)
    n = vision_prefill(cfg, params, runs["session"])
    masks = tserve.random_masks(cfg, runs["n_clients"], device="cuda")
    served = run_continuous(cfg, params, masks, runs, None)
    for run, (k, prefills) in dict(served, vision=(n, 1)).items():
        if k != per * prefills:
            raise AssertionError(f"[{VLM_ARCH} {run}] {k} flash launches "
                                 f"for {prefills} prefills of {per} layers")
        print(f"  [{VLM_ARCH} {run}] flash launches {k} = {per} per "
              f"prefill x {prefills} prefills")
        total += k
    del params, masks
    torch.cuda.empty_cache()
    return total


def encdec_serving_phase():
    """Phase 7e's seamless-m4t-large-v2 part: its continuous refusal, then
    the session and the mixed FIFO engine (``run_serving``), each
    prefill's flash launches held to its encoder's and decoder's
    self-attention layers (48).  Returns the flash launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.serve import ContinuousEngine
    cfg, runs = get_config(ENCDEC_ARCH), encdec_runs()
    weights, fold = serving_bytes(cfg)
    print(f"  [{ENCDEC_ARCH}] {cfg.n_encoder_layers} encoder (split after "
          f"{cfg.split_layer}) + {cfg.n_layers} decoder layers: reckoned "
          f"before allocating {weights / 1e9:.2f} GB of bf16 weights, "
          f"+{fold / 1e9:.2f} GB folded decoder projections ({SMI}); the "
          f"FIFO trace's {len(runs['requests'])} requests in "
          f"{len({n for _, n, _ in runs['requests']})} prompt lengths")
    try:
        ContinuousEngine(cfg, None, device="cuda")
    except ValueError as e:
        print(f"  [{ENCDEC_ARCH}] ContinuousEngine refuses: {e}")
    else:
        raise AssertionError(f"ContinuousEngine took {ENCDEC_ARCH}")
    return serve_archs({ENCDEC_ARCH: (cfg, runs)})


# phase 8d: seamless-m4t-large-v2 trained as phase 8b runs it (C=4, B=16,
# S=128 source frames and tokens, 20 steps in windows of 10, both
# drivers), cut to ENCDEC_TRAIN_LAYERS encoder and as many decoder
# layers: reckoned ~1.46 B elements (~47 GB at 32 B an element); all
# 24 + 24, ~2.4 B (~79 GB), do not fit one card at C=4
ENCDEC_TRAIN_LAYERS = 12


def encdec_trainer_phase(gen):
    """Phase 8d; returns the launches of its runs."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              n_layers=ENCDEC_TRAIN_LAYERS,
                              n_encoder_layers=ENCDEC_TRAIN_LAYERS)
    n = train_elements(cfg, LM_TRAIN["cohorts"])
    gib = n * TRAIN_BYTES_PER_ELEMENT / 2**30
    print(f"  [{ENCDEC_ARCH}] {cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers, reckoned before allocating: {n / 1e9:.3f} B trainable "
          f"elements x {TRAIN_BYTES_PER_ELEMENT} B = {gib:.2f} GiB at "
          f"C={LM_TRAIN['cohorts']} ({SMI})")
    if gib > TRAIN_FIT_GIB:
        raise AssertionError(f"[{ENCDEC_ARCH}] reckoned {gib:.2f} GiB > "
                             f"{TRAIN_FIT_GIB}")
    return lm_trainer_phase(gen, cfg, phase_8b=False)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's smoke run needs a card")
    t_run = time.perf_counter()
    clock = {"t": t_run}

    def phase_done(n):
        now = time.perf_counter()
        print(f"phase {n} wall: {now - clock['t']:.2f} s")
        clock["t"] = now

    # phase 1 ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    global SMI
    SMI = smi
    from repro_torch.kernels import _build
    from repro_torch.weights import strict_fp32
    strict_fp32()
    built = _build.build_all()
    print(f"build: {built['seconds']:.2f} s (nvcc, all {len(_build.EXTRA)} "
          "sources in parallel)")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    phase_done(1)

    # phase 2 ---------------------------------------------------------
    from repro_torch.configs.base import get_config
    cfg = get_config("lenet-cifar")
    runs = trainer_runs()
    print("phase 2: kernels against their plain versions, at phase 4's "
          "shapes")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm = check_gemm(cfg, runs["main"], gen)
    fused = check_gemm(cfg, runs["fused_epilogue+per_scalar"], gen)
    adam = {label: check_adam(cfg, runs[label], gen, label)
            for label in ("main", "fused_epilogue+per_scalar")}
    client_adam = check_client_adam(cfg, runs["main"], gen)
    ntxent = check_ntxent(cfg, runs["main"], gen)
    soft = check_soft_threshold(cfg, runs["main"], gen)
    checked = {(hp.fused_epilogue,) + tuple(shape[1:5])
               for hp in (runs["main"], runs["fused_epilogue+per_scalar"])
               for shape in gemm_shapes(cfg, hp)}
    check_slice_kernels(cfg, runs, gen, checked)
    check_more_shapes(cfg, runs, gen, checked)
    check_shard_shapes(cfg, gen, checked)
    phase_done(2)

    # phase 3 ---------------------------------------------------------
    print("phase 3: one iteration and one round on the card and on the CPU")
    iteration_on_two_devices(cfg, runs["main"])
    round_on_two_devices(cfg, runs["main"])
    phase_done(3)

    # phase 4 ---------------------------------------------------------
    from repro_torch.data.synthetic import mixed_noniid
    print(f"phase 4: AdaSplitTrainer on lenet-cifar, C={N_CLIENTS}")
    clients = mixed_noniid(N_CLIENTS, n_per_client=128, n_test=64)
    results = {label: run_trainer(cfg, hp, clients, label)
               for label, hp in runs.items()}
    compare_rungs(results, cfg, clients)
    time_rungs(results, clients)
    check_syncs(results, clients)
    check_stream_syncs(results, clients)
    check_loop_reads(results["loop"][1], clients)
    api = kernel_api(cfg, results["main"][1], clients, runs["main"])
    counts = {label: r[0] for label, r in results.items()}
    launches = {"panel_gemm": counts["main"]["panel_gemm"],
                "panel_gemm_bias_relu":
                    counts["fused_epilogue+per_scalar"]["panel_gemm_bias_relu"],
                "masked_adam": counts["main"]["masked_adam"],
                "client_adam": counts["main"]["client_adam"],
                "ntxent_stats": counts["main"]["ntxent_stats"],
                "ntxent_backward": counts["main"]["ntxent_backward"],
                "soft_threshold": api["soft_threshold"]}
    main_snapshot = results["main"][2]
    del results
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    phase_done(4)

    # phase 4b --------------------------------------------------------
    print(f"phase 4b: a population of {POPULATION['clients']} clients at "
          "full width, resident and streamed, two rounds each")
    population(cfg)
    torch.cuda.empty_cache()
    phase_done("4b")

    # phase 4c --------------------------------------------------------
    print(f"phase 4c: cohort-sharded AdaSplitTrainer on lenet-cifar, "
          f"C={N_CLIENTS} over {SHARD_WORLD} ranks (gloo) on the one card, "
          "round and epoch rungs, against phase 4's main run")
    sharded = shard_phase(cfg, main_snapshot)
    for k in ("panel_gemm", "masked_adam", "client_adam", "ntxent_stats",
              "ntxent_backward"):
        launches[k] += sharded[k]
    del main_snapshot
    phase_done("4c")

    # phase 5 ---------------------------------------------------------
    lm = get_config(SERVE_ARCH)
    serving = serving_runs()
    dense = {arch: (get_config(arch), arch_runs(arch))
             for arch in DENSE_ARCHS}
    moe = {arch: (get_config(arch), arch_runs(arch)) for arch in MOE_ARCHS}
    jamba = SSM_ARCHS[1]
    print(f"phase 5: flash attention against its plain version, at "
          f"phase 7's prefill shapes ({SERVE_ARCH}, hd 64; the continuous "
          f"runs' B=1 admissions too), phase 7b's ({', '.join(DENSE_ARCHS)};"
          f" hd 128 and 96), phase 7c's ({', '.join(MOE_ARCHS)}; hd 128, "
          f"16/16 and 32/4), phase 7d's ({jamba} at {JAMBA_LAYERS} layers; "
          "hd 128, 32/8) and phase 6's f32 ones")
    cases = flash_cases(lm, serving, fp32_prefill_shapes()
                        + [two_device_shape()])
    for arch, (cfg_d, runs_d) in {**dense, **moe}.items():
        cases += flash_cases(cfg_d, runs_d, [two_device_shape()]
                             if arch in TWO_DEVICE_ARCHS else [], arch + " ")
    cases += ssm_flash_cases() + mm_flash_cases()
    flash = check_flash(cases, gen)
    phase_done(5)

    # phase 6 ---------------------------------------------------------
    print(f"phase 6: {', '.join(TWO_DEVICE_ARCHS)} prefill and decode on "
          "the card and on the CPU (full width, 2 layers, strict fp32), "
          f"{jamba} reduced (m a m a), {VLM_ARCH} (16 patches at distinct "
          f"M-RoPE streams) and {ENCDEC_ARCH} (2 + 2 layers, cross-attention"
          " in prefill and decode) likewise, one train step of the "
          "reduced deepseek-moe-16b and mamba2-370m likewise, and the "
          "continuous, solo and mixed FIFO engines on the card "
          f"({SERVE_ARCH})")
    for arch in TWO_DEVICE_ARCHS:
        lm_on_two_devices(arch)
    lm_on_two_devices(jamba, jamba_reduced())
    mm_on_two_devices()
    for arch in ("deepseek-moe-16b", "mamba2-370m"):
        train_step_on_two_devices(arch)
    engines_agree_fp32()
    phase_done(6)

    # phase 7 ---------------------------------------------------------
    print(f"phase 7: serving {SERVE_ARCH} at full width, all "
          f"{lm.n_layers} layers, bf16: the session CLI, ServeEngine "
          "in both batching modes and ContinuousEngine on two traces")
    served = run_serving(lm, serving)
    for run, (n, prefills) in served.items():
        if n != lm.n_layers * prefills:
            return fail(f"[{run}] {n} flash launches for {prefills} "
                        f"prefills of {lm.n_layers} layers")
        print(f"  [{run}] flash launches {n} = {lm.n_layers} per prefill "
              f"x {prefills} prefills")
    launches["flash_attention"] = sum(n for n, _ in served.values())
    phase_done(7)

    # phase 7b --------------------------------------------------------
    print(f"phase 7b: serving at full width, all layers, bf16: "
          f"{ALL_PATHS_ARCHS[0]} (hd 128) through the session CLI, the "
          "mixed FIFO engine and ContinuousEngine; the others through the "
          "session CLI")
    launches["flash_attention"] += serve_archs(dense)
    phase_done("7b")

    # phase 7c --------------------------------------------------------
    print(f"phase 7c: MoE serving at full width, all layers, bf16: "
          f"{ALL_PATHS_ARCHS[1]} (28 layers, 64 experts top-6) through the "
          f"session CLI, the mixed FIFO engine and ContinuousEngine; "
          f"{MOE_ARCHS[1]} (48 layers, 128 experts top-8, GQA 32/4) through "
          "the session CLI")
    launches["flash_attention"] += serve_archs(moe)
    phase_done("7c")

    # phase 7d --------------------------------------------------------
    print(f"phase 7d: SSM and hybrid serving, bf16: {SSM_ARCHS[0]} (48 "
          "layers) through the session CLI and the mixed FIFO engine "
          "(equal-length sub-batches), its ContinuousEngine refusal; "
          f"{jamba} at published widths, {JAMBA_LAYERS} layers, through the "
          "session CLI")
    launches["flash_attention"] += ssm_serving_phase()
    phase_done("7d")

    # phase 7e --------------------------------------------------------
    print(f"phase 7e: vision-text and encoder-decoder serving, bf16: "
          f"{VLM_ARCH} at published widths, {VLM_LAYERS} of 80 layers, "
          "through the session CLI, a vision prefill (1,024 patches at "
          "distinct M-RoPE streams) with 31 decode steps, and "
          f"ContinuousEngine; {ENCDEC_ARCH} at full width and depth (24 + "
          "24 layers) through the session CLI and the mixed FIFO engine "
          "(equal-length sub-batches), its ContinuousEngine refusal")
    launches["flash_attention"] += vlm_serving_phase()
    launches["flash_attention"] += encdec_serving_phase()
    phase_done("7e")

    # phase 8 ---------------------------------------------------------
    print(f"phase 8: Table 1 (Mixed-NonIID) at lenet-cifar's published "
          f"widths, C={N_CLIENTS}: the six baselines and two AdaSplit "
          "variants through launch/compare.py; each baseline one round on "
          "the card and on the CPU")
    compare_methods(cfg)
    baselines_on_two_devices(cfg)
    phase_done(8)

    # phase 8b --------------------------------------------------------
    print(f"phase 8b: the AdaSplit LM trainer on {SERVE_ARCH} at full "
          "width, both drivers, and card vs CPU at 2 layers")
    lm_launches = lm_trainer_phase(gen, lm)
    for k in ("ntxent_stats", "ntxent_backward", "client_adam"):
        launches[k] += lm_launches[k]
    phase_done("8b")

    # phase 8c --------------------------------------------------------
    print("phase 8c: MoE and SSM training as phase 8b: mamba2-370m at full "
          "width, 24 layers, deepseek-moe-16b at published widths, 2 layers")
    lm_launches = moe_ssm_trainer_phase(gen)
    for k in ("ntxent_stats", "ntxent_backward", "client_adam"):
        launches[k] += lm_launches[k]
    phase_done("8c")

    # phase 8d --------------------------------------------------------
    print(f"phase 8d: encoder-decoder training as phase 8b: {ENCDEC_ARCH} "
          f"at published widths, {ENCDEC_TRAIN_LAYERS} + "
          f"{ENCDEC_TRAIN_LAYERS} layers")
    lm_launches = encdec_trainer_phase(gen)
    for k in ("ntxent_stats", "ntxent_backward", "client_adam"):
        launches[k] += lm_launches[k]
    phase_done("8d")

    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        return fail(f"kernels never launched on the path: {zero}")

    # phase 9 ---------------------------------------------------------
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for name, tot, source, replaces in (
            ("panel_gemm", gemm, src + "panel_gemm.cu",
             "src/repro/kernels/client_conv.py:112"),
            ("panel_gemm_bias_relu", fused, src + "panel_gemm.cu",
             "src/repro/kernels/client_conv.py:185"),
            ("masked_adam", adam["main"], src + "masked_adam.cu",
             "src/repro/kernels/masked_adam.py:36"),
            ("client_adam", client_adam, src + "masked_adam.cu",
             "src/repro/optim/adam.py:25"),
            ("ntxent_stats", ntxent["ntxent_stats"], src + "ntxent.cu",
             "src/repro/kernels/ntxent.py:60"),
            ("ntxent_backward", ntxent["ntxent_backward"], src + "ntxent.cu",
             "src/repro/core/losses.py:13"),
            ("soft_threshold", soft, src + "soft_threshold.cu",
             "src/repro/kernels/soft_threshold.py:23"),
            ("flash_attention", flash, src + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:74")):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"],
                     "bound_by": tot.get("bound_by") or bound(
                         tot["bytes"], tot["flops"])[1],
                     "library_ms": tot["library_ms"]})
    print(f"profiler sessions: {json.dumps(MARKERS_LOST)} (lossy: those "
          "that lost leading device records; most: the most lost in one)")
    print(f"total wall: {time.perf_counter() - t_run:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
