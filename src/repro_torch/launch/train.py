"""Runnable AdaSplit LM trainer (port of ``repro.launch.train``).

Drives the train step of ``launch.steps`` with the synthetic
multi-domain LM pipeline (``data.tokens``), the UCB orchestrator inside
the step (``build_ucb_train_step``: cohort selection and bandit update
on the device), eq. 1-2 resource metering, and optional checkpointing.
Metrics stay on the device and are fetched in ONE device-to-host copy
every ``log_every`` steps (``_fetch``); each step's batch and jitter go
up from page-locked memory without blocking, so a step makes no other
host sync.  ``epoch_scan=True`` stages a whole window's batches at once
and runs its steps back to back (``_run_windowed``), with the same
histories.

Usage (one card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --steps 20 --batch 16 --seq 128

Conv archs run the paper-scale vision trainer (``run_vision``) on the
epoch rung, cohort-sharded over the job's ranks by default (``--shard``,
as in the reference: ``shard_clients=True``, C/world clients a rank;
``--no-shard`` keeps the whole cohort on each process).  Start the ranks
with ``torchrun`` (or the ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES``
/ ``REPRO_PROCESS_ID`` variables); alone, the run is a world of 1 and
unsharded.  ``--backend`` defaults to NCCL where each rank has a card of
its own and gloo where ranks share one or run on the CPU:
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch lenet-cifar --clients 16 --steps 4 --device cpu
An LM arch trains on one process: its sharded form (the state over a
(data, model) mesh) is still to be ported.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import InputShape, get_config
from repro_torch.core.accounting import (Meter, split_payload_bytes,
                                         transformer_flops_per_token)
from repro_torch.core.orchestrator import generator_jitter, ucb_init
from repro_torch.data.tokens import lm_batch_iterator, lm_client_dataset
from repro_torch.launch.steps import (LaunchPolicy, build_ucb_train_step,
                                      init_train_state, wrap_window)
from repro_torch.weights import device_of, tree_map


def make_batch(raw):
    """Host (CPU) tensors of one step's batch from a token draw (the
    reference also passes an all-ones ``select``, which the UCB step
    replaces; the port leaves it out)."""
    return {"tokens": torch.from_numpy(raw["tokens"]),
            "labels": torch.from_numpy(raw["targets"]),
            "seq_class": torch.from_numpy(raw["seq_labels"])}


def add_extras(cfg, batch, B, S, rng):
    """The modality inputs, drawn from ``rng`` exactly as the reference
    draws them (float64 normals rounded to bf16 through float32, as
    ``jnp.asarray`` rounds them): an encoder-decoder's ``src_embeds``
    (B, S, D), a vision-text arch's ``vision_embeds`` (B, F, D) and its
    ``positions`` (B, S, 3), ``arange(S)`` on all three streams.  Host
    (CPU) tensors, added to ``batch`` and returned; a text arch takes
    none."""
    def bf16_normal(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(torch.bfloat16)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = bf16_normal((B, S, cfg.d_model))
    if cfg.modality == "vision_text":
        batch["vision_embeds"] = bf16_normal(
            (B, max(cfg.frontend_frames, 1), cfg.d_model))
        batch["positions"] = torch.arange(S, dtype=torch.int32)[
            None, :, None].expand(B, S, 3).contiguous()
    return batch


def _as_rows(jitter):
    if torch.is_tensor(jitter):
        return jitter.to("cpu", torch.float32)
    return torch.tensor(np.asarray(jitter), dtype=torch.float32)


class LMAdaSplitTrainer:
    """AdaSplit over an LM arch: two phases and UCB cohort selection.

    ``n_cohorts`` (C) stands in for the reference's mesh, whose ``data``
    axis it is: one cohort of b = B / C rows per client dataset.  The
    UCB state rides beside the train state on the device and each
    global step selects, trains and updates the bandit there.  ``run``
    keeps each step's metrics as device tensors and fetches a whole
    window of them in one copy (``_fetch``, counted in ``n_fetches``).

    ``jitter(counter, C)``: the selection jitter of step ``counter``
    ((C,) uniform [0, 1) draws); by default a ``torch.Generator`` seeded
    from ``seed`` and the counter.  The reference draws with
    ``jax.random`` from ``fold_in(PRNGKey(seed), counter)``, which torch
    cannot reproduce, so parity tests inject those draws.

    ``state``: a train state to start from (``init_train_state``'s
    tree, e.g. the reference's through ``weights.train_state_from_numpy``
    or another trainer's), moved to ``device``; by default one is drawn
    from ``seed``."""

    def __init__(self, cfg, shape: InputShape, policy: LaunchPolicy, *,
                 n_cohorts=1, kappa=0.6, eta=0.6, gamma=0.87, seed=0,
                 epoch_scan=False, device="cuda", jitter=None, state=None):
        self.cfg, self.shape, self.policy = cfg, shape, policy
        self.kappa, self.eta, self.gamma = kappa, eta, gamma
        self.epoch_scan = epoch_scan
        self.device = device_of(device)
        self.C = n_cohorts
        step_fn, self.k = build_ucb_train_step(cfg, shape, policy,
                                               n_cohorts=n_cohorts, eta=eta,
                                               gamma=gamma)
        self._step_fn = step_fn
        self._window_fn = wrap_window(step_fn)
        self.state = init_train_state(cfg, self.C, policy, seed,
                                      device=self.device) \
            if state is None else tree_map(lambda t: t.to(self.device), state)
        self.ucb = ucb_init(self.C, gamma=gamma, device=self.device)
        self.jitter = jitter if jitter is not None else generator_jitter(seed)
        self._step = 0          # persistent: run() never replays jitter
        self.meter = Meter()
        self.datasets = [lm_client_dataset(i, cfg.vocab_size,
                                           shape.seq_len, seed=seed)
                         for i in range(self.C)]
        self._rng = np.random.default_rng(seed)
        self.history = []
        self.n_fetches = 0

    # -- host <-> device ------------------------------------------------
    def _jitter_rows(self, counter: int, n: int) -> torch.Tensor:
        """(n, C) float32 CPU draws of steps counter .. counter + n - 1."""
        return torch.stack([_as_rows(self.jitter(counter + i, self.C))
                            for i in range(n)])

    def _upload(self, tensors):
        """Host tensors -> the device, each copied from page-locked memory
        without blocking (a pageable copy would wait for the device)."""
        if self.device.type != "cuda":
            return list(tensors)
        return [t.pin_memory().to(self.device, non_blocking=True)
                for t in tensors]

    def _fetch(self, tensors):
        """The one device->host copy of a window: ``tensors`` as one
        float32 transfer (cohort ids < 2**24 are exact).  Returns numpy
        arrays of the tensors' shapes."""
        self.n_fetches += 1
        host = torch.cat([t.reshape(-1).to(torch.float32)
                          for t in tensors]).cpu().numpy()
        out, i = [], 0
        for t in tensors:
            out.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        return out

    def _record(self, t, global_phase, m_lc, m_ce, m_aux, m_sel, summary):
        self.history.append({
            "step": t, "phase": "global" if global_phase else "local",
            "l_client": float(m_lc), "ce": float(m_ce), "aux": float(m_aux),
            "selected": [int(c) for c in np.flatnonzero(m_sel)],
            **summary})

    def _drain(self, pending):
        """ONE host sync for a whole window of step metrics."""
        keys = ("l_client", "ce", "aux", "select")
        n = len(keys)
        fetched = self._fetch([m[k] for _, _, _, m in pending for k in keys])
        for i, (t, g, summary, _) in enumerate(pending):
            self._record(t, g, *fetched[n * i:n * i + n], summary)
        pending.clear()

    # -- drivers ---------------------------------------------------------
    def run(self, total_steps: int, local_frac: float = None,
            log_every: int = 10):
        """Run ``total_steps`` more steps (two-phase within this call's
        window; the jitter schedule is persistent across calls)."""
        cfg, shape = self.cfg, self.shape
        local_steps = int(round((local_frac if local_frac is not None
                                 else self.kappa) * total_steps))
        b = shape.global_batch // self.C
        it = lm_batch_iterator(self.datasets, b)
        fl_c = transformer_flops_per_token(cfg, "client", shape.seq_len)
        fl_s = transformer_flops_per_token(cfg, "server", shape.seq_len)
        tokens_per_client = b * shape.seq_len
        # bf16 split activations + int32 labels, per selected cohort
        payload = split_payload_bytes((b, shape.seq_len, cfg.d_model), b,
                                      dtype_bytes=2)
        bill = (fl_c, fl_s, tokens_per_client, payload)
        if self.epoch_scan:
            return self._run_windowed(total_steps, local_steps, it,
                                      log_every, bill)

        pending = []
        for t in range(total_steps):
            batch = make_batch(next(it))
            batch = add_extras(cfg, batch, shape.global_batch,
                               shape.seq_len, self._rng)
            global_phase = t >= local_steps
            keys = list(batch)
            *vals, jitter = self._upload(
                [batch[k] for k in keys] + [self._jitter_rows(self._step,
                                                              1)[0]])
            self._step += 1
            self.state, self.ucb, metrics = self._step_fn(
                self.state, self.ucb, dict(zip(keys, vals)), jitter,
                global_phase)
            self._bill_step(global_phase, bill)
            pending.append((t, global_phase, self.meter.summary(), metrics))
            if (t + 1) % log_every == 0 or t == total_steps - 1:
                self._drain(pending)
        return self.history

    def _bill_step(self, global_phase, bill):
        """eq. 1-2 metering for one step (host side; k is static)."""
        fl_c, fl_s, tokens_per_client, payload = bill
        self.meter.add_client_flops(3 * fl_c * tokens_per_client * self.C)
        if global_phase:
            for _ in range(self.k):
                self.meter.add_payload(payload)
            self.meter.add_server_flops(
                3 * fl_s * tokens_per_client * self.k)

    def _run_windowed(self, total_steps, local_steps, it, log_every, bill):
        """The window driver: each ``log_every`` window's W batches and
        jitter rows are stacked on the host and go up in one staging,
        the W steps run back to back (``wrap_window``), and their
        metrics come back in one fetch.  Same steps, same jitter
        schedule and same histories as the per-step driver."""
        cfg, shape = self.cfg, self.shape
        done = 0
        while done < total_steps:
            W = min(log_every, total_steps - done)
            raws = [next(it) for _ in range(W)]
            steps = [add_extras(cfg, make_batch(raw), shape.global_batch,
                                shape.seq_len, self._rng) for raw in raws]
            host = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
            keys = list(host)
            *vals, jitters = self._upload(
                [host[k] for k in keys] + [self._jitter_rows(self._step, W)])
            gflags = [done + i >= local_steps for i in range(W)]
            self._step += W
            carry = {"state": self.state, "ucb": self.ucb}
            self.state = self.ucb = None
            metrics = self._window_fn(carry, dict(zip(keys, vals)), jitters,
                                      gflags)
            self.state, self.ucb = carry["state"], carry["ucb"]
            lc, ce, aux, sel = self._fetch(
                [metrics[k] for k in ("l_client", "ce", "aux", "select")])
            for i in range(W):
                self._bill_step(gflags[i], bill)
                self._record(done + i, gflags[i], lc[i], ce[i], aux[i],
                             sel[i], self.meter.summary())
            done += W
        return self.history


def run_vision(args):
    """Paper-scale vision AdaSplit on the epoch rung (``AdaSplitTrainer``
    with ``epoch_scan=True``), the stacked client axis sharded over the
    job's ranks (``shard_clients=True``, C/world clients a rank) unless
    ``--no-shard``; a world of 1 runs unsharded, as the reference's
    one-device mesh does.  Rank 0 prints."""
    from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
    from repro_torch.data.synthetic import mixed_noniid
    from repro_torch.launch.distributed import describe
    from repro_torch.launch.mesh import make_cohort_mesh

    cfg = get_config(args.arch)
    clients = mixed_noniid(n_clients=args.clients,
                           n_per_client=args.batch * 4, n_test=64, seed=0)
    hp = AdaSplitHParams(rounds=args.steps, kappa=args.kappa,
                         eta=args.eta, batch_size=args.batch,
                         epoch_scan=True, shard_clients=args.shard)
    mesh = make_cohort_mesh(device=args.device) if args.shard else None
    tr = AdaSplitTrainer(cfg, hp, clients,
                         device=mesh.device if mesh else args.device,
                         mesh=mesh)
    t0 = time.time()
    hist = tr.train(eval_every=max(args.steps // 2, 1))
    job = describe()
    if job["process_index"]:
        return
    for h in hist[:: max(1, len(hist) // 10)]:
        print(json.dumps(h))
    print(f"done {args.steps} rounds in {time.time()-t0:.1f}s on "
          f"{job['process_count']} rank(s) of {tr.device} "
          f"(sharded={tr._shard}, world={job['process_count']}, "
          f"backend={job['backend']}); "
          f"bandwidth={tr.meter.bandwidth_gb:.4f} GB "
          f"interconnect={tr.meter.interconnect_gb:.4f} GB "
          f"client={tr.meter.client_tflops:.3f} TFLOPs")


def _job_world() -> int:
    """Ranks the launcher started (``REPRO_NUM_PROCESSES``, else
    torchrun's ``WORLD_SIZE``; 1 alone)."""
    import os
    for name in ("REPRO_NUM_PROCESSES", "WORLD_SIZE"):
        if os.environ.get(name):
            return int(os.environ[name])
    return 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--kappa", type=float, default=0.5)
    ap.add_argument("--eta", type=float, default=0.6)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--clients", type=int, default=8,
                    help="vision cohort size (conv archs only)")
    ap.add_argument("--no-shard", dest="shard", action="store_false",
                    help="vision: keep the cohort on one device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the ranks' backend (default: nccl where each "
                    "rank has a card of its own, else gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    world = _job_world()
    if cfg.is_conv:
        from repro_torch.launch import distributed
        if args.shard and world > 1:
            distributed.initialize(backend=args.backend or
                                   distributed.choose_backend(args.device,
                                                              world))
        try:
            run_vision(args)
        finally:
            distributed.shutdown()
        return
    if world > 1:
        raise NotImplementedError(
            f"the LM trainer runs on one process ({world} were started): "
            "its sharded form, the train state over a (data, model) mesh, "
            "comes with ROADMAP queue 1 item 6 (the launch tooling)")
    if args.reduced:
        cfg = cfg.reduced()
    # one device: the reference's make_host_mesh() gives a data axis of 1
    C = 1
    shape = InputShape("cli_train", args.seq, args.batch, "train")
    policy = LaunchPolicy(microbatch=1, n_seq_classes=C)
    tr = LMAdaSplitTrainer(cfg, shape, policy, n_cohorts=C,
                           kappa=args.kappa, eta=args.eta,
                           device=args.device)
    t0 = time.time()
    hist = tr.run(args.steps, log_every=args.log_every)
    for h in hist[:: max(1, len(hist) // 10)]:
        print(json.dumps(h))
    print(f"done {args.steps} steps in {time.time()-t0:.1f}s; "
          f"bandwidth={tr.meter.bandwidth_gb:.4f} GB "
          f"client={tr.meter.client_tflops:.3f} TFLOPs")
    if args.checkpoint:
        from repro_torch.checkpoint.io import save_checkpoint
        save_checkpoint(args.checkpoint, tr.state["trainables"],
                        {"arch": args.arch, "steps": args.steps})
        print("checkpoint ->", args.checkpoint)


if __name__ == "__main__":
    main()
