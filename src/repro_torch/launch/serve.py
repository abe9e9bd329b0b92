"""Personalized serving session: prefill + batched greedy decode, with
the client's mask optionally folded into the server weights (port of
``repro.launch.serve``).

At inference the effective server model for client i is ``M^s * m_i``
(paper §3.3).  Gating per decode step would touch the masks at every
layer of every token, so ``--fold-mask`` folds the selected client's
binary mask into the server weights ONCE and then serves plain steps.

Usage (on the CUDA card by default; ``--device cpu`` runs the plain
kernel versions; ``--arch`` one of ``configs.base.list_archs()``:
deepseek-moe-16b, granite-3-8b, jamba-v0.1-52b, mamba2-370m, olmo-1b,
phi3-mini-3.8b, qwen2-0.5b, qwen2-vl-72b, qwen3-moe-30b-a3b,
seamless-m4t-large-v2; ``--fold-mask`` folds an MoE client's expert
masks into its experts' ``w_down`` and an SSM client's inner-channel
masks into its mixers' ``out_proj``; ``--n-layers`` cuts the depth, e.g.
jamba's 32 layers, ~103 GB in bf16, to 16 on one 80 GB card, or
qwen2-vl-72b's 80, ~144 GB, to 24; an SSM stack needs prompts of at
least ``ssm_conv_kernel - 1`` tokens; qwen2-vl-72b serves text prompts,
M-RoPE's three streams equal, as the reference's CLI does; for
seamless-m4t-large-v2 the CLI draws ``--prompt-len`` source frame
embeddings a row, N(0, 1) in bf16, after the prompts, as the
reference's does, and the prompt tokens set only the batch and the
decode start):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --prompt-len 512 --gen 32 --batch 8 --fold-mask
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.core import masks as masks_mod
from repro_torch.launch.steps import init_serve_params
from repro_torch.launch.train import add_extras
from repro_torch.models import decode as dec
from repro_torch.weights import tree_map


def serve_session(cfg, params, prompts, gen_steps: int, *, window=0,
                  extras=None, device="cuda"):
    """Prefill once, then batched greedy decode on ``device``, where the
    params live.  prompts: (B, S) ints (array or tensor); extras: the
    modality inputs ``models.decode.prefill`` takes (tensors, moved to
    ``device``).  Decode starts at position S, an encoder-decoder's too
    (its prefill cached only the BOS token), as in the reference.
    Returns the (B, gen_steps) int32 token matrix on ``device``."""
    prompts = torch.as_tensor(prompts).to(device)
    B, S = prompts.shape
    if extras is not None:
        extras = {k: v.to(device) for k, v in extras.items()}
    logits, cache = dec.prefill(cfg, params, prompts, extras, window=window,
                                cache_len=S + gen_steps + 1)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    outs = [tok]
    for t in range(gen_steps - 1):
        lg, cache = dec.decode_step(cfg, params, tok, cache, S + t,
                                    window=window)
        tok = lg.argmax(dim=-1).to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)


def random_masks(cfg, n_clients: int, seed: int = 1, device="cuda"):
    """Stand-ins for trained sparse per-unit masks: each unit kept with
    probability 1/2 (uniform > 0.5), drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(
        lambda m: (torch.rand(m.shape, generator=gen, device=m.device)
                   > 0.5).to(m.dtype),
        masks_mod.init_unit_masks(cfg, n_clients, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--client", type=int, default=0)
    ap.add_argument("--fold-mask", action="store_true")
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    params = init_serve_params(cfg, 0, device=args.device)

    if args.fold_mask:
        masks = random_masks(cfg, args.n_clients, device=args.device)
        params = dict(params)
        params["server"] = masks_mod.fold_unit_masks(
            cfg, params["server"], masks, args.client)
        sparsity = masks_mod.sparsity(
            masks_mod.gates_for_client(masks, args.client))
        print(f"folded client {args.client} mask "
              f"(sparsity={sparsity:.2f}) into server weights")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    # an encoder-decoder's source frames: the trainer's draw of them
    extras = add_extras(cfg, {}, args.batch, args.prompt_len, rng) \
        if cfg.is_encoder_decoder else None

    t0 = time.time()
    out = serve_session(cfg, params, prompts, args.gen, extras=extras,
                        device=args.device).cpu().numpy()
    dt = time.time() - t0
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
