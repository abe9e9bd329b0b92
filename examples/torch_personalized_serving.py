"""Personalized serving with the PyTorch port: the paper's inference
story (§3.3), where the effective server model for client i is
M^s * m_i (the torch counterpart of ``examples/personalized_serving.py``).
It trains nothing: it builds a server and two clients with distinct
sparse masks, folds each client's mask into the server weights once per
session (``--fold-mask``), and serves batched requests for both,
showing (a) that the fold equals per-step gating and (b) that the two
clients get different models.

  PYTHONPATH=src python examples/torch_personalized_serving.py \
      [--device cuda|cpu]

Runs on the CUDA card by default (every prefill on the flash kernel);
``--device cpu`` runs the plain versions on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import masks as masks_mod
from repro_torch.launch.serve import serve_session
from repro_torch.launch.steps import init_serve_params
from repro_torch.models import transformer as tfm
from repro_torch.weights import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("olmo-1b").reduced()
    params = init_serve_params(cfg, 0, device=device)
    n_clients = 2

    # distinct random binary masks per client (stand-in for trained m_i)
    masks = masks_mod.init_unit_masks(cfg, n_clients, device=device)
    gen = torch.Generator().manual_seed(42)
    masks = tree_map(lambda m: (torch.rand(tuple(m.shape), generator=gen)
                                > 0.35).to(m.dtype).to(device), masks)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(device)

    # --- (a) fold == gate equivalence on the first client ---
    with torch.no_grad():
        acts = tfm.client_forward(cfg, params["client"], prompts)
        gates = masks_mod.gates_for_client(masks, 0)
        lg_gated = tfm.server_forward(cfg, params["server"], acts, prompts,
                                      gates=gates)
        folded0 = masks_mod.fold_unit_masks(cfg, params["server"], masks, 0)
        lg_fold = tfm.server_forward(cfg, folded0, acts, prompts)
    err = float((lg_gated - lg_fold).abs().max())
    print(f"fold-vs-gate max |dlogit| = {err:.4f} (binary masks -> ~0)")
    assert err < 0.1

    # --- (b) serve both clients from their folded models ---
    outs = {}
    for c in range(n_clients):
        p_c = dict(params)
        p_c["server"] = masks_mod.fold_unit_masks(cfg, params["server"],
                                                  masks, c)
        sp = masks_mod.sparsity(masks_mod.gates_for_client(masks, c))
        out = serve_session(cfg, p_c, prompts, gen_steps=8, device=device)
        outs[c] = out.cpu().numpy()
        print(f"client {c}: mask sparsity {sp:.2f}, "
              f"tokens {outs[c][0][:8].tolist()}")
    assert (outs[0] != outs[1]).any(), \
        "distinct masks must give distinct personalized models"
    print("personalized serving OK: two clients, two effective models, "
          "one shared server parameter store")
    return err, outs


if __name__ == "__main__":
    main()
