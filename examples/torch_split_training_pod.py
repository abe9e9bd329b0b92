"""End-to-end driver of the PyTorch port: AdaSplit over a transformer LM,
the pod-scale variant of the protocol, run for a few hundred steps on a
reduced architecture with the UCB orchestrator, the two-phase schedule,
resource metering and a checkpoint at the end (the torch counterpart of
``examples/split_training_pod.py``, same defaults).

  PYTHONPATH=src python examples/torch_split_training_pod.py \
      [--arch qwen2-0.5b] [--steps 200] [--kappa 0.5] [--device cuda|cpu]

The cohorts are the host mesh's data axis (``launch.mesh.make_host_mesh``:
one process, so one cohort, as the reference's mesh of one device); the
LM trainer's state over a larger (data, model) mesh is not ported yet.
For the full configs use ``repro_torch.launch.train`` directly.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import LaunchPolicy
from repro_torch.launch.train import LMAdaSplitTrainer
from repro_torch.sharding.rules import MeshAxes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--kappa", type=float, default=0.5)
    ap.add_argument("--eta", type=float, default=0.6)
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "adasplit_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    mesh = make_host_mesh(device=args.device)
    shape = InputShape("example", args.seq, args.batch, "train")
    policy = LaunchPolicy(microbatch=1)
    tr = LMAdaSplitTrainer(cfg, shape, policy,
                           n_cohorts=MeshAxes.from_mesh(mesh).data_size,
                           kappa=args.kappa, eta=args.eta,
                           device=mesh.device)
    t0 = time.time()
    hist = tr.run(args.steps)
    dt = time.time() - t0

    # summary: loss trajectory + the protocol's resource story
    for h in hist[:: max(1, len(hist) // 12)]:
        print(f"step {h['step']:4d} [{h['phase']:6s}] "
              f"ntxent={h['l_client']:.3f} ce={h['ce']:.3f} "
              f"bw={h['bandwidth_gb']:.4f}GB")
    local = [h for h in hist if h["phase"] == "local"]
    glob = [h for h in hist if h["phase"] == "global"]
    print(f"\n{args.steps} steps in {dt:.0f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s on "
          f"{mesh.device})")
    print(f"local phase: {len(local)} steps, 0 bytes client<->server")
    print(f"global phase: {len(glob)} steps, "
          f"{tr.meter.bandwidth_gb:.4f} GB activations up, 0 B grads down")
    assert glob[-1]["ce"] < glob[0]["ce"], "server CE should improve"

    from repro_torch.checkpoint.io import save_checkpoint
    save_checkpoint(args.checkpoint, tr.state["trainables"],
                    {"arch": args.arch, "steps": args.steps})
    print("checkpoint ->", args.checkpoint)
    return hist


if __name__ == "__main__":
    main()
