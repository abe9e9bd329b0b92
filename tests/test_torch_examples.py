"""The port's examples (``examples/torch_*.py``) run on the CPU at the
smallest arguments that still pass their own assertions, and the
vision trainer's CLI runs cohort-sharded under ``torchrun`` on 2 CPU
ranks.  The examples import only ``repro_torch``; the reference's three
examples are not run here."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs(capsys):
    rows = _example("torch_quickstart").main(
        ["--rounds", "1", "--clients", "2", "--device", "cpu"])
    assert set(rows) == {"adasplit", "fedavg"}
    assert all(np.isfinite(v).all() for v in rows.values())
    assert "C3" in capsys.readouterr().out


def test_personalized_serving_runs():
    err, outs = _example("torch_personalized_serving").main(
        ["--device", "cpu"])
    assert err < 0.1 and (outs[0] != outs[1]).any()


def test_split_training_pod_runs(tmp_path):
    path = str(tmp_path / "ckpt")
    hist = _example("torch_split_training_pod").main(
        ["--steps", "6", "--device", "cpu", "--checkpoint", path])
    assert [h["phase"] for h in hist] == ["local"] * 3 + ["global"] * 3
    assert os.path.exists(path + ".npz")


def test_no_example_imports_jax():
    """The torch examples, loaded as programs, load no JAX module."""
    code = ("import runpy, sys\n"
            "for path in sys.argv[1:]:\n"
            "    sys.argv = ['x', '--help']\n"
            "    try:\n"
            "        runpy.run_path(path, run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    paths = [os.path.join(ROOT, "examples", f"{name}.py")
             for name in ("torch_quickstart", "torch_personalized_serving",
                          "torch_split_training_pod")]
    r = subprocess.run([sys.executable, "-c", code, *paths],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0, r.stderr


def test_train_cli_shards_under_torchrun():
    """``--shard`` (the default) on 2 torchrun ranks on the CPU: the
    vision trainer reports ``sharded=True`` over gloo, and its
    interconnect bill is > 0."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "lenet-cifar", "--clients", "4", "--steps", "2",
         "--batch", "8", "--device", "cpu"],
        capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    done = [line for line in r.stdout.splitlines() if line.startswith("done")]
    assert len(done) == 1, r.stdout
    assert "sharded=True, world=2, backend=gloo" in done[0]
    assert "interconnect=0.0000 GB" not in done[0]
