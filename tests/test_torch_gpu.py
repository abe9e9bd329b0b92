"""Tests of the port that need a CUDA card, marked ``gpu``; they skip on
a machine without one.  This file imports no JAX (the machine with the
card has none): the kernels are held against their plain PyTorch
versions on the card, and the trainer on the card against the same
trainer on the CPU.  Run them there with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the panel GEMM sums <= 1600 float32 products in another
order than the plain version (1e-4 on values of order 1); the Adam
kernel is built with -fmad=false and repeats the plain version's float32
ops in the same order (1e-6 relative)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.data.synthetic import mixed_noniid
from repro_torch.kernels import client_conv as tcc
from repro_torch.kernels import masked_adam as tma
from repro_torch.weights import strict_fp32, tree_leaves

pytestmark = pytest.mark.gpu
KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    strict_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("C,M,K,N", [(2, 2048, 75, 6), (1, 1000, 150, 16),
                                     (1, 77, 1600, 64), (3, 129, 17, 70)])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_panel_gemm_matches_plain(cuda, C, M, K, N, fused):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((C, M, K), device=cuda, generator=gen)
    b = torch.randn((C, K, N), device=cuda, generator=gen) / K ** 0.5
    bias = torch.randn((C, N), device=cuda, generator=gen) if fused else None
    key = "panel_gemm_bias_relu" if fused else "panel_gemm"
    before = tcc.LAUNCHES[key]
    got = tcc.panel_gemm_cuda(a, b, bias)
    want = tcc.panel_gemm_plain(a, b, bias)
    torch.cuda.synchronize()
    assert tcc.LAUNCHES[key] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_client_conv_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 2, 16, 16, 3)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(2, 5, 5, 3, 6)) / 9).astype(
        np.float32))
    bias = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    cpu = tcc.client_conv(x, w, bias=bias, fused_epilogue=True)
    gpu = tcc.client_conv(x.to(cuda), w.to(cuda), bias=bias.to(cuda),
                          fused_epilogue=True)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_masked_adam_matches_plain_per_row_steps(cuda, masked):
    gen = torch.Generator(device=cuda).manual_seed(1)
    shape = (6, 5, 5, 7)
    p, g, mu = (torch.randn(shape, device=cuda, generator=gen) * s
                for s in (1.0, 1e-2, 1e-3))
    nu = torch.rand(shape, device=cuda, generator=gen) * 1e-4
    mask = torch.rand(shape, device=cuda, generator=gen) if masked else None
    step = torch.tensor([1, 2, 3, 10, 40, 7], dtype=torch.int32, device=cuda)
    b1t, b2t = tma.bias_corrections(step, 0.9, 0.999)
    before = tma.LAUNCHES["masked_adam"]
    got = tma.masked_adam_cuda(p, g, mu, nu, mask, b1t=b1t, b2t=b2t, **KW)
    want = tma.masked_adam_plain(p, g, mu, nu, mask, b1t=b1t, b2t=b2t, **KW)
    torch.cuda.synchronize()
    assert tma.LAUNCHES["masked_adam"] == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["per_unit", "per_scalar"])
def test_trainer_iteration_on_card_matches_cpu_and_launches(cuda, mode):
    """One global iteration from one state on the card and on the CPU:
    equal selection, CE to 1e-4, state within the Adam sign-flip bound
    (an element whose gradient is ~0 may move by <= 2*lr on one side);
    every kernel of the path launched on the card."""
    cfg = dataclasses.replace(get_config("lenet-cifar"), image_size=16,
                              conv_channels=(4, 8, 8))
    clients = mixed_noniid(n_clients=3, n_per_client=16, n_test=8, seed=0)
    for c in clients:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    hp = AdaSplitHParams(rounds=1, eta=0.67, batch_size=8, mask_mode=mode,
                         fused_epilogue=mode == "per_scalar")
    gpu = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    cpu = AdaSplitTrainer(cfg, hp, clients, device="cpu")
    cpu.set_state(gpu.get_state())
    xs = np.stack([c.x[:8] for c in clients])
    ys = np.stack([c.y[:8] for c in clients])
    tcc.reset_launches()
    tma.reset_launches()
    sel_g, ce_g, _ = gpu.train_iteration(xs, ys, global_phase=True)
    key = "panel_gemm_bias_relu" if hp.fused_epilogue else "panel_gemm"
    assert tcc.LAUNCHES[key] == 1 + 2 and tma.LAUNCHES["masked_adam"] > 0
    sel_c, ce_c, _ = cpu.train_iteration(xs, ys, global_phase=True)
    np.testing.assert_array_equal(sel_g, sel_c)
    np.testing.assert_allclose(ce_g, ce_c, rtol=1e-4)
    off = total = 0
    for a, b in zip(tree_leaves(gpu.get_state()),
                    tree_leaves(cpu.get_state())):
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= 2.5 * hp.lr
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total
    assert gpu.evaluate() == pytest.approx(cpu.evaluate(), abs=100 / 8)
