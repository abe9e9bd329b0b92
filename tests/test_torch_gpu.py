"""Tests of the port that need a CUDA card, marked ``gpu``; they skip on
a machine without one.  This file imports no JAX (the machine with the
card has none): the kernels are held against their plain PyTorch
versions on the card, and the trainer on the card against the same
trainer on the CPU.  Run them there with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the panel GEMM sums <= 1600 float32 products in another
order than the plain version (1e-4 on values of order 1); the Adam
kernel is built with -fmad=false and repeats the plain version's float32
ops in the same order (1e-6 relative); the flash kernel sums its
float32 dots and softmax in another order than the plain version, with
exp2 in place of exp (2e-5 absolute on outputs of order 1 in float32;
in bfloat16 the output is rounded to 8 bits of mantissa, 2e-2)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.data.synthetic import mixed_noniid
from repro_torch.kernels import client_conv as tcc
from repro_torch.kernels import flash_attention as tfa
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


@pytest.mark.parametrize("B,Hq,Hkv,S", [(2, 14, 2, 128), (3, 4, 4, 77),
                                       (1, 14, 2, 1), (2, 8, 2, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,ragged", [
    (True, 0, False), (True, 0, True), (False, 0, True), (True, 48, False),
    (True, 48, True), (False, 40, True)],
    ids=["causal", "causal-ragged", "full-ragged", "window",
         "window-ragged", "full-window-ragged"])
def test_flash_attention_matches_plain(cuda, B, Hq, Hkv, S, dtype, causal,
                                       window, ragged):
    """The kernel on (B, S, H, hd) tensors taken as transposed views, as
    the model passes them, against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, 64), device=cuda, generator=gen)
               .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    kv_len = torch.randint(1, S + 1, (B,), device=cuda, generator=gen,
                           dtype=torch.int32) if ragged else None
    before = tfa.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (B, Hq, S, 64) and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_cuda(q, q, q)


def test_lm_prefill_and_decode_on_card_match_cpu(cuda):
    """qwen2-0.5b reduced, float32: a ragged prefill (every layer's
    attention one flash launch) and a per-slot decode step on the card
    against the same on the CPU."""
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    gpu = init_serve_params(cfg, 0, "float32", device="cuda")
    cpu = tree_map(lambda t: t.cpu(), gpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 70)).astype(np.int32))
    last = torch.tensor([69, 20, 45])
    tfa.reset_launches()
    lg, cg = dec.prefill(cfg, gpu, toks.cuda(), last_index=last.cuda())
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    lc, cc = dec.prefill(cfg, cpu, toks, last_index=last)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    tok = lc.argmax(-1).to(torch.int32)
    lg, _ = dec.decode_step(cfg, gpu, tok.cuda(), cg, (last + 1).cuda())
    lc, _ = dec.decode_step(cfg, cpu, tok, cc, last + 1)
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
