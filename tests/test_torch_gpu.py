"""Tests of the port that need a CUDA card, marked ``gpu``; they skip on
a machine without one.  This file imports no JAX (the machine with the
card has none): the kernels are held against their plain PyTorch
versions on the card, and the trainer on the card against the same
trainer on the CPU.  Run them there with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the panel GEMM sums <= 1600 float32 products in another
order than the plain version, split over up to 8 K ranges (1e-4 on
values of order 1), and is bit-equal to itself launch to launch; the Adam
kernel is built with -fmad=false and repeats the plain versions' float32
ops in the same order (1e-6 relative, and bit-equal where a test says
so); the flash kernel sums its
float32 dots and softmax in another order than the plain version, with
exp2 in place of exp (2e-5 absolute on outputs of order 1 in float32;
in bfloat16 the output is rounded to 8 bits of mantissa, 2e-2); the
MoE block (torch ops and cuBLAS products, no kernel of its own) sums in
other orders than the CPU (1e-5 of the largest magnitude in strict
fp32); the
NT-Xent kernels sum their f32 dots and row sums in another order (1e-5
of the largest magnitude); soft-threshold is bit-equal to its plain
version.  The round and epoch rungs on the card must select and bill as
the eager rung does and make no host sync but their one fetch."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.data.synthetic import mixed_noniid
from repro_torch.kernels import _build
from repro_torch.kernels import client_conv as tcc
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import masked_adam as tma
from repro_torch.kernels import ntxent as tnt
from repro_torch.kernels import soft_threshold as tst
from repro_torch.weights import strict_fp32, tree_leaves
# shapes whose plan on a 132-SM card (H100 SXM) splits K 1, 2, 4 and 8 ways
from test_torch_panel_plan import SPLIT_GEMMS

pytestmark = pytest.mark.gpu
KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    strict_fp32()
    return torch.device("cuda")


# the LeNet path's conv GEMMs: the main run's five (client block over 32
# clients, server blocks over S*B = 19*32 flattened rows) and the fused
# run's stacked server blocks (19 selected clients)
PATH_GEMMS = [(32, 32768, 75, 6), (1, 155648, 150, 16), (1, 38912, 400, 32),
              (1, 9728, 800, 64), (1, 2432, 1600, 64), (19, 8192, 150, 16),
              (19, 2048, 400, 32), (19, 512, 800, 64), (19, 128, 1600, 64)]


def _gemm_inputs(cuda, C, M, K, N, fused, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((C, M, K), device=cuda, generator=gen)
    b = torch.randn((C, K, N), device=cuda, generator=gen) / K ** 0.5
    bias = torch.randn((C, N), device=cuda, generator=gen) if fused else None
    return a, b, bias


@pytest.mark.parametrize("C,M,K,N", [(2, 2048, 75, 6), (1, 1000, 150, 16),
                                     (1, 77, 1600, 64), (3, 129, 17, 70)]
                         + PATH_GEMMS)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_panel_gemm_matches_plain(cuda, C, M, K, N, fused):
    a, b, bias = _gemm_inputs(cuda, C, M, K, N, fused)
    key = "panel_gemm_bias_relu" if fused else "panel_gemm"
    before = tcc.LAUNCHES[key]
    got = tcc.panel_gemm_cuda(a, b, bias)
    want = tcc.panel_gemm_plain(a, b, bias)
    torch.cuda.synchronize()
    assert tcc.LAUNCHES[key] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("splits,C,M,K,N", SPLIT_GEMMS)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_panel_gemm_every_split_matches_plain_and_repeats(cuda, splits, C, M,
                                                          K, N, fused):
    """Each split count the planner gives (one thread-block cluster per
    output tile, the partial tiles summed over distributed shared
    memory): the plain version's values, and two launches bit-equal (a
    fixed summation order)."""
    block_m, _, planned = tcc.plan_panel_gemm(C, M, K, N,
                                              _build.sm_count(cuda))
    assert planned == splits and M % block_m and K % tcc.BLOCK_K
    a, b, bias = _gemm_inputs(cuda, C, M, K, N, fused, seed=splits)
    got = tcc.panel_gemm_cuda(a, b, bias)
    again = tcc.panel_gemm_cuda(a, b, bias)
    want = tcc.panel_gemm_plain(a, b, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


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
                                       (1, 14, 2, 1), (2, 8, 2, 200),
                                       (8, 14, 2, 512), (4, 14, 2, 333)])
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


@pytest.mark.parametrize("hd", [96, 128], ids=["hd96", "hd128"])
@pytest.mark.parametrize("B,Hq,Hkv,S", [(2, 32, 8, 512), (3, 4, 4, 77),
                                       (1, 32, 32, 1), (4, 16, 16, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,ragged", [
    (True, 0, False), (True, 0, True), (False, 0, True), (True, 48, True)],
    ids=["causal", "causal-ragged", "full-ragged", "window-ragged"])
def test_flash_attention_head_dims_match_plain(cuda, hd, B, Hq, Hkv, S, dtype,
                                               causal, window, ragged):
    """hd 96 (phi3-mini: two 64-column chunks, the second half zeros from
    the tensor map's edge) and 128 (granite, olmo) against the plain
    version, at the same tolerances as hd 64."""
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    q, k, v = (torch.randn((B, S, h, hd), device=cuda, generator=gen)
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
    assert got.shape == (B, Hq, S, hd) and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("B,S,ragged", [(8, 512, False), (8, 407, True),
                                         (1, 64, True)])
def test_flash_attention_gqa_32_4_hd128_matches_plain(cuda, B, S, ragged):
    """qwen3-moe-30b-a3b's prefill shape: 32 query heads over 4 kv heads
    (a group of 8), hd 128, bf16, causal, kv_len where ragged."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, 128), device=cuda, generator=gen)
               .to(torch.bfloat16).transpose(1, 2) for h in (32, 4, 4))
    kv_len = torch.randint(1, S + 1, (B,), device=cuda, generator=gen,
                           dtype=torch.int32) if ragged else None
    before = tfa.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=True, kv_len=kv_len)
    want = tfa.flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (B, 32, S, 128) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


def _moe_block(cuda, seed=0, **kw):
    """A reduced deepseek-moe-16b MoE block (4 experts top-2, a shared
    expert) in float32 on the card and its copy on the CPU."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              dtype="float32", **kw)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = moe.moe_init(gen, cfg)
    return cfg, p, {k: v.cpu() if torch.is_tensor(v) else
                    {n: t.cpu() for n, t in v.items()} for k, v in p.items()}


def test_moe_forward_on_card_matches_cpu_with_drops(cuda):
    """``moe_forward`` on the card against the CPU at one reduced shape in
    strict fp32 (C = 16 for 64 tokens x top-2 over 4 experts at capacity
    factor 0.5, so assignments drop): equal routing and drops, outputs
    within f32 rounding (1e-5 of the largest magnitude), a (B, E) gate."""
    from repro_torch.models import moe
    cfg, gp, cp = _moe_block(cuda, moe_capacity_factor=0.5)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, 64, cfg.d_model), device=cuda, generator=gen)
    gate = (torch.rand((3, cfg.n_experts), device=cuda, generator=gen)
            > 0.3).float()
    moe.count_drops()
    try:
        y, aux = moe.moe_forward(gp, x, cfg, gate)
        share = moe.drop_share()
    finally:
        moe.count_drops(False)
    yc, auxc = moe.moe_forward(cp, x.cpu(), cfg, gate.cpu())
    _, idx, _, _ = moe.route(gp, x, cfg)
    _, idxc, _, _ = moe.route(cp, x.cpu(), cfg)
    assert torch.equal(idx.cpu(), idxc) and share > 0
    torch.testing.assert_close(y.cpu(), yc, rtol=0,
                               atol=1e-5 * float(yc.abs().max()))
    torch.testing.assert_close(aux.cpu(), auxc, rtol=0, atol=1e-6)


def test_moe_decode_step_makes_no_host_sync(cuda):
    """A reduced MoE decode step (deepseek: dense first layer, two MoE
    layers; per-example gates) runs under sync_debug_mode("error")."""
    from repro_torch.core import masks as tmasks
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              first_k_dense=1, n_layers=3, dtype="float32")
    params = init_serve_params(cfg, 0, "float32", device=cuda)
    gates = tmasks.expand_gates(
        tmasks.init_unit_masks(cfg, 3, device=cuda), [2, 0, 1])
    toks = torch.randint(0, cfg.vocab_size, (3, 12), device=cuda,
                         dtype=torch.int32)
    lg, cache = dec.prefill(cfg, params, toks, gates=gates, cache_len=16)
    tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, cache = dec.decode_step(cfg, params, tok, cache, 12, gates=gates)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert lg.shape == (3, 1, cfg.padded_vocab())
    assert bool(torch.isfinite(lg).all())


def test_chunked_attention_on_card_matches_cpu(cuda):
    """Above S = 2048 (granite's hd 128, GQA 4/2, f32 inputs): the card
    runs the bf16 flash kernel on the bf16-rounded q, k, v, the CPU the
    reference's ``mha_chunked``; they differ in P's rounding (16 bits
    against 8) and the output's (bf16 against f32), so 2e-2 as bf16."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((1, 2304, h, 128), device=cuda, generator=gen)
               for h in (4, 2, 2))
    before = tfa.LAUNCHES["flash_attention"]
    got = attn.chunked_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    want = attn.chunked_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-2)


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_cuda(q, q, q)
    # bfloat16 rows must be 16-byte aligned (TMA): a 4-element offset is not
    buf = torch.zeros((1, 2, 8, 68), device=cuda, dtype=torch.bfloat16)
    q = buf[..., 4:]
    with pytest.raises(ValueError, match="8-element aligned"):
        tfa.flash_attention_cuda(q, q, q)


def test_flash_attention_refuses_inputs_that_require_grad(cuda):
    """The kernel has no backward: with grad mode on, a q, k or v that
    requires grad is refused rather than given an output without a
    gradient; under no_grad the same tensors run."""
    q = torch.randn((1, 2, 64, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        tfa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="no backward"):
        tfa.flash_attention(q.detach(), k, k.clone().requires_grad_(True))
    with torch.no_grad():
        out = tfa.flash_attention(q, k, k)
    assert not out.requires_grad


def test_lm_train_step_on_card_matches_cpu_and_launches(cuda):
    """One global LM train step (reduced qwen2, float32, C=2 cohorts of
    4 rows) on the card and on the CPU from the same state: the losses
    within 1e-4 and the new moments within 1e-4 of each leaf's largest
    magnitude; on the card one NT-Xent forward and one backward launch,
    the client Adam launches ``plan_launches`` predicts, and no flash
    launch (training attention is ``mha_einsum``)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    C, b, S = 2, 4, 16
    pol = tsteps.LaunchPolicy(param_dtype="float32")
    fn = tsteps.build_train_step(cfg, InputShape("t", S, C * b, "train"),
                                 pol, n_cohorts=C)
    state = tsteps.init_train_state(cfg, C, pol, 0, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (C * b, S)),
             "labels": rng.integers(0, 512, (C * b, S)),
             "seq_class": np.repeat(np.arange(C), b),
             "select": np.array([1.0, 0.0], np.float32)}
    batch = {k: torch.from_numpy(np.asarray(v).astype(
        np.float32 if k == "select" else np.int32)) for k, v in batch.items()}
    cpu_state = tree_map(lambda t: t.cpu(), state)
    for m in (tma, tnt, tfa):
        m.reset_launches()
    new, mg = fn(state, {k: v.to(cuda) for k, v in batch.items()})
    want = {"ntxent_stats": 1, "ntxent_backward": 1, "flash_attention": 0,
            "client_adam": len(tma.plan_launches(
                [t.numel() for t in tree_leaves(state["trainables"])])),
            "masked_adam": 0}
    got = dict(tnt.LAUNCHES, **tma.LAUNCHES, **tfa.LAUNCHES)
    assert {k: got[k] for k in want} == want
    new_c, mc = fn(cpu_state, batch)
    for k in ("l_client", "ce"):
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4)
    for key in ("mu", "nu"):
        for a, c in zip(tree_leaves(new["opt"][key]),
                        tree_leaves(new_c["opt"][key])):
            scale = float(c.abs().max()) or 1.0
            assert float((a.cpu() - c).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_repeats_bit_equal(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((8, 512, h, 64), device=cuda, generator=gen)
               .to(dtype).transpose(1, 2) for h in (14, 2, 2))
    assert torch.equal(tfa.flash_attention(q, k, v), tfa.flash_attention(q, k, v))


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


def _lm_on_card_and_cpu(cuda, n_clients=4):
    """qwen2-0.5b reduced, float32: params and 0/1 masks drawn on the
    card, and their copies on the CPU."""
    from repro_torch.core import masks as tmasks
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    gpu = init_serve_params(cfg, 0, "float32", device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(9)
    masks = tree_map(lambda m: (torch.rand(m.shape, device=cuda,
                                           generator=gen) > 0.4).float(),
                     tmasks.init_unit_masks(cfg, n_clients, device=cuda))
    to_cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    return cfg, gpu, masks, to_cpu(gpu), to_cpu(masks)


def _continuous_run(cfg, params, masks, device, spec, chunks):
    from repro_torch.serve import ContinuousEngine, Request
    eng = ContinuousEngine(cfg, params, masks, max_batch=3, cache_len=48,
                           device=device)
    rng = np.random.default_rng(0)
    pending = [Request(i, c, rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), mn) for i, (c, n, mn) in enumerate(spec)]
    k = 0
    while pending or not eng.sched.idle():
        n = chunks[k % len(chunks)]
        k += 1
        for r in pending[:n]:
            eng.submit(r)
        pending = pending[n:]
        eng.step()
    return eng, {r.req_id: r.output.tolist() for r in eng._done}


def test_continuous_engine_on_card_matches_cpu(cuda):
    """Ragged prompts (buckets 8-32), budgets 1-7 and arrivals between
    steps: the same tokens, stats, admission log and completion order on
    the card as on the CPU, each admission prefill one flash launch per
    layer."""
    cfg, gpu, masks, cpu, cmasks = _lm_on_card_and_cpu(cuda)
    spec = [(i % 4, 3 + (7 * i) % 30, 1 + (5 * i) % 7) for i in range(10)]
    tfa.reset_launches()
    ge, gout = _continuous_run(cfg, gpu, masks, "cuda", spec, [2, 0, 3, 1])
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers * len(spec)
    ce, cout = _continuous_run(cfg, cpu, cmasks, "cpu", spec, [2, 0, 3, 1])
    assert list(gout) == list(cout) and gout == cout
    g, c = dataclasses.asdict(ge.stats), dataclasses.asdict(ce.stats)
    g.pop("wall_s"), c.pop("wall_s")
    assert g == c
    assert ge.sched.admission_log == ce.sched.admission_log
    assert ge.host_syncs == ce.host_syncs == {"prompt_uploads": len(spec),
                                              "row_reads": len(spec)}


def test_slot_cache_and_gates_on_card_equal_cpu(cuda):
    from repro_torch.core import masks as tmasks
    from repro_torch.models import decode as dec
    from repro_torch.weights import tree_map
    cfg, _, masks, _, cmasks = _lm_on_card_and_cpu(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    rand = lambda tree: tree_map(lambda t: torch.randn(
        t.shape, device=cuda, generator=gen).to(t.dtype), tree)
    batch = rand(dec.init_cache(cfg, 5, 40, device=cuda))
    one = rand(dec.init_cache(cfg, 1, 40, device=cuda))
    gates = rand(tmasks.init_slot_gates(masks, 5))
    to_cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    cbatch, cone, cgates = to_cpu(batch), to_cpu(one), to_cpu(gates)
    for slot, client in ((0, 1), (4, 3), (2, 0)):
        dec.merge_slot_cache(batch, one, slot)
        dec.merge_slot_cache(cbatch, cone, slot)
        tmasks.set_slot_gates(gates, slot,
                              tmasks.gates_for_client(masks, client))
        tmasks.set_slot_gates(cgates, slot,
                              tmasks.gates_for_client(cmasks, client))
        for a, b in zip(tree_leaves(batch) + tree_leaves(gates),
                        tree_leaves(cbatch) + tree_leaves(cgates)):
            assert a.is_cuda and torch.equal(a.cpu(), b)


def test_continuous_engine_syncs_only_to_upload_and_read(cuda):
    """Over a whole ragged run with arrivals, the host syncs that
    sync_debug_mode("warn") sees are the engine's own: one prompt
    upload per admission and one row read per completion."""
    import warnings
    cfg, gpu, masks, _, _ = _lm_on_card_and_cpu(cuda)
    spec = [(i % 4, 3 + (7 * i) % 30, 1 + (5 * i) % 7) for i in range(10)]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng, _ = _continuous_run(cfg, gpu, masks, "cuda", spec,
                                     [2, 0, 3, 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own first-use notice also says "synchronizing"
    n = sum("called a synchronizing CUDA operation" in str(w.message)
            for w in caught)
    assert n == sum(eng.host_syncs.values()) == 2 * len(spec)


def test_continuous_steady_decode_step_makes_no_host_sync(cuda):
    """Once every slot is admitted, a step that neither admits nor
    completes runs under sync_debug_mode("error")."""
    from repro_torch.serve import ContinuousEngine, Request
    cfg, gpu, masks, _, _ = _lm_on_card_and_cpu(cuda)
    eng = ContinuousEngine(cfg, gpu, masks, max_batch=4, cache_len=64)
    rng = np.random.default_rng(1)
    for i in range(4):
        eng.submit(Request(i, i, rng.integers(
            0, cfg.vocab_size, 5 + 9 * i).astype(np.int32), 20))
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            assert eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.stats.decode_steps == 4 and eng.stats.requests == 0
    assert eng.host_syncs == {"prompt_uploads": 4, "row_reads": 0}
    eng.run_until_idle()
    assert eng.stats.completed == eng.stats.tokens == 80


@pytest.mark.parametrize("C,B,D", [(32, 32, 64), (3, 7, 16), (2, 33, 64),
                                   (1, 2, 256), (4, 100, 48), (19, 32, 64)])
def test_ntxent_stats_matches_plain_and_gradient_matches_cpu(cuda, C, B, D):
    gen = torch.Generator(device=cuda).manual_seed(B)
    raw = torch.randn((C, B, D), device=cuda, generator=gen)
    q = raw / (torch.linalg.vector_norm(raw, dim=-1, keepdim=True) + 1e-8)
    y = torch.randint(0, 3, (C, B), device=cuda, generator=gen,
                      dtype=torch.int32)
    y[:, 0] = 99                                # a row with no positive
    before = tnt.LAUNCHES["ntxent_stats"]
    got = tnt.ntxent_stats_cuda(q, y, 0.07)
    want = tnt.ntxent_stats_plain(q, y, 0.07)
    torch.cuda.synchronize()
    assert tnt.LAUNCHES["ntxent_stats"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (C, B)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
            1.0, float(b.abs().max())))
    qg = raw.clone().requires_grad_(True)
    tnt.ntxent_loss(qg, y, 0.07).sum().backward()
    qc = raw.cpu().requires_grad_(True)
    tnt.ntxent_loss(qc, y.cpu(), 0.07).sum().backward()
    torch.testing.assert_close(qg.grad.cpu(), qc.grad, rtol=0, atol=1e-5 * (
        float(qc.grad.abs().max()) + 1e-30))


def test_ntxent_refuses_what_it_cannot_take(cuda):
    y = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="projection width"):
        tnt.ntxent_stats_cuda(torch.zeros((2, 4, 257), device=cuda), y)
    with pytest.raises(TypeError):
        tnt.ntxent_stats_cuda(torch.zeros((2, 4, 8), device=cuda,
                                          dtype=torch.float64), y)


@pytest.mark.parametrize("n", [1, 7, 1 << 20, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_soft_threshold_bit_equal_to_plain(cuda, n, dtype, offset):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n + offset,), device=cuda, generator=gen).to(dtype)
    x = x[offset:]                  # offset 1: the kernel's scalar path
    before = tst.LAUNCHES["soft_threshold"]
    got = tst.soft_threshold(x, 0.3)
    want = tst.soft_threshold_plain(x, 0.3)
    torch.cuda.synchronize()
    assert tst.LAUNCHES["soft_threshold"] == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


def _small_lenet():
    cfg = dataclasses.replace(get_config("lenet-cifar"), image_size=16,
                              conv_channels=(4, 8, 8))
    clients = mixed_noniid(n_clients=4, n_per_client=24, n_test=8, seed=0)
    for c in clients:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    return cfg, clients


@pytest.mark.parametrize("rung", [dict(), dict(epoch_scan=True),
                                  dict(epoch_scan=True, epoch_chunk_rounds=1)],
                         ids=["round", "epoch", "epoch_chunk1"])
def test_rungs_on_card_match_eager_with_one_fetch(cuda, rung):
    """The rung and the eager rung on the card: equal selections and
    Meter totals, state within the Adam sign-flip bound (in practice
    equal); the rung's training runs under sync_debug_mode "error", the
    mode lifted only in its one fetch per global round or epoch, and the
    NT-Xent kernel launches once per client step."""
    cfg, clients = _small_lenet()
    kw = dict(rounds=3, kappa=0.34, eta=0.5, batch_size=8, act_l1=1e-3)
    runs = {}
    for name, extra in (("eager", dict(round_scan=False)), ("rung", rung)):
        tr = AdaSplitTrainer(cfg, AdaSplitHParams(**kw, **extra), clients,
                             device="cuda")
        log, ingest, update = [], tr.orch.ingest_round, tr.orch.update
        tr.orch.ingest_round = lambda s, l, state=None: (
            log.extend(np.array(s)), ingest(s, l, state=state))
        tr.orch.update = lambda s, l: (log.append(np.array(s)), update(s, l))
        fetches, fetch = [], tr._fetch

        def lifted(tensors, fetch=fetch, fetches=fetches):
            fetches.append(len(tr.history))
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fetch(tensors)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        tr._fetch = lifted
        tnt.reset_launches()
        if name == "rung":
            torch.cuda.set_sync_debug_mode("error")
            # the history's eval points read accuracies on the host
            tr.evaluate = lambda real=tr.evaluate: _lifted(real)
        try:
            tr.train(eval_every=100)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert tnt.LAUNCHES["ntxent_stats"] == kw["rounds"] * 3
        runs[name] = (tr, log, fetches)
    (eager, e_log, _), (tr, r_log, fetches) = runs["eager"], runs["rung"]
    assert fetches == ([1, 2] if not rung else [1])
    assert len(r_log) == len(e_log) == 6
    for a, b in zip(r_log, e_log):
        np.testing.assert_array_equal(a, b)
    for f in ("bandwidth_bytes", "client_flops", "server_flops",
              "host_device_bytes"):
        assert getattr(tr.meter, f) == getattr(eager.meter, f), f
    off = total = 0
    for a, b in zip(tree_leaves(tr.get_state()),
                    tree_leaves(eager.get_state())):
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= 2.5 * tr.hp.lr * 6
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total


def _lifted(fn):
    torch.cuda.set_sync_debug_mode(0)
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("error")


def _adam_leaves(cuda, shapes, masked, gen):
    out = []
    for shape in shapes:
        p, g, mu = (torch.randn(shape, device=cuda, generator=gen) * s
                    for s in (1.0, 1e-2, 1e-3))
        nu = torch.rand(shape, device=cuda, generator=gen) * 1e-4
        mask = torch.rand(shape, device=cuda, generator=gen) \
            if masked else None
        out.append((p, g, mu, nu, mask))
    return out


@pytest.mark.parametrize("order", ["masked", "client"])
@pytest.mark.parametrize("step", ["scalar", "per_row"])
@pytest.mark.parametrize("n_leaves", [6, 75],
                         ids=["one_table", "three_tables"])
def test_adam_multi_bit_equal_to_plain_and_repeats(cuda, order, step,
                                                   n_leaves):
    """One launch per MAX_LEAVES leaves, bit-equal to the per-leaf plain
    versions on the card and launch to launch: mask rows of 6 and 120
    floats (a row boundary inside a float4), a (S,) leaf, an empty leaf,
    rows of 4096 and 4097 floats (CHUNK multiples and not), and a view one
    float off 16-byte alignment (the scalar path)."""
    S = 5
    gen = torch.Generator(device=cuda).manual_seed(n_leaves)
    base = [(S, 6), (S, 120), (S, 5, 5, 3), (S,), (S, 0), (S, 4096),
            (S, 4097)]
    shapes = [base[i % len(base)] for i in range(n_leaves - 1)]
    leaves = _adam_leaves(cuda, shapes, order == "masked", gen)
    buf = _adam_leaves(cuda, [(S * 33 + 1,)], order == "masked", gen)[0]
    leaves.append(tuple(None if t is None else t[1:].view(S, 33)
                        for t in buf))
    st = torch.randint(1, 60, (S,), device=cuda, generator=gen,
                       dtype=torch.int32) if step == "per_row" else \
        torch.tensor(9, device=cuda, dtype=torch.int32)
    b1t, b2t = tma.bias_corrections(st, 0.9, 0.999)
    client = order == "client"
    key = "client_adam" if client else "masked_adam"
    before = tma.LAUNCHES[key]
    got = tma.adam_multi_cuda(leaves, b1t=b1t, b2t=b2t, client_order=client,
                              **KW)
    again = tma.adam_multi_cuda(leaves, b1t=b1t, b2t=b2t,
                                client_order=client, **KW)
    want = tma.adam_multi_plain(leaves, b1t=b1t, b2t=b2t,
                                client_order=client, **KW)
    torch.cuda.synchronize()
    filled = sum(1 for leaf in leaves if leaf[0].numel())
    assert tma.LAUNCHES[key] == before + 2 * -(-filled // tma.MAX_LEAVES)
    for a, b, c in zip(got, again, want):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, z) and torch.equal(x, y)


def test_adam_update_on_card_is_one_launch_bit_equal(cuda):
    """The client step's ``adam_update`` on the card: one launch for a
    stacked tree with per-client steps, bit-equal to its plain version
    (the CPU path's ops on the card) and to itself."""
    from repro_torch.optim.adam import adam_init, adam_update
    gen = torch.Generator(device=cuda).manual_seed(2)
    C = 6
    params = {"c": [torch.randn((C, 5, 5, 3, 6), device=cuda, generator=gen),
                    torch.randn((C, 6), device=cuda, generator=gen)],
              "p": {"w": torch.randn((C, 150, 64), device=cuda,
                                     generator=gen)}}
    grads = {"c": [torch.randn_like(t) * 1e-2 for t in params["c"]],
             "p": {"w": torch.randn_like(params["p"]["w"]) * 1e-2}}
    st = adam_init(params)
    st["step"] = torch.tensor([0, 3, 1, 8, 2, 5], dtype=torch.int32,
                              device=cuda)
    before = tma.LAUNCHES["client_adam"]
    new_p, new_s = adam_update(params, grads, st, lr=1e-3)
    again_p, _ = adam_update(params, grads, st, lr=1e-3)
    torch.cuda.synchronize()
    assert tma.LAUNCHES["client_adam"] == before + 2
    b1t, b2t = tma.bias_corrections(st["step"] + 1, 0.9, 0.999)
    for (p, g, mu, nu), got, gm, gv, rep in zip(
            zip(*(tree_leaves(t) for t in (params, grads, st["mu"],
                                           st["nu"]))),
            tree_leaves(new_p), tree_leaves(new_s["mu"]),
            tree_leaves(new_s["nu"]), tree_leaves(again_p)):
        want = tma.adam_leaf_plain(p, g, mu, nu, b1t=b1t, b2t=b2t, **KW)
        assert torch.equal(got, want[0]) and torch.equal(got, rep)
        assert torch.equal(gm, want[1]) and torch.equal(gv, want[2])



def test_adam_update_on_card_takes_bf16_and_strided_leaves(cuda):
    """A bfloat16 leaf and a transposed (strided) leaf still go through the
    one launch, each bit-equal to its plain version on the same leaf, with
    the new p in the leaf's own dtype."""
    from repro_torch.optim.adam import adam_init, adam_update
    gen = torch.Generator(device=cuda).manual_seed(3)
    C = 4
    params = {"h": torch.randn((C, 40, 9), device=cuda, generator=gen)
              .to(torch.bfloat16),
              "t": torch.randn((C, 33, 17), device=cuda, generator=gen)
              .transpose(1, 2)}
    grads = {"h": torch.randn((C, 40, 9), device=cuda, generator=gen) * 1e-2,
             "t": (torch.randn((C, 33, 17), device=cuda, generator=gen)
                   * 1e-2).transpose(1, 2)}
    st = adam_init(params)
    st["mu"]["t"] = torch.randn((C, 33, 17), device=cuda,
                                generator=gen).transpose(1, 2) * 1e-3
    st["step"] = torch.tensor([0, 2, 5, 1], dtype=torch.int32, device=cuda)
    assert not params["t"].is_contiguous()
    before = tma.LAUNCHES["client_adam"]
    new_p, new_s = adam_update(params, grads, st, lr=1e-3)
    torch.cuda.synchronize()
    assert tma.LAUNCHES["client_adam"] == before + 1
    b1t, b2t = tma.bias_corrections(st["step"] + 1, 0.9, 0.999)
    for k in ("h", "t"):
        want = tma.adam_leaf_plain(params[k], grads[k], st["mu"][k],
                                   st["nu"][k], b1t=b1t, b2t=b2t, **KW)
        assert new_p[k].dtype == params[k].dtype
        assert torch.equal(new_p[k], want[0])
        assert torch.equal(new_s["mu"][k], want[1])
        assert torch.equal(new_s["nu"][k], want[2])


def test_ntxent_stats_on_card_is_the_kernel_without_gradient(cuda):
    """``ntxent_stats`` on CUDA tensors is the forward kernel's statistics
    (one launch, bit-equal to ``ntxent_stats_cuda``) and refuses a q that
    needs a gradient, as the TPU kernel has none."""
    raw, y, _ = _ntxent_inputs(cuda, 3, 16, 32, seed=5)
    q = raw / (torch.linalg.vector_norm(raw, dim=-1, keepdim=True) + 1e-8)
    before = tnt.LAUNCHES["ntxent_stats"]
    got = tnt.ntxent_stats(q, y)
    want = tnt.ntxent_stats_cuda(q, y)
    torch.cuda.synchronize()
    assert tnt.LAUNCHES["ntxent_stats"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="no gradient"):
        tnt.ntxent_stats(q.clone().requires_grad_(True), y)

def _ntxent_inputs(cuda, C, B, D, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    raw = torch.randn((C, B, D), device=cuda, generator=gen)
    y = torch.randint(0, 3, (C, B), device=cuda, generator=gen,
                      dtype=torch.int32)
    y[:, 0] = 99                                # a row with no positive
    if C > 1:
        y[-1] = torch.arange(B, device=cuda)    # a client of lone rows
    d_loss = torch.rand((C,), device=cuda, generator=gen) + 0.5
    return raw, y, d_loss


@pytest.mark.parametrize("C,B,D", [(32, 32, 64), (3, 7, 16), (2, 33, 64),
                                   (1, 2, 256), (4, 100, 48), (2, 128, 256),
                                   (19, 32, 64)])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_ntxent_fused_forward_backward_match_plain(cuda, C, B, D, normalize):
    """The fused forward (loss, statistics, norms) and backward (dq) each
    one launch, against their plain versions on the card and the loss's
    gradient against the CPU autograd path (1e-5 of the largest
    magnitude); a client of lone rows has loss and gradient 0; two
    launches bit-equal."""
    raw, y, dl = _ntxent_inputs(cuda, C, B, D, seed=B + D)
    if not normalize:
        raw = raw / D ** 0.5                    # rows of norm ~1
    f0, b0 = tnt.LAUNCHES["ntxent_stats"], tnt.LAUNCHES["ntxent_backward"]
    got = tnt.ntxent_forward_cuda(raw, y, 0.07, normalize)
    want = tnt.ntxent_loss_forward_plain(raw, y, 0.07, normalize)
    norms = got[4]
    dq = tnt.ntxent_backward_cuda(raw, y, norms, got[3], dl, 0.07,
                                  normalize)
    dq_again = tnt.ntxent_backward_cuda(raw, y, norms, got[3], dl,
                                        0.07, normalize)
    dq_plain = tnt.ntxent_loss_backward_plain(raw, y, dl, 0.07, normalize)
    torch.cuda.synchronize()
    assert (tnt.LAUNCHES["ntxent_stats"], tnt.LAUNCHES["ntxent_backward"]) \
        == (f0 + 1, b0 + 2)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
            1.0, float(b.abs().max())))
    assert torch.equal(dq, dq_again)
    torch.testing.assert_close(dq, dq_plain, rtol=0, atol=1e-5 * float(
        dq_plain.abs().max()))
    again = tnt.ntxent_forward_cuda(raw, y, 0.07, normalize)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    if C > 1:
        assert float(got[0][-1]) == 0.0 and float(dq[-1].abs().max()) == 0.0
    qg = raw.clone().requires_grad_(True)
    (tnt.ntxent_loss(qg, y, 0.07, normalize) * dl).sum().backward()
    qc = raw.cpu().requires_grad_(True)
    (tnt.ntxent_loss(qc, y.cpu(), 0.07, normalize) * dl.cpu()).sum(
        ).backward()
    torch.testing.assert_close(qg.grad.cpu(), qc.grad, rtol=0, atol=1e-5 * (
        float(qc.grad.abs().max()) + 1e-30))


def test_ntxent_refuses_more_rows_than_one_cta_takes(cuda):
    q = torch.zeros((2, tnt.MAX_B + 1, 16), device=cuda)
    y = torch.zeros((2, tnt.MAX_B + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows per client"):
        tnt.ntxent_loss(q, y)


# the joint step's global forms: (hparams, launches of one global
# iteration at C=3, S=2 on the reduced LeNet (1 client block, 2 server
# blocks): GEMMs, masked Adam, client Adam, NT-Xent forwards/backwards)
JOINT_FORMS = {
    "flat": (dict(server_grad_to_client=True), (1 + 1 + 2, 2, 2, 2)),
    "per_client": (dict(server_grad_to_client=True, flat_joint=False),
                   (1 + 1 + 2, 2, 2, 2)),
    "per_scalar_fused": (dict(server_grad_to_client=True,
                              mask_mode="per_scalar", fused_epilogue=True),
                         (1 + 1 + 2, 2, 2, 2)),
    "serialized": (dict(server_grad_to_client=True,
                        serialize_server_updates=True),
                   (1 + 2 * (1 + 2), 2, 1 + 2 * 2, 1 + 2)),
    "loop": (dict(server_grad_to_client=True, global_batch=False),
             (1 + 2 * (1 + 2), 2, 1 + 2 * 2, 1 + 2)),
}


@pytest.mark.parametrize("form", list(JOINT_FORMS))
def test_joint_iteration_on_card_matches_cpu_and_launches(cuda, form):
    """One global iteration of each joint form from one state on the card
    and on the CPU: equal selection, CE to 1e-4, state within the Adam
    sign-flip bound, the activation gradient billed down alike, and the
    kernels launched as the form's hparams say."""
    extra, (gemm, masked, client, nt) = JOINT_FORMS[form]
    cfg = dataclasses.replace(get_config("lenet-cifar"), image_size=16,
                              conv_channels=(4, 8, 8))
    clients = mixed_noniid(n_clients=3, n_per_client=16, n_test=8, seed=0)
    for c in clients:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    hp = AdaSplitHParams(rounds=1, eta=0.67, batch_size=8, round_scan=False,
                         **extra)
    gpu = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    cpu = AdaSplitTrainer(cfg, hp, clients, device="cpu")
    cpu.set_state(gpu.get_state())
    xs = np.stack([c.x[:8] for c in clients])
    ys = np.stack([c.y[:8] for c in clients])
    for m in (tcc, tma, tnt):
        m.reset_launches()
    sel_g, ce_g, _ = gpu.train_iteration(xs, ys, global_phase=True)
    key = "panel_gemm_bias_relu" if hp.fused_epilogue else "panel_gemm"
    assert (tcc.LAUNCHES[key], tma.LAUNCHES["masked_adam"],
            tma.LAUNCHES["client_adam"], tnt.LAUNCHES["ntxent_stats"],
            tnt.LAUNCHES["ntxent_backward"]) == (gemm, masked, client, nt,
                                                 nt)
    sel_c, ce_c, _ = cpu.train_iteration(xs, ys, global_phase=True)
    np.testing.assert_array_equal(sel_g, sel_c)
    np.testing.assert_allclose(ce_g, ce_c, rtol=1e-4)
    assert gpu.meter.bandwidth_bytes == cpu.meter.bandwidth_bytes
    off = total = 0
    for a, b in zip(tree_leaves(gpu.get_state()),
                    tree_leaves(cpu.get_state())):
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= 2.5 * hp.lr * 2
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total


def test_joint_client_adam_at_s_rows_bit_equal_to_plain(cuda):
    """The joint step's client Adam at lenet-cifar's published widths
    over S=19 selected rows, a step per row (one launch, the client
    order): bit-equal to its plain version on the card."""
    cfg = get_config("lenet-cifar")
    tr = AdaSplitTrainer(cfg, AdaSplitHParams(rounds=1), mixed_noniid(
        n_clients=19, n_per_client=1, n_test=1), device="cpu")
    gen = torch.Generator(device=cuda).manual_seed(3)
    shapes = [tuple(l.shape) for l in tree_leaves(
        {"c": tr.client_params, "p": tr.proj_params})]
    leaves = _adam_leaves(cuda, shapes, False, gen)
    step = torch.randint(1, 9, (19,), device=cuda, generator=gen,
                         dtype=torch.int32)
    b1t, b2t = tma.bias_corrections(step, 0.9, 0.999)
    before = tma.LAUNCHES["client_adam"]
    got = tma.adam_multi_cuda(leaves, b1t=b1t, b2t=b2t, client_order=True,
                              **KW)
    assert tma.LAUNCHES["client_adam"] == before + 1
    want = tma.adam_multi_plain(leaves, b1t=b1t, b2t=b2t, client_order=True,
                                **KW)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# streamed residency and the library conv on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "disk"])
def test_store_gathers_pinned_and_round_trips_cuda_rows(cuda, backend,
                                                        tmp_path):
    """On the card the stores gather into page-locked staging (the source
    of a non-blocking upload), and CUDA rows scattered back come out
    bit-equal, untouched rows intact."""
    from repro_torch.core.client_store import make_store
    c = 9
    gen = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn((c, 5, 3), generator=gen),
            "step": torch.arange(c, dtype=torch.int32)}
    store = make_store(backend, c, directory=str(tmp_path / "s"), pin=True)
    store.adopt({"g": tree})
    rows = np.asarray([7, 1, 4])
    got = store.gather(rows, ("g",))["g"]
    assert all(l.is_pinned() for l in tree_leaves(got))
    dev = {k: v.to(cuda, non_blocking=True) for k, v in got.items()}
    new = {"w": dev["w"] * 2 + 1, "step": dev["step"] + 3}
    store.scatter(rows, {"g": new})
    back = store.gather(np.arange(c), ("g",))["g"]
    for k in tree:
        want = tree[k].clone()
        want[torch.from_numpy(rows)] = new[k].cpu()
        assert torch.equal(back[k], want), k


@pytest.mark.parametrize("rung", [dict(), dict(epoch_scan=True)],
                         ids=["round", "epoch"])
def test_streamed_run_on_card_selects_and_bills_as_resident(cuda, rung):
    """A reduced streamed run (chunks of 3 of 4 clients, ragged) against
    its resident twin on the card: equal selections and protocol meters,
    host<->device bytes the resident bill plus the store's traffic, state
    within the Adam sign-flip bound."""
    cfg, clients = _small_lenet()
    kw = dict(rounds=3, kappa=0.34, eta=0.5, batch_size=8, **rung)
    runs = {}
    for name, extra in (("resident", {}),
                        ("streamed", dict(streamed=True, stream_chunk=3))):
        tr = AdaSplitTrainer(cfg, AdaSplitHParams(**kw, **extra), clients,
                             device="cuda")
        log, ingest = [], tr.orch.ingest_round
        tr.orch.ingest_round = lambda s, l, state=None, log=log, \
            ingest=ingest: (log.extend(np.array(s)),
                            ingest(s, l, state=state))
        tr.train(eval_every=100)
        runs[name] = (tr, log)
    (res, r_log), (st, s_log) = runs["resident"], runs["streamed"]
    assert st._streamed and len(s_log) == len(r_log) > 0
    for a, b in zip(s_log, r_log):
        np.testing.assert_array_equal(a, b)
    for f in ("bandwidth_bytes", "client_flops", "server_flops"):
        assert getattr(st.meter, f) == getattr(res.meter, f), f
    T = min(len(c.x) for c in clients) // 8
    n_local = int(round(kw["kappa"] * kw["rounds"]))
    assert st.meter.host_device_bytes == res.meter.host_device_bytes + (
        n_local * st._stream_store_bytes(T, False)
        + (kw["rounds"] - n_local) * st._stream_store_bytes(T, True))
    off = total = 0
    for a, b in zip(tree_leaves(st.get_state()),
                    tree_leaves(res.get_state())):
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= 2.5 * st.hp.lr * kw["rounds"] * T
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total


def test_conv_reference_on_card_makes_no_panel_gemm_launch(cuda):
    """``batched_conv=False`` trains and evaluates through the library
    conv alone: no launch of the panel-GEMM kernel, the Adam and NT-Xent
    kernels as usual."""
    cfg, clients = _small_lenet()
    tr = AdaSplitTrainer(cfg, AdaSplitHParams(rounds=2, kappa=0.5, eta=0.5,
                                              batch_size=8,
                                              batched_conv=False),
                         clients, device="cuda")
    tcc.reset_launches()
    tnt.reset_launches()
    tr.train(eval_every=1)
    torch.cuda.synchronize()
    assert tcc.LAUNCHES == {"panel_gemm": 0, "panel_gemm_bias_relu": 0}
    assert tnt.LAUNCHES["ntxent_stats"] > 0


@pytest.mark.parametrize("dtype,B,Hq,Hkv,hd", [
    (torch.bfloat16, 8, 32, 8, 128), (torch.float32, 3, 4, 4, 64)],
    ids=["jamba-bf16", "jamba-reduced-f32"])
def test_flash_attention_jamba_shapes_match_plain(cuda, dtype, B, Hq, Hkv,
                                                  hd):
    """jamba-v0.1-52b's attention layers at prefill: GQA 32/8, hd 128,
    bf16, B=8 S=512 (the session's shape), and its reduced config's 4/4
    at hd 64 in float32 (the card-vs-CPU check's)."""
    S = 512 if dtype == torch.bfloat16 else 12
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((B, S, h, hd), device=cuda, generator=gen)
               .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    before = tfa.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("arch,dtype", [("mamba2-370m", "bfloat16"),
                                        ("jamba-v0.1-52b", "float32")])
def test_ssm_prefill_and_decode_on_card_match_cpu(cuda, arch, dtype):
    """The reduced config (mamba2: a mamba layer a side; jamba: ``m a m
    a``) from the same params on the card and on the CPU: a prefill
    (jamba's attention layers one flash launch each) and two decode
    steps, the SSM state carried in place.  float32 logits within 1e-4
    of their largest magnitude, bf16 within 2e-2 (each bf16 product
    rounded on both devices, in other accumulation orders)."""
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    gpu = init_serve_params(cfg, 0, dtype, device="cuda")
    cpu = tree_map(lambda t: t.cpu(), gpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    tol = 1e-4 if dtype == "float32" else 2e-2

    def close(a, b):
        b = b.float()
        assert float((a.float().cpu() - b).abs().max()) <= \
            tol * float(b.abs().max())
    tfa.reset_launches()
    lg, cg = dec.prefill(cfg, gpu, toks.cuda(), cache_len=44)
    n_attn = sum(cfg.is_attn_layer(i) and cfg.n_heads > 0
                 for i in range(cfg.n_layers))
    assert tfa.LAUNCHES["flash_attention"] == n_attn
    lc, cc = dec.prefill(cfg, cpu, toks, cache_len=44)
    close(lg, lc)
    tok = lc.argmax(-1).to(torch.int32)
    for t in range(2):
        lg, cg = dec.decode_step(cfg, gpu, tok.cuda(), cg, 40 + t)
        lc, cc = dec.decode_step(cfg, cpu, tok, cc, 40 + t)
        close(lg, lc)
        tok = lc.argmax(-1).to(torch.int32)
    state = cg["server"][0]["0"]["mixer"]["state"]
    close(state, cc["server"][0]["0"]["mixer"]["state"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-370m"])
def test_moe_and_ssm_train_step_on_card_matches_cpu(cuda, arch):
    """One global train step of the reduced config (float32, C=2 cohorts
    of 4 rows) on the card and on the CPU from the same state: the
    losses and the router aux within 1e-4, the new moments within 1e-4
    of each leaf's largest magnitude; one NT-Xent forward and backward
    launch, the client Adam launches ``plan_launches`` predicts, no
    flash launch."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    C, b, S = 2, 4, 16
    pol = tsteps.LaunchPolicy(param_dtype="float32")
    fn = tsteps.build_train_step(cfg, InputShape("t", S, C * b, "train"),
                                 pol, n_cohorts=C)
    state = tsteps.init_train_state(cfg, C, pol, 0, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (C * b, S)),
             "labels": rng.integers(0, 512, (C * b, S)),
             "seq_class": np.repeat(np.arange(C), b),
             "select": np.array([1.0, 1.0], np.float32)}
    batch = {k: torch.from_numpy(np.asarray(v).astype(
        np.float32 if k == "select" else np.int32)) for k, v in batch.items()}
    cpu_state = tree_map(lambda t: t.cpu(), state)
    for m in (tma, tnt, tfa):
        m.reset_launches()
    new, mg = fn(state, {k: v.to(cuda) for k, v in batch.items()})
    want = {"ntxent_stats": 1, "ntxent_backward": 1, "flash_attention": 0,
            "client_adam": len(tma.plan_launches(
                [t.numel() for t in tree_leaves(state["trainables"])])),
            "masked_adam": 0}
    got = dict(tnt.LAUNCHES, **tma.LAUNCHES, **tfa.LAUNCHES)
    assert {k: got[k] for k in want} == want
    new_c, mc = fn(cpu_state, batch)
    for k in ("l_client", "ce", "aux"):
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4)
    assert (float(mc["aux"]) > 0) == bool(cfg.n_experts)
    for key in ("mu", "nu"):
        for a, c in zip(tree_leaves(new["opt"][key]),
                        tree_leaves(new_c["opt"][key])):
            scale = float(c.abs().max()) or 1.0
            assert float((a.cpu() - c).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("B,Hq,Hkv,hd,S,causal", [
    (8, 64, 8, 128, 1280, True), (8, 16, 16, 64, 1024, False),
    (8, 16, 16, 64, 1, True)],
    ids=["qwen2-vl-session", "seamless-encoder", "seamless-decoder-bos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_multimodal_shapes_match_plain(cuda, B, Hq, Hkv, hd,
                                                       S, causal, dtype):
    """The three prefill shapes the multimodal families give the kernel:
    qwen2-vl-72b's GQA 64/8 at hd 128 at its session's S = 1,280 (the
    patch prefix spliced), seamless-m4t-large-v2's encoder (16/16 at hd
    64, non-causal, S = 1,024) and its decoder's BOS prefill (S = 1).
    bf16 within 2e-2, f32 within 2e-5 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, hd), device=cuda, generator=gen)
               .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv))
    before = tfa.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_multimodal_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The reduced config in float32 from the same params on the card and
    on the CPU: a prefill with the modality inputs (16 patches at
    distinct (t, h, w) streams; 12 source frames whose cross-attention
    runs in the prefill and in each decode step) and two decode steps
    from position S; logits within 1e-4 of their largest magnitude, and
    one flash launch a self-attention layer on the card."""
    from repro_torch.launch.steps import init_serve_params
    from repro_torch.models import decode as dec
    from repro_torch.weights import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gpu = init_serve_params(cfg, 0, "float32", device="cuda")
    cpu = tree_map(lambda t: t.cpu(), gpu)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32))
    if cfg.is_encoder_decoder:
        ex = {"src_embeds": torch.from_numpy(
            rng.normal(0, 1, (B, 12, cfg.d_model)).astype(np.float32))}
        layers = cfg.n_layers + cfg.n_encoder_layers
    else:
        pos = np.concatenate([np.stack(np.meshgrid(
            [0], np.arange(4), np.arange(4), indexing="ij"), -1)
            .reshape(16, 3), 4 + np.arange(S - 16)[:, None].repeat(3, 1)])
        ex = {"vision_embeds": torch.from_numpy(
            rng.normal(0, 1, (B, 16, cfg.d_model)).astype(np.float32)),
              "positions": torch.from_numpy(
                  np.broadcast_to(pos, (B, S, 3)).astype(np.int32).copy())}
        layers = cfg.n_layers
    ex_gpu = {k: v.cuda() for k, v in ex.items()}

    def close(a, b):
        err = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-4, err
    before = tfa.LAUNCHES["flash_attention"]
    lg, cg = dec.prefill(cfg, gpu, toks.cuda(), ex_gpu, cache_len=S + 3)
    assert tfa.LAUNCHES["flash_attention"] == before + layers
    lc, cc = dec.prefill(cfg, cpu, toks, ex, cache_len=S + 3)
    close(lg, lc)
    for t in range(2):
        tok = lc.argmax(-1).to(torch.int32)
        lg, cg = dec.decode_step(cfg, gpu, tok.cuda(), cg, S + t)
        lc, cc = dec.decode_step(cfg, cpu, tok, cc, S + t)
        close(lg, lc)
