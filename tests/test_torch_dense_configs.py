"""Port parity on the dense configs with head dims 96 and 128:
``granite-3-8b`` (GQA 32/8, hd 128), ``phi3-mini-3.8b`` (32/32, hd 96)
and ``olmo-1b`` (16/16, hd 128, non-parametric LayerNorm), against the
JAX package.

The configs themselves are compared at full size.  The model runs at
``dataclasses.replace(cfg.reduced(), head_dim=cfg.head_dim,
n_kv_heads=...)``: the reduced widths (2 layers, d_model 256, 4 heads,
d_ff 512, vocab 512) with the published head dim, and granite kept GQA
(4 query heads over 2 kv heads).  The reference's own params cross over
through numpy (``weights.from_numpy``), tokens and masks are numpy draws
from a seed, and JAX runs on the CPU as its own tests run it.
Tolerances are ``tests/test_torch_lm.py``'s ``TOL``, for the same
reasons (same f32 math in other orders; bf16 roundings that may land on
either side of a tie).

The long-sequence path: above S = 2048 (S % 256 == 0, no key mask) the
reference's ``attn_forward`` takes ``mha_chunked``, which rounds q, k,
v and P to bf16.  Its chunks are min(1024, S), and its assertion that
S is a multiple of them fails at S = 2304; the port takes blocks of
gcd(S, 1024), so at 2304 the port is held to the reference's own
``attn_forward`` with its ``mha_chunked`` called at 256-blocks, and at
3072 to the reference as it is.  Tolerance there: both sides round P
to bf16 before the value product (and, in ``attn_forward``, the f32
projections to bf16), and a value one f32 ulp apart on the two sides
(another exp, another summation order) may round to the neighbouring
bf16 value, 2**-8 away; so outputs are held to 2e-3 of their largest
magnitude (about half a bf16 step; the differences seen are under
3e-4, on outputs up to ~3.4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core import masks as tmasks
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch.steps import _cast_leaf, init_serve_params
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import transformer as ttfm
from repro_torch.weights import from_numpy, to_numpy, tree_leaves, tree_map

B, S, N_CLIENTS = 3, 12, 3
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
ARCHS = ("granite-3-8b", "phi3-mini-3.8b", "olmo-1b")
# kv heads at the reduced width: granite stays grouped, the others MHA
KV_HEADS = {"granite-3-8b": 2, "phi3-mini-3.8b": 4, "olmo-1b": 4}
CHUNK_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on this box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _narrow(get, arch, dtype="float32"):
    """The reduced config at the published head dim (and kv heads)."""
    cfg = get(arch)
    return dataclasses.replace(cfg.reduced(), head_dim=cfg.head_dim,
                               n_kv_heads=KV_HEADS[arch], dtype=dtype)


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(dtype, jax cfg, torch cfg, jax params, torch params, jax masks,
    torch masks) for one arch and compute dtype."""
    arch, dtype = request.param
    jcfg, tcfg = _narrow(jget_config, arch, dtype), \
        _narrow(get_config, arch, dtype)
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    tp = from_numpy(_np_tree(jp), "cpu")
    rng = np.random.default_rng(9)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    tm = from_numpy(_np_tree(jm), "cpu")
    return dtype, jcfg, tcfg, jp, tp, jm, tm


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_logits(got, want, dtype):
    """Within ``rel`` of the largest magnitude (reduced vocab = padded
    vocab, so no -1e9 pad column enters the scale)."""
    rel, _ = TOL[dtype]
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _close_caches(got, want, dtype):
    _, atol = TOL[dtype]
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(_np_tree(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   rtol=0 if dtype == "float32" else atol,
                                   atol=atol)


def _plan(plan):
    return [tuple((d.mixer, d.ffn, d.cross, d.causal) for d in s.body)
            + (s.n_rep,) for s in plan]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("narrow", [False, True], ids=["full", "narrow"])
def test_config_matches_reference(arch, narrow):
    """Every field, the split, the padded vocabulary, the parameter
    counts and the segment plans, at full size and at the tests' narrow
    size; ``reduced()`` stays the reference's (hd 64)."""
    j, t = jget_config(arch), get_config(arch)
    if narrow:
        j, t = _narrow(jget_config, arch), _narrow(get_config, arch)
    assert t.reduced().head_dim == j.reduced().head_dim == 64
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.split_layer, t.padded_vocab(), t.param_count(),
            t.active_param_count()) == \
        (j.split_layer, j.padded_vocab(), j.param_count(),
         j.active_param_count())
    for side in ("client_segments", "server_segments"):
        assert _plan(ttfm.model_plan(t)[side]) == \
            _plan(jtfm.model_plan(j)[side])


# the registered LM archs beyond this file's dense three
OTHER_ARCHS = ("qwen2-0.5b", "deepseek-moe-16b", "qwen3-moe-30b-a3b",
               "mamba2-370m", "jamba-v0.1-52b", "qwen2-vl-72b",
               "seamless-m4t-large-v2")


def test_list_archs_is_the_registered_set_of_nine():
    """The registered LM archs (nine until the vision-text and
    encoder-decoder configs joined them: eleven), the reference's
    list."""
    from repro.configs.base import list_archs as jlist_archs
    assert list_archs() == sorted(ARCHS + OTHER_ARCHS) == jlist_archs()
    assert list_archs(include_paper=True) == sorted(
        ARCHS + OTHER_ARCHS + ("lenet-cifar",))
    assert get_config("lenet-cifar").param_count() == \
        jget_config("lenet-cifar").param_count()


def test_serve_cli_takes_the_registered_archs():
    """olmo-1b and the two multimodal archs, reduced, through the CLI (the
    encoder-decoder's source frames drawn by the CLI); an unknown name is
    refused."""
    from repro_torch.launch import serve as tserve
    for arch in ("olmo-1b", "qwen2-vl-72b", "seamless-m4t-large-v2"):
        out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen",
                           "2", "--fold-mask"])
        assert out.shape == (2, 2)
        assert ((out >= 0) & (out < get_config(arch).vocab_size)).all()
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen2-vl-7b", "--device", "cpu"])


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_prefill_logits_and_caches(model, ragged):
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 1)
    last = np.array([S - 1, 4, 8], np.int32) if ragged else None
    want, wcache = jdec.prefill(
        jcfg, jp, jnp.asarray(toks), cache_len=S + 4,
        last_index=None if last is None else jnp.asarray(last))
    tfa.reset_launches()
    got, gcache = tdec.prefill(
        tcfg, tp, torch.from_numpy(toks), cache_len=S + 4,
        last_index=None if last is None else torch.from_numpy(last))
    assert tfa.LAUNCHES["flash_attention"] == 0      # CPU: plain version
    assert got.shape == (B, 1, tcfg.padded_vocab())
    _close_logits(got, want, dtype)
    _close_caches(gcache, wcache, dtype)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_decode_step_teacher_forced(model, pos_kind):
    """Two decode steps from the reference's own prefill cache, fed the
    same tokens on both sides."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 2)
    lens = np.array([S, 5, 9], np.int32) if pos_kind == "per_slot" else \
        np.full(B, S, np.int32)
    last = jnp.asarray(lens - 1) if pos_kind == "per_slot" else None
    _, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), cache_len=S + 4,
                             last_index=last)
    tcache = from_numpy(_np_tree(jcache), "cpu")
    nxt = _tokens(jcfg, 3, (2, B, 1))
    for t in range(2):
        if pos_kind == "scalar":
            jpos, tpos = jnp.asarray(S + t, jnp.int32), S + t
        else:
            jpos, tpos = jnp.asarray(lens + t), torch.from_numpy(lens + t)
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(nxt[t]),
                                        jcache, jpos)
        got, tcache = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt[t]),
                                       tcache, tpos)
        _close_logits(got, want, dtype)
        _close_caches(tcache, jcache, dtype)


def test_gated_prefill_and_decode_per_example(model):
    """Per-example gates (three clients in one batch) through a prefill
    and a decode step; olmo's norms have no params, so its gates are the
    heads and ffn units alone."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    clients = [2, 0, 2]
    jg = jmasks.expand_gates(jm, jnp.asarray(clients))
    tg = tmasks.expand_gates(tm, clients)
    for a, b in zip(tree_leaves(to_numpy(tg)), jax.tree.leaves(jg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    toks = _tokens(jcfg, 6)
    want, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), gates=jg,
                                cache_len=S + 2)
    got, tcache = tdec.prefill(tcfg, tp, torch.from_numpy(toks), gates=tg,
                               cache_len=S + 2)
    _close_logits(got, want, dtype)
    nxt = _tokens(jcfg, 7, (B, 1))
    want, _ = jdec.decode_step(jcfg, jp, jnp.asarray(nxt), jcache,
                               jnp.asarray(S, jnp.int32), gates=jg)
    got, _ = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt), tcache, S,
                              gates=tg)
    _close_logits(got, want, dtype)


def test_fold_unit_masks(model):
    """Folding a client's masks into the server weights, bit for bit as
    the reference folds them (olmo: the empty norm dicts pass through)."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    want = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 2)
    got = tmasks.fold_unit_masks(tcfg, tp["server"], tm, 2)
    w, g = jax.tree.leaves(_np_tree(want)), tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(
            a.to(torch.float32).numpy(), np.asarray(b, np.float32))
    if tcfg.norm == "nonparam_ln":
        layer = got["segments"][0][0]
        assert layer["norm1"] == {} and layer["norm2"] == {}
        assert got["final_norm"] == {}


# ---------------------------------------------------------------------------
# the long-sequence path (S > 2048)
# ---------------------------------------------------------------------------


def _attn_inputs(arch, S_, seed=0, batch=1):
    """f32 narrow config, one attention layer's params (the reference's
    init, through numpy) and (batch, S_, d) activations."""
    jcfg, tcfg = _narrow(jget_config, arch), _narrow(get_config, arch)
    jp = jattn.attention_init(jax.random.PRNGKey(seed), jcfg)
    tp = from_numpy(_np_tree(jp), "cpu")
    x = np.random.default_rng(seed).normal(
        size=(batch, S_, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S_, dtype=np.int32), (batch, 1))
    return jcfg, tcfg, jp, tp, x, pos


@pytest.mark.parametrize("hd", [96, 128], ids=["hd96", "hd128"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)],
                         ids=["causal", "window", "full"])
def test_mha_chunked_matches_reference(hd, causal, window):
    """The port's ``mha_chunked`` on the reference's ``mha_chunked``, the
    same bf16-valued inputs, S = 2304 in 256-blocks, GQA 4/2, f32."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.normal(size=(1, 2304, h, hd)).astype(np.float32)
               for h in (4, 2, 2))
    q, k, v = (np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                          .to(torch.float32)) for a in (q, k, v))
    want = jattn.mha_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, window=window, q_chunk=256,
                             kv_chunk=256)
    got = tattn.mha_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, q_chunk=256,
                            kv_chunk=256)
    assert got.dtype == torch.float32 and got.shape == (1, 2304, 4, hd)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=CHUNK_TOL * np.abs(want).max())


def _close_attn(got, want):
    (o, (k, v)), (jo, (jk, jv)) = got, want
    for a, b in ((o, jo), (k, jk), (v, jv)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=CHUNK_TOL * np.abs(b).max())


@pytest.mark.parametrize("arch", ["granite-3-8b", "phi3-mini-3.8b"])
def test_attn_forward_at_2304_takes_the_chunked_path(arch, monkeypatch):
    """S = 2304: the port's ``attn_forward`` (chunked, bf16 rounding) on
    the reference's, whose own 1024-chunks do not divide S (its
    assertion fails); run at 256-blocks, it is what the port computes."""
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs(arch, 2304)
    with pytest.raises(AssertionError):
        jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos))
    ref_chunked, port_chunked, called = jattn.mha_chunked, \
        tattn.mha_chunked, []

    def ref_256(q, k, v, *, causal, window, q_chunk, kv_chunk):
        return ref_chunked(q, k, v, causal=causal, window=window,
                           q_chunk=256, kv_chunk=256)

    def port_logged(*a, **kw):
        called.append((kw["q_chunk"], kw["kv_chunk"]))
        return port_chunked(*a, **kw)
    monkeypatch.setattr(jattn, "mha_chunked", ref_256)
    monkeypatch.setattr(tattn, "mha_chunked", port_logged)
    want = jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos))
    got = tattn.attn_forward(tp, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos))
    assert called == [(256, 256)]
    _close_attn(got, want)



def test_attn_forward_at_3072_matches_reference_as_it_is():
    """S = 3072: the reference's 1024-chunks divide S, and the port's
    blocks are the same."""
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs("olmo-1b", 3072)
    want = jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos))
    got = tattn.attn_forward(tp, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos))
    _close_attn(got, want)


@pytest.mark.parametrize("S_,kv_len,chunked", [
    (2048, None, False), (2100, None, False), (2304, [2304, 1000], False),
    (2560, None, True)], ids=["S2048", "S2100", "S2304-kv_len", "S2560"])
def test_attn_forward_routes(S_, kv_len, chunked, monkeypatch):
    """Which path ``attn_forward`` takes: the flash wrapper (the plain
    version on the CPU) at S <= 2048, at S % 256 != 0 and with a key
    mask; ``mha_chunked`` otherwise, as the reference chooses."""
    _, tcfg, _, tp, x, pos = _attn_inputs("granite-3-8b", S_, batch=2)
    seen = {"flash": 0, "chunked": 0}
    flash, mha_chunked = tattn.flash_attention, tattn.mha_chunked

    def count(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tattn, "flash_attention", count("flash", flash))
    monkeypatch.setattr(tattn, "mha_chunked", count("chunked", mha_chunked))
    out, _ = tattn.attn_forward(
        tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        kv_len=None if kv_len is None else torch.tensor(kv_len,
                                                        dtype=torch.int32))
    assert out.shape == (2, S_, tcfg.d_model)
    assert seen == {"flash": int(not chunked), "chunked": int(chunked)}


def test_attn_forward_at_2048_is_the_flash_path_unchanged():
    """At S = 2048 (f32) the port's flash path equals the reference's
    einsum path to float32 rounding, and no bf16 rounding enters."""
    jcfg, tcfg, jp, tp, x, pos = _attn_inputs("granite-3-8b", 2048)
    (jo, _) = jattn.attn_forward(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos))
    out, _ = tattn.attn_forward(tp, torch.from_numpy(x), tcfg,
                                positions=torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jo)).max())


# ---------------------------------------------------------------------------
# the serving init, leaf by leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-0.5b", "bfloat16"), ("qwen2-0.5b", "float32"),
    ("deepseek-moe-16b", "bfloat16"), ("deepseek-moe-16b", "float32")],
    ids=["bfloat16", "float32", "moe-bfloat16", "moe-float32"])
def test_init_serve_params_leaf_by_leaf_equals_whole_tree_cast(arch, dtype):
    """Casting each weight as it is drawn (a stacked expert leaf one
    ``n_rep`` row at a time) gives, bit for bit, what drawing the whole
    float32 tree and casting it after gives (reduced qwen2, and reduced
    deepseek with its dense first layer and a two-layer MoE segment,
    seed 0): same keys, dtypes and values."""
    cfg = get_config(arch).reduced()
    if arch == "deepseek-moe-16b":
        cfg = dataclasses.replace(cfg, first_k_dense=1, n_layers=3)
    gen = torch.Generator(device="cpu").manual_seed(0)
    whole = {"client": ttfm.init_client_params(cfg, gen),
             "server": ttfm.init_server_params(cfg, gen)}
    dt = getattr(torch, dtype)
    want = tree_map(lambda t: _cast_leaf(t, dt), whole)
    got = init_serve_params(cfg, 0, dtype, device="cpu")
    w, g = tree_leaves(want), tree_leaves(got)
    assert len(w) == len(g)
    assert tree_map(lambda t: None, want) == tree_map(lambda t: None, got)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {a.dtype for a in g} == {torch.float32, dt}
