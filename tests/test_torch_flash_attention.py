"""Port parity: ``repro_torch.kernels.flash_attention``'s plain version
(what the wrapper runs on CPU tensors, and what the CUDA kernel is held
to on the card) against the reference's Pallas kernel in interpret mode
and against ``repro.models.attention.mha_einsum``.

Inputs are numpy arrays from a seed.  Tolerances: in float32 both sides
compute the same softmax in another summation order (1e-5 absolute on
outputs of order 1).  In bfloat16 the plain version and ``mha_einsum``
both compute in float32 and round the output once, so they may differ
by one bfloat16 step (2**-7 relative); the Pallas kernel also rounds its
probabilities to bfloat16 before the value product, which moves outputs
by up to ~1e-2.

Every case runs at head dim 64 (qwen2-0.5b) and, in the ``*_head_dims``
tests, at 96 (phi3-mini-3.8b) and 128 (olmo-1b, granite-3-8b), at the
same tolerances: the plain version has no head-dim limit, and its
scores divide by sqrt(hd) as the reference's do."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa

F32_ATOL = 1e-5


def _qkv(B, Hq, Hkv, S, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, h, S, hd)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


def _to(a, dtype):
    """numpy f32 -> (jnp array, torch tensor) of ``dtype``, same values."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(t.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), t


def _np(x):
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


PALLAS_SHAPES = pytest.mark.parametrize(
    "B,Hq,Hkv,S,block", [(2, 14, 2, 64, 32), (1, 4, 4, 48, 16)],
    ids=["gqa7", "mha"])
PALLAS_MASKS = pytest.mark.parametrize(
    "causal,window", [(True, 0), (False, 0), (True, 24)],
    ids=["causal", "full", "window"])
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
WIDE_HEAD_DIMS = pytest.mark.parametrize("hd", [96, 128],
                                         ids=["hd96", "hd128"])


def _plain_vs_pallas(B, Hq, Hkv, S, block, causal, window, dtype, hd):
    q, k, v = _qkv(B, Hq, Hkv, S, hd, seed=S + Hq)
    (jq, tq), (jk, tk), (jv, tv) = (_to(a, dtype) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=block, block_k=block, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, Hq, S, hd)
    atol = F32_ATOL if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@PALLAS_SHAPES
@PALLAS_MASKS
@DTYPES
def test_plain_matches_pallas_interpret(B, Hq, Hkv, S, block, causal, window,
                                        dtype):
    _plain_vs_pallas(B, Hq, Hkv, S, block, causal, window, dtype, 64)


@WIDE_HEAD_DIMS
@PALLAS_SHAPES
@PALLAS_MASKS
@DTYPES
def test_plain_matches_pallas_interpret_head_dims(B, Hq, Hkv, S, block,
                                                  causal, window, dtype, hd):
    _plain_vs_pallas(B, Hq, Hkv, S, block, causal, window, dtype, hd)


def _einsum_ref(q, k, v, *, causal, window, kv_len, jdtype):
    """mha_einsum in its (B, S, H, hd) layout, kv_len as a prefix
    kv_valid mask; back in the kernel's (B, H, S, hd) layout."""
    S = q.shape[2]
    kv_valid = None if kv_len is None else \
        jnp.arange(S)[None, :] < jnp.asarray(kv_len)[:, None]
    tr = lambda a: jnp.asarray(a).astype(jdtype).transpose(0, 2, 1, 3)
    out = jattn.mha_einsum(tr(q), tr(k), tr(v), causal=causal,
                           window=window, kv_valid=kv_valid)
    return np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)


EINSUM_SHAPES = pytest.mark.parametrize(
    "B,Hq,Hkv,S", [(3, 14, 2, 50), (2, 4, 4, 77), (1, 14, 2, 1)],
    ids=["gqa7-S50", "mha-S77", "S1"])
EINSUM_MASKS = pytest.mark.parametrize("causal,window,ragged", [
    (True, 0, False), (True, 0, True), (False, 0, True), (True, 7, False),
    (False, 9, False)],
    ids=["causal", "causal-ragged", "full-ragged", "window", "full-window"])


@EINSUM_SHAPES
@EINSUM_MASKS
@DTYPES
def test_plain_matches_mha_einsum(B, Hq, Hkv, S, causal, window, ragged,
                                  dtype):
    """Ragged S (no tile divides it) and right-padded rows: kv_len =
    last_index + 1 reproduces mha_einsum with the prefix kv_valid mask,
    pad query rows included."""
    _plain_vs_einsum(B, Hq, Hkv, S, causal, window, ragged, dtype, 64)


@WIDE_HEAD_DIMS
@EINSUM_SHAPES
@EINSUM_MASKS
@DTYPES
def test_plain_matches_mha_einsum_head_dims(B, Hq, Hkv, S, causal, window,
                                            ragged, dtype, hd):
    _plain_vs_einsum(B, Hq, Hkv, S, causal, window, ragged, dtype, hd)


def _plain_vs_einsum(B, Hq, Hkv, S, causal, window, ragged, dtype, hd):
    q, k, v = _qkv(B, Hq, Hkv, S, hd, seed=S)
    kv_len = np.random.default_rng(S).integers(1, S + 1, B).astype(
        np.int32) if ragged else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _einsum_ref(q, k, v, causal=causal, window=window, kv_len=kv_len,
                       jdtype=jdt)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = tfa.flash_attention(
        tq, tk, tv, causal=causal, window=window,
        kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7,
                                   atol=2 ** -8)


def test_rows_that_see_no_key_are_zero():
    """With kv_len and a window a pad query row can see no key at all:
    both versions output zeros there (mha_einsum's softmax over all-masked
    scores averages every key instead); every other row equals
    mha_einsum."""
    B, Hq, Hkv, S, window = 2, 14, 2, 40, 8
    q, k, v = _qkv(B, Hq, Hkv, S, seed=5)
    kv_len = np.array([10, 40], np.int32)
    want = _einsum_ref(q, k, v, causal=True, window=window, kv_len=kv_len,
                       jdtype=jnp.float32)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window,
                              kv_len=torch.from_numpy(kv_len)).numpy()
    blind = np.arange(S) - window >= kv_len[:, None] - 1     # (B, S)
    assert blind.sum() == S - 10 - window + 1
    np.testing.assert_array_equal(got.transpose(0, 2, 1, 3)[blind], 0.0)
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[~blind],
                               want.transpose(0, 2, 1, 3)[~blind], rtol=0,
                               atol=F32_ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 14, 2, 16))
    before = dict(tfa.LAUNCHES)
    out = tfa.flash_attention(q, k, v)
    assert tfa.LAUNCHES == before
    torch.testing.assert_close(out, tfa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 14, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
