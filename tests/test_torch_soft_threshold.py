"""Port parity: ``repro_torch.kernels.soft_threshold`` (the L1 proximal
operator ``sign(x) * max(|x| - t, 0)``) and the port's
``ops.soft_threshold`` against the JAX package's Pallas kernel in
interpret mode and its oracle ``ref.soft_threshold_ref``.

Both sides compute in float32 with the same two roundings (``|x| - t``,
then an exact sign product) and round to x's dtype to nearest-even, so
the results are bit-equal in float32 and in bfloat16, signed zeros
included.  Shapes with and without a multiple of 256 elements (the TPU
kernel's panel width)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import soft_threshold as tst

SHAPES = [(4, 256), (512,), (2, 3, 256), (5, 37), (1000,), (2, 3, 5, 7)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits(a):
    """float32 or bfloat16 values as integer bit patterns (bf16 widened
    to float32 first, which is exact)."""
    if torch.is_tensor(a):
        a = a.to(torch.float32).numpy()
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("t", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_soft_threshold_bit_equal_to_reference(shape, dtype, t):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(jdt)
    plain = tst.soft_threshold_plain(x, t)
    via_ops = tops.soft_threshold(x, t)
    assert plain.dtype == via_ops.dtype == tdt
    assert tuple(plain.shape) == shape
    for want in (jops.soft_threshold(xj, t), jref.soft_threshold_ref(xj, t)):
        np.testing.assert_array_equal(_bits(plain), _bits(want))
        np.testing.assert_array_equal(_bits(via_ops), _bits(want))


def test_soft_threshold_special_values_match_reference():
    x = np.array([np.nan, np.inf, -np.inf, 0.0, 1e-3, -2.5, 0.5, -0.5],
                 np.float32)
    got = tops.soft_threshold(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.soft_threshold_ref(jnp.asarray(x), 0.5)))


def test_cpu_tensors_take_the_plain_version_and_cuda_wrapper_refuses_them():
    x = torch.ones((3, 5))
    tst.reset_launches()
    tst.soft_threshold(x, 0.5)
    assert tst.LAUNCHES["soft_threshold"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        tst.soft_threshold_cuda(x, 0.5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tst.soft_threshold_cuda(x.to(torch.float16), 0.5)
