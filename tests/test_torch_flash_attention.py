"""The port's blocked flash attention against the JAX package: the plain
version against JAX's ``attention_ref``, ``ops.attention`` against
JAX's, and the wrapper's refusal of causal Sq > Sk.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: 1e-5 in fp32 (the same fp32 arithmetic, summed in another
order), 2e-2 in bf16 (fp32 results rounded to bf16 in both: one ulp).
The causal mask is aligned bottom-right in both references.  The Pallas
``flash_attention`` is not called: its body does not trace on the
installed jax (``pl.load``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, H, Hk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
              rng.standard_normal((B, Sk, Hk, D)).astype(np.float32),
              rng.standard_normal((B, Sk, Hk, D)).astype(np.float32))
    return ([jnp.asarray(x).astype(getattr(jnp, dtype)) for x in arrays],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,D,causal", [
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 384, 8, 8, 128, False),
    (2, 256, 256, 4, 1, 64, True),   # MQA
    (1, 512, 512, 2, 2, 128, True),
    (1, 128, 384, 4, 2, 64, True),   # causal, Sq < Sk: bottom-right
])
def test_plain_attention_matches_jax_ref(B, Sq, Sk, H, Hk, D, causal,
                                         dtype):
    j, t = _inputs(B, Sq, Sk, H, Hk, D, dtype)
    got = attention_ref(*t, causal=causal)
    assert got.dtype == t[0].dtype and got.shape == (B, Sq, H, D)
    _close(got, jax_attention_ref(*j, causal=causal), dtype)
    # the wrapper on CPU tensors runs the plain version
    assert torch.equal(flash_attention(*t, causal=causal), got)


def test_attention_op_matches_jax():
    j, t = _inputs(1, 128, 256, 8, 2, 64, "float32", seed=3)
    for causal in (True, False):
        _close(ops.attention(*t, causal=causal),
               jax_ops.attention(*j, causal=causal), "float32")
        assert torch.equal(ops.attention(*t, causal=causal),
                           attention_ref(*t, causal=causal))


def test_flash_attention_refuses_causal_with_more_queries_than_keys():
    _, t = _inputs(1, 256, 128, 4, 2, 64, "float32")
    with pytest.raises(ValueError, match="no key"):
        flash_attention(*t, causal=True)
    # the plain version leaves those rows without a key (NaN), as JAX's
    assert torch.isnan(attention_ref(*t, causal=True)[:, :128]).all()
    out = flash_attention(*t, causal=False)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="multiples of block_q"):
        flash_attention(*t, causal=False, block_q=96)
