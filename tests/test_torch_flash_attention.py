"""The port's blocked flash attention against the JAX package: the plain
version against JAX's ``attention_ref``, ``ops.attention`` against
JAX's, and the wrapper's refusal of causal Sq > Sk.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: 1e-5 in fp32 (the same fp32 arithmetic, summed in another
order), 2e-2 in bf16 (fp32 results rounded to bf16 in both: one ulp).
The CUDA kernel's bf16 rounding (P rounded to bf16 before P @ V), written
out in torch, is held to the plain version at 2e-2, the tolerance the
kernel is held to on the card.
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_bf16_p_before_pv_stays_within_tolerance():
    """The bf16 body's rounding at chip_smoke.py's 512 x 2048 causal
    shape (tinyllama-1.1b's heads, randn inputs): fp32 scores scaled by
    1/sqrt(D), the bottom-right mask, fp32 p = exp(s - max) and l =
    sum(p), p rounded to bf16 before P @ V with fp32 sums, then divided
    by l and rounded to bf16."""
    B, Sq, Sk, H, Hk, D = 1, 512, 2048, 32, 4, 64
    _, (q, k, v) = _inputs(B, Sq, Sk, H, Hk, D, "bfloat16", seed=5)
    rep = H // Hk
    mask = torch.ones(Sq, Sk, dtype=torch.bool).tril(Sk - Sq)
    out = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
    for g in range(Hk):  # one kv head's query heads at a time
        qg = q[0, :, g * rep:(g + 1) * rep].float().transpose(0, 1)
        s = qg @ k[0, :, g].float().T * (1.0 / D ** 0.5)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (p.bfloat16().float() @ v[0, :, g].float()) / p.sum(-1, True)
        out[0, :, g * rep:(g + 1) * rep] = o.transpose(0, 1).bfloat16()
    tol = TOL["bfloat16"]
    torch.testing.assert_close(out.float(), attention_ref(
        q, k, v, causal=True).float(), atol=tol, rtol=tol)
