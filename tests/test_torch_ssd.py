"""The port's SSD chunk scan against the JAX package: the plain
recurrence against JAX's ``ssd_scan_ref`` and against the Pallas
``ssd_scan`` in interpret mode, and ``ops.ssd`` against JAX's.

Inputs are made with numpy from a seed (the magnitudes of the JAX
suite's ``test_ssd_scan``) and handed to both frameworks.  Tolerances:

* against ``ssd_scan_ref``: 1e-5 in fp32 (the same step-by-step
  recurrence, products summed in another order); 2e-2 on bf16 outputs
  (one bf16 ulp: the fp32 results round to bf16 in both), 1e-5 on the
  fp32 state;
* against the Pallas kernel: five times the JAX suite's attention
  tolerances (1e-4 fp32, 1e-1 bf16), as that suite holds the kernel to
  ``ssd_scan_ref`` — a chunked form against the recurrence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as jax_ops  # noqa: E402
from repro.kernels.ssd_scan.ref import \
    ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import \
    ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan  # noqa: E402

TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = {"float32": 1e-4, "bfloat16": 1e-1}


def _inputs(BH, S, P, N, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, S, P)).astype(np.float32) * 0.1,
            -np.abs(rng.standard_normal((BH, S))).astype(np.float32) * 0.1,
            rng.standard_normal((BH, S, N)).astype(np.float32) * 0.3,
            rng.standard_normal((BH, S, N)).astype(np.float32) * 0.3)


def _both(arrays, dtype):
    return ([jnp.asarray(x).astype(getattr(jnp, dtype)) for x in arrays],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (4, 256, 64, 32, 64), (2, 128, 32, 16, 128), (1, 512, 64, 64, 128)])
def test_plain_ssd_scan_matches_jax(BH, S, P, N, chunk, dtype):
    j, t = _both(_inputs(BH, S, P, N), dtype)
    y, st = ssd_scan_ref(*t)
    assert y.dtype == t[0].dtype and y.shape == (BH, S, P)
    assert st.dtype == torch.float32 and st.shape == (BH, P, N)
    yr, sr = jax_ssd_ref(*j)
    _close(y, yr, TOL_REF[dtype])
    _close(st, sr, 1e-5)
    yp, sp = pallas_ssd(*j, chunk=chunk, interpret=True)
    _close(y, yp, TOL_PALLAS[dtype])
    _close(st, sp, TOL_PALLAS[dtype])
    # the wrapper on CPU tensors runs the plain version
    y2, st2 = ssd_scan(*t, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_op_matches_jax(dtype):
    BH, S, P, N = 3, 96, 32, 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((BH, S)))) * 0.1
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal(BH)).astype(np.float32)
    b = rng.standard_normal((BH, S, N)).astype(np.float32) * 0.3
    c = rng.standard_normal((BH, S, N)).astype(np.float32) * 0.3
    j, t = _both((x, dt, A, b, c), dtype)
    yr, sr = jax_ops.ssd(*j, chunk=32)
    y, st = ops.ssd(*t, chunk=32)
    _close(y, yr, TOL_REF[dtype])
    _close(st, sr, 1e-5 if dtype == "float32" else TOL_REF[dtype])
    x_, dt_, A_, b_, c_ = t
    y2, _ = ssd_scan_ref(x_ * dt_[..., None], dt_ * A_[:, None], b_, c_)
    assert torch.equal(y2, y)


def test_ssd_scan_chunk_contract():
    t = [torch.zeros(1, 96, 32), torch.zeros(1, 96), torch.zeros(1, 96, 16),
         torch.zeros(1, 96, 16)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(*t, chunk=64)
