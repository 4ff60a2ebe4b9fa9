"""The port's SSD chunk scan against the JAX package: the plain
recurrence against JAX's ``ssd_scan_ref`` and against the Pallas
``ssd_scan`` in interpret mode, and ``ops.ssd`` against JAX's; the CUDA
kernel's three-pass split (chunk states, state pass, chunk outputs, with
its bf16 rounding points) written out in torch against both, and its
launch plan ``ssd_plan``; and the relative check the card's SSD checks
add to the tolerances below, with a planted fault it must reject.

Inputs are made with numpy from a seed (the magnitudes of the JAX
suite's ``test_ssd_scan``) and handed to both frameworks.  Tolerances:

* against ``ssd_scan_ref``: 1e-5 in fp32 (the same step-by-step
  recurrence, products summed in another order); 2e-2 on bf16 outputs
  (one bf16 ulp: the fp32 results round to bf16 in both), 1e-5 on the
  fp32 state;
* against the Pallas kernel: five times the JAX suite's attention
  tolerances (1e-4 fp32, 1e-1 bf16), as that suite holds the kernel to
  ``ssd_scan_ref`` — a chunked form against the recurrence;
* relative, per head (``REL``): ||out - ref|| / ||ref|| over each head's
  outputs and over its state, at most 1e-2 in bf16 and 1e-5 in fp32.
  The absolute tolerances above exceed typical values at small inputs;
  this one scales with them.  At full width on an H100 the bf16 kernel
  reads at most 3.1e-3 (``chip_smoke.py``), and 7.9e-2 or more when
  handed a shifted by one position (what a cumsum shifted by one
  computes), the control that ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` repeat on the card and that
  ``test_relative_check_rejects_a_shifted_decay`` repeats here.
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
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    STATE_THREADS, TILE, ssd_plan, ssd_scan)

TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = {"float32": 1e-4, "bfloat16": 1e-1}
REL = {"float32": 1e-5, "bfloat16": 1e-2}


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


def _rel(got, want):
    """The largest ||got - want|| / ||want|| over the heads (dim 0)."""
    g = got.float().flatten(1)
    w = torch.from_numpy(np.array(want, np.float32)).flatten(1)
    return ((g - w).norm(dim=1) / w.norm(dim=1)).max().item()


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


# The kernel's three-pass split (csrc/ssd_scan.cu), written out in torch
# on the CPU: chunk states, the state pass over chunks, chunk outputs per
# query tile, passes 1 and 2 walking the blocks of ``ssd_plan``, and with
# the bf16 bodies' rounding points (the decayed xdt, h_in, the masked scores).
# It is held against JAX's recurrence and the interpret-mode Pallas kernel
# with the tolerances above: the split computes the same function.

def _split_model(xdt, a, b, c, chunk):
    bf16 = xdt.dtype == torch.bfloat16
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    x, a, b, c = (t.float() for t in (xdt, a, b, c))
    BH, S, P = x.shape
    N = b.shape[2]
    plan = ssd_plan(BH, S, P, N, chunk, bf16)
    nc, Q = plan.chunks, chunk
    states = torch.empty(plan.states)
    cum = torch.empty(BH, S)
    for blk in range(plan.grids[0]):  # pass 1: one block per (bh, chunk)
        ch, bh = blk % nc, blk // nc
        rows = slice(ch * Q, (ch + 1) * Q)
        cm = torch.cumsum(a[bh, rows], 0)
        cum[bh, rows] = cm
        xd = rnd(x[bh, rows] * torch.exp(cm[-1] - cm)[:, None])
        states[bh, ch] = xd.T @ b[bh, rows]
    h = torch.zeros(BH, P, N)  # pass 2: h_in[c] = h, h = g h + s_c
    h_in = torch.empty(plan.states)
    for ch in range(nc):
        h_in[:, ch] = h
        h = torch.exp(cum[:, ch * Q + Q - 1])[:, None, None] * h \
            + states[:, ch]
    h_in = rnd(h_in)
    y = torch.full((BH, S, P), float("nan"))
    tiles = [(bh, ch, qt * TILE) for bh in range(BH) for ch in range(nc)
             for qt in range(plan.query_tiles)]
    assert len(tiles) == plan.grids[2]
    for bh, ch, i0 in tiles:  # pass 3: one block per query tile
        r = torch.arange(i0, min(i0 + TILE, Q))
        k = torch.arange(0, min(i0 + TILE, Q))
        cm = cum[bh, ch * Q:(ch + 1) * Q]
        keep = k[None, :] <= r[:, None]
        diff = torch.where(keep, cm[r][:, None] - cm[k][None, :], 0.)
        cq = c[bh, ch * Q + r]
        scores = rnd(torch.where(keep, (cq @ b[bh, ch * Q + k].T)
                                 * torch.exp(diff), 0.))
        y[bh, ch * Q + r] = scores @ x[bh, ch * Q + k] \
            + torch.exp(cm[r])[:, None] * (cq @ h_in[bh, ch].T)
    return y.to(xdt.dtype), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 32, 64, 128),  # one chunk, two query tiles
    (2, 192, 16, 128, 64),  # three chunks
    (1, 256, 32, 64, 16),  # sixteen chunks
    (1, 288, 48, 128, 96)])  # three chunks, a partial query tile
def test_split_model_matches_jax(BH, S, P, N, chunk, dtype):
    j, t = _both(_inputs(BH, S, P, N, seed=7), dtype)
    y, st = _split_model(*t, chunk)
    assert y.dtype == t[0].dtype and not torch.isnan(y.float()).any()
    yr, sr = jax_ssd_ref(*j)
    _close(y, yr, TOL_REF[dtype])
    _close(st, sr, TOL_REF[dtype])
    assert max(_rel(y, yr), _rel(st, sr)) <= REL[dtype]
    yp, sp = pallas_ssd(*j, chunk=chunk, interpret=True)
    _close(y, yp, TOL_PALLAS[dtype])
    _close(st, sp, TOL_PALLAS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 192, 16, 128, 64), (1, 288, 48, 64, 96)])
def test_relative_check_rejects_a_shifted_decay(BH, S, P, N, chunk, dtype):
    """The split handed a shifted by one position (each decay one step
    off, as from a cumsum shifted by one) fails ``REL`` by a margin; in
    bf16 it passes the absolute tolerance the card's checks share with
    the JAX suite (``TOL_PALLAS``)."""
    j, t = _both(_inputs(BH, S, P, N, seed=7), dtype)
    yr, sr = jax_ssd_ref(*j)
    xdt, a, b, c = t
    y, st = _split_model(xdt, torch.roll(a, 1, 1), b, c, chunk)
    if dtype == "bfloat16":
        _close(y, yr, TOL_PALLAS[dtype])
    assert min(_rel(y, yr), _rel(st, sr)) > 3 * REL[dtype]


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (1, 256, 64, 128, 256), (64, 2048, 64, 128, 256),
    (64, 2048, 64, 128, 128), (112, 2048, 64, 64, 256),
    (3, 288, 48, 16, 96), (5, 70, 16, 32, 7), (7, 480, 128, 128, 96),
    (2, 4096, 64, 128, 128)])
def test_ssd_plan_covers_every_query_tile_once(BH, S, P, N, chunk):
    """From shapes only: pass 1 one block per (bh, chunk), pass 2 threads
    for every 4 state entries of each bh, pass 3 one block per (bh, chunk,
    query tile), the tiles covering the chunk, and the workspace the
    kernel lays out (chunk states, cum rounded up to 4 floats so that the
    bf16 h_in stays 16-byte aligned, h_in)."""
    plan = ssd_plan(BH, S, P, N, chunk)
    nc = S // chunk
    assert plan.chunks == nc and plan.states == (BH, nc, P, N)
    assert plan.query_tiles == -(-chunk // TILE)
    assert plan.grids[0] == BH * nc
    per_bh = plan.grids[1] // BH
    assert plan.grids[1] % BH == 0
    assert (per_bh - 1) * STATE_THREADS < P * N // 4 <= per_bh * STATE_THREADS
    assert plan.grids[2] == BH * nc * plan.query_tiles
    assert (plan.query_tiles - 1) * TILE < chunk <= plan.query_tiles * TILE
    n_states, n_cum = BH * nc * P * N, -(-BH * S // 4) * 4
    assert n_cum % 4 == 0 and n_cum >= BH * S
    assert plan.workspace == n_states + n_cum + n_states // 2
    assert ssd_plan(BH, S, P, N, chunk, bf16=False).workspace \
        == n_states + n_cum
