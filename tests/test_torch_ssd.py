"""The port's SSD chunk scan against the JAX package: the plain
recurrence against JAX's ``ssd_scan_ref`` and against the Pallas
``ssd_scan`` in interpret mode, and ``ops.ssd`` against JAX's, also with
b and c given per group (``heads_per_group``) against JAX on b and c
repeated by hand; the CUDA kernel's split (chunk states, the score pass
of C B^T once a group row, the state pass, chunk outputs; the bf16
body's rounding points, the fp32 body's 3xTF32 products, emulated bit
for bit as ``cvt.rna.tf32.f32`` splits) written out in torch against
both, a single-TF32 control the relative check must reject, and its
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
import functools

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
from repro_torch.models import ssm as TS  # noqa: E402

TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = {"float32": 1e-4, "bfloat16": 1e-1}
REL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# The kernel's split (csrc/ssd_scan.cu), written out in torch on the CPU:
# chunk states, for fp32 inputs the score pass (each causal 64 x 64 tile
# of C B^T once a (group row, chunk)), the state pass over chunks (fp32 in
# one chunk: none, pass 1's state is the final one), chunk outputs per
# query tile, each pass walking the blocks of ``ssd_plan``; with the bf16
# body's rounding points (the decayed xdt, h_in, the masked scores) or
# the fp32 body's products (``products``: "3xtf32", each operand split
# into a TF32 high part and a TF32 residual; "tf32", the high parts
# alone, the control).  It is held against JAX's recurrence and the
# interpret-mode Pallas kernel with the tolerances above: the split
# computes the same function.

def _tf32(t):
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared: 0x1000 added to
    the fp32 bits (to nearest, ties away from zero), the low 13 bits
    cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(x, w, products=None):
    """x @ w with the kernel's products: exact fp32 (None), 3xTF32
    (lo.hi + hi.lo + hi.hi, the small terms first, summed in fp32) or
    one TF32 product."""
    if products is None:
        return x @ w
    xh, wh = _tf32(x), _tf32(w)
    if products == "tf32":
        return xh @ wh
    assert products == "3xtf32"
    return (_tf32(x - xh) @ wh + xh @ _tf32(w - wh)) + xh @ wh


def _split_model(xdt, a, b, c, chunk, heads_per_group=1, products=None):
    bf16 = xdt.dtype == torch.bfloat16
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    mm = functools.partial(_mm, products=products)
    x, a, b, c = (t.float() for t in (xdt, a, b, c))
    BH, S, P = x.shape
    N = b.shape[2]
    hpg = heads_per_group
    plan = ssd_plan(BH, S, P, N, chunk, bf16, hpg)
    nc, Q, nqt = plan.chunks, chunk, plan.query_tiles
    names = [n for n, _ in plan.launches]
    states = torch.empty(plan.states)
    cum = torch.empty(BH, S)
    for blk in range(BH * nc):  # pass 1: one block per (bh, chunk)
        ch, bh = blk % nc, blk // nc
        rows = slice(ch * Q, (ch + 1) * Q)
        cm = torch.cumsum(a[bh, rows], 0)
        cum[bh, rows] = cm
        xd = rnd(x[bh, rows] * torch.exp(cm[-1] - cm)[:, None])
        states[bh, ch] = mm(xd.T, b[bh // hpg, rows])
    scores = {}
    pairs = nqt * (nqt + 1) // 2
    for blk in range(plan.score_blocks):  # the score pass (fp32)
        pair, rest = blk % pairs, blk // pairs
        ch, gr = rest % nc, rest // nc
        qt = max(q for q in range(nqt) if q * (q + 1) // 2 <= pair)
        kt = pair - qt * (qt + 1) // 2
        assert (gr, ch, qt, kt) not in scores
        qi = slice(ch * Q + qt * TILE, ch * Q + min((qt + 1) * TILE, Q))
        kj = slice(ch * Q + kt * TILE, ch * Q + min((kt + 1) * TILE, Q))
        scores[gr, ch, qt, kt] = mm(c[gr, qi], b[gr, kj].T)
    if "ssd_state_pass" in names:  # pass 2: h_in[c] = h, h = g h + s_c
        h = torch.zeros(BH, P, N)
        h_in = torch.empty(plan.states)
        for ch in range(nc):
            h_in[:, ch] = h
            h = torch.exp(cum[:, ch * Q + Q - 1])[:, None, None] * h \
                + states[:, ch]
    else:  # one fp32 chunk: pass 1 wrote the final state
        assert nc == 1 and not bf16
        h, h_in = states[:, 0], torch.zeros(plan.states)
    h_in = rnd(h_in)
    y = torch.full((BH, S, P), float("nan"))
    tiles = [(bh, ch, qt) for bh in range(BH) for ch in range(nc)
             for qt in range(nqt)]
    assert len(tiles) == plan.launches[-1][1]
    for bh, ch, qt in tiles:  # pass 3: one block per query tile
        i0 = qt * TILE
        r = torch.arange(i0, min(i0 + TILE, Q))
        k = torch.arange(0, min(i0 + TILE, Q))
        cm = cum[bh, ch * Q:(ch + 1) * Q]
        keep = k[None, :] <= r[:, None]
        diff = torch.where(keep, cm[r][:, None] - cm[k][None, :], 0.)
        cq = c[bh // hpg, ch * Q + r]
        if bf16:  # the bf16 body forms its scores itself
            cb = cq @ b[bh // hpg, ch * Q + k].T
        else:  # the fp32 body reads the score pass's tiles
            cb = torch.cat([scores[bh // hpg, ch, qt, kt]
                            for kt in range(qt + 1)], dim=1)
        s_ = rnd(torch.where(keep, cb * torch.exp(diff), 0.))
        y[bh, ch * Q + r] = mm(s_, x[bh, ch * Q + k])
        if bf16 or ch > 0:  # the fp32 body skips chunk 0's zero h_in
            y[bh, ch * Q + r] += torch.exp(cm[r])[:, None] \
                * mm(cq, h_in[bh, ch].T)
    return y.to(xdt.dtype), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 128, 32, 64, 128),  # one chunk, two query tiles
    (2, 192, 16, 128, 64),  # three chunks
    (1, 256, 32, 64, 16),  # sixteen chunks
    (1, 288, 48, 128, 96)])  # three chunks, a partial query tile
def test_split_model_matches_jax(BH, S, P, N, chunk, dtype):
    """Each body as it multiplies: fp32 in 3xTF32."""
    j, t = _both(_inputs(BH, S, P, N, seed=7), dtype)
    y, st = _split_model(*t, chunk, products=None if dtype == "bfloat16"
                         else "3xtf32")
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
    y, st = _split_model(xdt, torch.roll(a, 1, 1), b, c, chunk,
                         products=None if dtype == "bfloat16" else "3xtf32")
    if dtype == "bfloat16":
        _close(y, yr, TOL_PALLAS[dtype])
    assert min(_rel(y, yr), _rel(st, sr)) > 3 * REL[dtype]


#: (batch rows, heads, groups, S, P, N, chunk): heads_per_group 1 (one
#: group a head), 4 (one group: both Mamba-2 configs) and 2 (G = 2).
GROUP_CASES = [(2, 2, 2, 192, 16, 32, 64), (2, 4, 1, 192, 32, 64, 64),
               (2, 4, 2, 128, 16, 32, 128), (1, 4, 1, 288, 48, 16, 96)]


def _group_inputs(b, H, G, S, P, N, seed):
    """xdt and a for b x H rows, b and c for b x G group rows, and b and c
    repeated by hand to every row (row bh reads group row bh // (H / G))."""
    xdt, a, bg, cg = _inputs(b * H, S, P, N, seed=seed)
    bg, cg = bg[:b * G], cg[:b * G]
    hpg = H // G
    return (xdt, a, bg, cg), (xdt, a, np.repeat(bg, hpg, 0),
                              np.repeat(cg, hpg, 0)), hpg


@pytest.mark.parametrize("b,H,G,S,P,N,chunk", GROUP_CASES)
def test_3xtf32_split_model_by_group_matches_jax(b, H, G, S, P, N, chunk):
    """The fp32 body's split, b and c given per group and its products in
    3xTF32, against JAX's recurrence and the interpret-mode Pallas kernel
    on b and c repeated by hand: within TOL_REF, TOL_PALLAS and REL.  The
    same split with one TF32 product (the high parts alone) fails REL:
    the check tells the two apart."""
    grouped, repeated, hpg = _group_inputs(b, H, G, S, P, N, seed=11)
    j, _ = _both(repeated, "float32")
    _, t = _both(grouped, "float32")
    y, st = _split_model(*t, chunk, heads_per_group=hpg, products="3xtf32")
    assert not torch.isnan(y).any() and st.shape == (b * H, P, N)
    yr, sr = jax_ssd_ref(*j)
    _close(y, yr, TOL_REF["float32"])
    _close(st, sr, TOL_REF["float32"])
    assert max(_rel(y, yr), _rel(st, sr)) <= REL["float32"]
    yp, sp = pallas_ssd(*j, chunk=chunk, interpret=True)
    _close(y, yp, TOL_PALLAS["float32"])
    _close(st, sp, TOL_PALLAS["float32"])
    y1, st1 = _split_model(*t, chunk, heads_per_group=hpg, products="tf32")
    assert max(_rel(y1, yr), _rel(st1, sr)) > REL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,H,G,S,P,N,chunk", GROUP_CASES[1:3])
def test_ref_and_op_by_group_match_jax(b, H, G, S, P, N, chunk, dtype):
    """``ssd_scan_ref`` and ``ops.ssd`` with ``heads_per_group`` against
    JAX's on b and c repeated by hand; the wrapper on CPU tensors runs the
    plain version, and refuses b and c that are not one row a group."""
    grouped, repeated, hpg = _group_inputs(b, H, G, S, P, N, seed=13)
    j, _ = _both(repeated, dtype)
    _, t = _both(grouped, dtype)
    y, st = ssd_scan_ref(*t, heads_per_group=hpg)
    yr, sr = jax_ssd_ref(*j)
    _close(y, yr, TOL_REF[dtype])
    _close(st, sr, 1e-5)
    y2, st2 = ssd_scan(*t, chunk=chunk, heads_per_group=hpg)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    with pytest.raises(ValueError, match="group rows"):
        ssd_scan(*t[:2], *(torch.cat([v, v]) for v in t[2:]), chunk=chunk,
                 heads_per_group=hpg)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_scan(*t, chunk=chunk, heads_per_group=b * H + 1)
    rng = np.random.default_rng(5)
    dt = (np.log1p(np.exp(rng.standard_normal((b * H, S)))) * 0.1
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal(b * H)).astype(np.float32)
    x = (np.asarray(repeated[0]) * 10).astype(np.float32)
    jo, to = _both((x, dt, A, repeated[2], repeated[3]), dtype)
    _, tg = _both((grouped[2], grouped[3]), dtype)
    yo, so = ops.ssd(*to[:3], *tg, chunk=chunk, heads_per_group=hpg)
    yj, sj = jax_ops.ssd(*jo, chunk=chunk)
    _close(yo, yj, TOL_REF[dtype])
    _close(so, sj, 1e-5 if dtype == "float32" else TOL_REF[dtype])


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (1, 256, 64, 128, 256), (64, 2048, 64, 128, 256),
    (64, 2048, 64, 128, 128), (112, 2048, 64, 64, 256),
    (3, 288, 48, 16, 96), (5, 70, 16, 32, 7), (7, 480, 128, 128, 96),
    (2, 4096, 64, 128, 128), (512, 512, 64, 128, 256),
    (896, 256, 64, 64, 256), (8, 16, 64, 128, 16)])
def test_ssd_plan_covers_every_query_tile_once(BH, S, P, N, chunk):
    """From shapes only: pass 1 one block per (bh, chunk), pass 2 threads
    for every 4 state entries of each bh, pass 3 one block per (bh, chunk,
    query tile), the tiles covering the chunk, and the workspace the
    kernel lays out (chunk states, cum rounded up to 4 floats so that the
    bf16 h_in and the fp32 score tiles stay 16-byte aligned, then h_in or
    the score tiles).  fp32: the score pass in pass 1's launch, one block
    per causal tile pair of each (group row, chunk), whatever the rows a
    group; in one chunk no state pass and no chunk states."""
    nc = S // chunk
    nqt = -(-chunk // TILE)
    n_states, n_cum = BH * nc * P * N, -(-BH * S // 4) * 4
    per_bh = -(-(P * N // 4) // STATE_THREADS)
    assert (per_bh - 1) * STATE_THREADS < P * N // 4 <= per_bh * STATE_THREADS
    assert (nqt - 1) * TILE < chunk <= nqt * TILE
    assert n_cum % 4 == 0 and n_cum >= BH * S
    plan = ssd_plan(BH, S, P, N, chunk)
    assert plan.chunks == nc and plan.states == (BH, nc, P, N)
    assert plan.query_tiles == nqt and plan.score_blocks == 0
    assert plan.launches == (("ssd_chunk_state_tc", BH * nc),
                             ("ssd_state_pass", BH * per_bh),
                             ("ssd_chunk_out_tc", BH * nc * nqt))
    assert plan.workspace == n_states + n_cum + n_states // 2
    pairs = {(q, k) for q in range(nqt) for k in range(q + 1)}
    assert len(pairs) == nqt * (nqt + 1) // 2
    for hpg in sorted({1, BH} | ({4} if BH % 4 == 0 else set())):
        f = ssd_plan(BH, S, P, N, chunk, bf16=False, heads_per_group=hpg)
        assert f.score_blocks == BH // hpg * nc * len(pairs)
        first = ("ssd_chunk_state_tf32", BH * nc + f.score_blocks)
        out = ("ssd_chunk_out_tf32", BH * nc * nqt)
        if nc == 1:
            assert f.launches == (first, out)
            assert f.workspace == n_cum + f.score_blocks * TILE * TILE
        else:
            assert f.launches == (first, ("ssd_state_pass", BH * per_bh),
                                  out)
            assert f.workspace == n_states + n_cum \
                + f.score_blocks * TILE * TILE


def test_kernel_route_hands_the_op_b_and_c_by_group(monkeypatch):
    """``ssd_via_kernel`` hands ``ops.ssd`` b and c as (b * G, S, N) with
    H / G heads a group: never repeated a head."""
    seen = []
    ssd = ops.ssd

    def spy(x, dt, A, b, c, **kw):
        seen.append((tuple(x.shape), tuple(b.shape), tuple(c.shape), kw))
        return ssd(x, dt, A, b, c, **kw)

    monkeypatch.setattr(TS.ssd_ops, "ssd", spy)
    for G in (1, 2):
        rng = np.random.default_rng(G)
        bsz, S, H, P, N = 2, 32, 4, 8, 16
        x = torch.from_numpy(rng.standard_normal((bsz, S, H, P))
                             .astype(np.float32))
        dt = torch.from_numpy(rng.uniform(0.05, 0.5, (bsz, S, H))
                              .astype(np.float32))
        A = -torch.from_numpy(rng.uniform(1, 4, H).astype(np.float32))
        B, C = (torch.from_numpy(rng.standard_normal((bsz, S, G, N))
                                 .astype(np.float32)) for _ in range(2))
        y, st = TS.ssd_via_kernel(x, dt, A, B, C, 16)
        yw, sw = TS.ssd_chunked(x, dt, A, B, C, 16)
        assert seen[-1] == ((bsz * H, S, P), (bsz * G, S, N), (bsz * G, S, N),
                            {"chunk": 16, "heads_per_group": H // G})
        for got, want in ((y, yw), (st, sw)):
            assert (got - want).norm() / want.norm() <= 1e-5
