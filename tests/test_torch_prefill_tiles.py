"""The paged flash-prefill kernel's plan and arithmetic, on the CPU.

The kernel (``csrc/paged_prefill.cu``) gives each thread block the rep =
H / Hk query heads of one kv head for a run of query positions, flattened
as (position, head) rows, and walks 64-key tiles: the cached context
through the table, then the chunk's patch-prefix keys and its prompt keys
up to the block's last position.  The CUDA code runs only on the card
(``tests/test_torch_cuda.py``); here:

* the plan (``prefill_tiles``) covers each query position once, for any
  rep from 1 to 32, and comes from shapes alone: the wrapper's host side
  runs on ``meta`` tensors, which hold no values to read;
* the scatter spread over the blocks stores each chunk row once, where
  the plain scatter stores it;
* a test-local model of the tensor-core body's arithmetic (bf16 keys —
  SCLAD context dequantized, chunk keys fake-quantized — fp32 scores,
  exp2 with the scale folded in, P rounded to bf16 before P @ V,
  unnormalized accumulation divided by l at the end, left-pad-only blocks
  zero) matches the plain version within the kernel's bf16 tolerance 2e-2
  on the real rows, at rep 6 and with a patch prefix;
* the wrapper's checks accept rep 6 and refuse what the kernel does not
  take.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_prefill import flash_prefill as ff  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    prefill_attention_ref, scatter_new_kv_ref)
from repro_torch.models import kv_quant  # noqa: E402

TILE_KEYS = 64  # keys per tile of the tensor-core body
TOL = 2e-2
REPS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 20, 24, 32]


@pytest.mark.parametrize("rep", REPS)
def test_prefill_tiles_cover_each_position_once(rep):
    Hk = 2
    H = rep * Hk
    for dtype, rows in ((torch.bfloat16, ff.TC_ROWS),
                        (torch.float32, ff.EXACT_ROWS)):
        for S in (1, 5, 37, 128, 129, 300):
            positions, tiles = ff.prefill_tiles(S, H, Hk, dtype)
            # A block's rows fill its body's m tiles to within one
            # position's heads.
            assert rows - rep < positions * rep <= rows
            assert tiles == math.ceil(S / positions)
            covered = [p for i in range(tiles)
                       for p in range(i * positions,
                                      min(S, (i + 1) * positions))]
            assert covered == list(range(S))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("H,Hk,D", [(48, 8, 128), (32, 4, 64), (4, 4, 64),
                                    (32, 1, 128)])
def test_the_plan_reads_shapes_only(H, Hk, D):
    """The wrapper's checks and plan run on meta tensors (no data: any
    read of ``lengths`` or ``start`` would raise), for every pool."""
    B, S, N, bs, T = 8, 128, 513, 16, 64
    q, kn = _meta(B, S, H, D), _meta(B, S, Hk, D)
    pool = _meta(N, bs, Hk, D)
    lens = _meta(B, dtype=torch.int32)
    tbl = _meta(B, T, dtype=torch.int32)
    with pytest.raises(Exception):
        lens.tolist()  # meta tensors hold nothing to read
    assert ff._check_inputs(q, kn, kn, pool, pool, lens, tbl, lens, 0,
                            None, None) == 0
    scales = _meta(N, bs, Hk, dtype=torch.float32)
    for kind, (dt, name) in enumerate(((torch.int8, "int8"),
                                       (torch.float8_e4m3fn, "fp8")), 1):
        assert ff._check_inputs(q, kn, kn, pool.to(dt), pool.to(dt), lens,
                                tbl, None, 3, (scales, scales),
                                name) == kind
    positions, tiles = ff.prefill_tiles(S, H, Hk)
    assert positions == ff.TC_ROWS // (H // Hk)


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    B, S, H, Hk, D, N, bs, T = 2, 8, 6, 1, 64, 5, 4, 2
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    kn = torch.zeros(B, S, Hk, D, dtype=torch.bfloat16)
    pool = torch.zeros(N, bs, Hk, D, dtype=torch.bfloat16)
    lens = torch.ones(B, dtype=torch.int32)
    tbl = torch.ones(B, T, dtype=torch.int32)

    def check(q=q, kn=kn, pool=pool, lens=lens, tbl=tbl, start=None,
              prefix=0, scales=None, kv_dtype=None):
        return ff._check_inputs(q, kn, kn, pool, pool, lens, tbl, start,
                                prefix, scales, kv_dtype)
    assert check() == 0  # rep 6
    assert check(start=lens, prefix=2) == 0
    with pytest.raises(ValueError, match="D in"):
        check(q=q[..., :32].contiguous(), kn=kn[..., :32].contiguous(),
              pool=pool[..., :32].contiguous())
    with pytest.raises(TypeError, match="share"):
        check(kn=kn.float())
    with pytest.raises(TypeError, match="share"):
        check(q=q.half(), kn=kn.half())
    with pytest.raises(ValueError, match="bad shapes"):
        check(kn=torch.zeros(B, S + 1, Hk, D, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unsupported"):
        check(q=torch.zeros(B, S, 33, D, dtype=torch.bfloat16))  # rep 33
    with pytest.raises(ValueError, match="unsupported"):
        check(q=torch.zeros(B, S, 3, D, dtype=torch.bfloat16),
              kn=torch.zeros(B, S, 2, D, dtype=torch.bfloat16),
              pool=torch.zeros(N, bs, 2, D, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        check(lens=lens.long())
    with pytest.raises(ValueError, match="prefix"):
        check(prefix=S + 1)
    with pytest.raises(ValueError, match="lengths/start"):
        check(lens=lens[:1])
    with pytest.raises(ValueError, match="contiguous"):
        check(tbl=tbl.t().contiguous().t())
    with pytest.raises(TypeError, match="kv_scales"):
        check(pool=pool.to(torch.int8))
    scales = torch.ones(N, bs, Hk)
    with pytest.raises(TypeError, match="kv_dtype"):
        check(pool=pool.to(torch.int8), scales=(scales, scales),
              kv_dtype="fp8")
    flat = torch.zeros(N * bs * Hk * D + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(N, bs, Hk, D)  # 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        check(pool=shifted)
    assert ff.MAX_REP == 32 and ff.HEAD_DIMS == (64, 128)


def _block_stores(S, prefix, length, start, q0, nq):
    """(dest position, padded source row) pairs the block of positions
    [q0, q0 + nq) stores: the kernel's ``scatter_rows``."""
    pad = S - prefix - length
    return [(start + (p if p < prefix else p - pad), p)
            for p in range(q0, q0 + nq)
            if not prefix <= p < prefix + pad]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("rep", [1, 6, 8, 32])
def test_scatter_split_stores_each_row_once(rep, kv_dtype):
    """The blocks' stores are disjoint, and together they are the plain
    scatter (``scatter_new_kv_ref``) bit for bit: position start + j
    takes padded row j (patch prefix) or j + pad, for j < prefix +
    length (a SCLAD pool: ``kv_quant.quantize``'s payload and scale), and
    every other pool row keeps its bytes."""
    Hk, D, bs, T = 2, 64, 16, 12
    H = rep * Hk
    rng = np.random.default_rng(rep)
    for S, prefix in ((37, 0), (37, 5), (130, 16)):
        positions, tiles = ff.prefill_tiles(S, H, Hk)
        lens = torch.tensor([0, 1, 13, S - prefix], dtype=torch.int32)
        start = torch.tensor([40, 3, 17, 0], dtype=torch.int32)
        B = len(lens)
        N = B * T + 1
        kn, vn = (torch.from_numpy(rng.standard_normal((B, S, Hk, D))
                                   .astype(np.float32)).bfloat16()
                  for _ in range(2))
        pools = [torch.from_numpy(rng.standard_normal((N, bs, Hk, D))
                                  .astype(np.float32)).bfloat16()
                 for _ in range(2)]
        scales = None
        if kv_dtype != "bf16":
            (kp, ks), (vp, vs) = (kv_quant.quantize(x, kv_dtype)
                                  for x in pools)
            pools, scales = [kp, vp], [ks, vs]
        tbl = torch.from_numpy(1 + rng.permutation(N - 1)[:B * T]
                               .reshape(B, T).astype(np.int32))
        # What the blocks store, each into its own copy.
        want = [x.clone() for x in pools + (scales or [])]
        dests = []
        for b in range(B):
            for i in range(tiles):
                for dest, p in _block_stores(
                        S, prefix, int(lens[b]), int(start[b]),
                        i * positions, min(positions, S - i * positions)):
                    dests.append((b, dest))
                    blk, off = int(tbl[b, dest // bs]), dest % bs
                    for kv, x in enumerate((kn[b, p], vn[b, p])):
                        if scales is None:
                            want[kv][blk, off] = x
                        else:
                            y, sc = kv_quant.quantize(x, kv_dtype)
                            kv_quant.raw(want[kv])[blk, off] = \
                                kv_quant.raw(y)
                            want[2 + kv][blk, off] = sc
        assert len(dests) == len(set(dests)) \
            == int((prefix + lens).sum())
        got = [x.clone() for x in pools + (scales or [])]
        scatter_new_kv_ref(
            kn, vn, got[0], got[1], lens, tbl, start=start, prefix=prefix,
            kv_scales=None if scales is None else (got[2], got[3]),
            kv_dtype=None if scales is None else kv_dtype)
        for w, g in zip(want, got):
            assert torch.equal(w.view(torch.uint8), g.view(torch.uint8))


def tile_model(q, kn, vn, k_pool, v_pool, lengths, tables, start, prefix,
               kv_scales, kv_dtype):
    """The tensor-core body's arithmetic, written out (bf16 q): per block
    of ``prefill_tiles`` positions, the key walk in 64-key tiles over the
    context [0, start), the patch-prefix keys [0, prefix) and the prompt
    keys [prefix + pad, last position]; keys as bf16 (SCLAD context
    dequantized, chunk K/V fake-quantized), fp32 scores, m the running
    max, p = 2^(s * c - m * c) with c = log2(e) / sqrt(D), l += sum(p),
    o = o * corr + bf16(p) @ V, out = o / l; blocks of left-pad positions
    only give zeros.  Returns (B, S, H * D) fp32."""
    B, S, H, D = q.shape
    Hk = kn.shape[2]
    rep = H // Hk
    bs, T = k_pool.shape[1], tables.shape[1]
    c = math.log2(math.e) / math.sqrt(D)
    positions, tiles = ff.prefill_tiles(S, H, Hk, q.dtype)
    kk, vv = kn, vn
    if kv_scales is not None:
        kk = kv_quant.fake_quant(kn, kv_dtype)
        vv = kv_quant.fake_quant(vn, kv_dtype)
    out = torch.zeros(B, S, Hk, rep, D)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), S - prefix)
        pad = S - prefix - length
        n_ctx = 0 if start is None else min(int(start[b]), T * bs)
        t = tables[b].long()
        kc = kv_quant.raw(k_pool)[t].view(k_pool.dtype).reshape(-1, Hk, D)
        vc = kv_quant.raw(v_pool)[t].view(v_pool.dtype).reshape(-1, Hk, D)
        if kv_scales is not None:
            kc = kv_quant.dequantize(kc, kv_scales[0][t].reshape(-1, Hk),
                                     q.dtype)
            vc = kv_quant.dequantize(vc, kv_scales[1][t].reshape(-1, Hk),
                                     q.dtype)
        for i in range(tiles):
            q0 = i * positions
            nq = min(positions, S - q0)
            if q0 >= prefix and q0 + nq <= prefix + pad:
                continue  # left-pad positions only: zeros
            k_end = q0 + nq
            qpos = torch.arange(q0, k_end)
            qs = q[b, q0:k_end].float().reshape(nq, Hk, rep, D)
            ranges = [(kc, vc, 0, n_ctx, None),
                      (kk[b], vv[b], 0, min(prefix, k_end), True),
                      (kk[b], vv[b], prefix + pad, k_end, True)]
            m = torch.full((nq, Hk, rep), -math.inf)
            l = torch.zeros(nq, Hk, rep)
            o = torch.zeros(nq, Hk, rep, D)
            for keys, vals, lo, hi, causal in ranges:
                for k0 in range(lo, hi, TILE_KEYS):
                    k1 = min(k0 + TILE_KEYS, hi)
                    kt = keys[k0:k1].float()          # (n, Hk, D)
                    vt = vals[k0:k1].float()
                    s = torch.einsum("qhrd,khd->qhrk", qs, kt)
                    if causal:
                        hide = torch.arange(k0, k1)[None] > qpos[:, None]
                        s = s.masked_fill(hide[:, None, None], -math.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    ms = torch.where(m_new == -math.inf,
                                     torch.zeros(()), m_new * c)
                    corr = torch.exp2(m * c - ms)
                    p = torch.exp2(s * c - ms[..., None])
                    l = l * corr + p.sum(-1)
                    o = o * corr[..., None] + torch.einsum(
                        "qhrk,khd->qhrd", p.bfloat16().float(), vt)
                    m = m_new
            out[b, q0:k_end] = o / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, S, H * D)


def _case(seed, H, Hk, D, prefix, with_ctx, kv_dtype):
    """5 rows of a 37-position chunk (prefix + prompt), lengths the whole
    prompt, 1, 13, 20 and 0; starts 0, 5, 70, 129 and 64 (or a first
    chunk); 16-token blocks, 12-entry tables; bf16 q."""
    rng = np.random.default_rng(seed)
    B, S, bs, T = 5, 37, 16, 12
    N = B * T + 1

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).bfloat16()
    q, kn, vn = mk(B, S, H, D), mk(B, S, Hk, D), mk(B, S, Hk, D)
    pools = [mk(N, bs, Hk, D) for _ in range(2)]
    scales = None
    if kv_dtype != "bf16":
        (kp, ks), (vp, vs) = (kv_quant.quantize(x, kv_dtype) for x in pools)
        pools, scales = [kp, vp], (ks, vs)
    lens = torch.tensor([S - prefix, 1, 13, 20, 0], dtype=torch.int32)
    start = torch.tensor([0, 5, 70, 129, 64], dtype=torch.int32) \
        if with_ctx else None
    tbl = torch.from_numpy(1 + rng.permutation(N - 1)[:B * T]
                           .reshape(B, T).astype(np.int32))
    idx = torch.arange(S)[None]
    real = (idx < prefix) | (idx >= (S - lens)[:, None])
    return q, kn, vn, pools, scales, lens, start, tbl, real


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("H,Hk,D", [(48, 8, 128), (32, 4, 64), (4, 4, 64)])
def test_tile_model_matches_plain(H, Hk, D, kv_dtype, prefix, with_ctx):
    q, kn, vn, (kp, vp), sc, lens, start, tbl, real = _case(
        6, H, Hk, D, prefix, with_ctx, kv_dtype)
    got = tile_model(q, kn, vn, kp, vp, lens, tbl, start, prefix, sc,
                     None if sc is None else kv_dtype)
    ref = prefill_attention_ref(
        q, kn, vn, kp.clone(), vp.clone(), lens, tbl, start=start,
        prefix=prefix,
        kv_scales=None if sc is None else tuple(x.clone() for x in sc),
        kv_dtype=None if sc is None else kv_dtype)[0]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[real], ref[real].float(), atol=TOL,
                               rtol=TOL)
    # Row 4 has no tokens: its blocks past the patch prefix are zero.
    positions, _ = ff.prefill_tiles(q.shape[1], H, Hk)
    assert (got[4, positions * math.ceil(prefix / positions):] == 0).all()
