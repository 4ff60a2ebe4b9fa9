"""The decode kernels' split-and-combine plan and arithmetic, on the CPU.

The two decode kernels (``csrc/decode_attention.cuh``) split a row's key
walk across blocks at a fixed ``SPLIT`` positions, merge the warps of a
block and then the blocks of a row by a log-sum-exp rescale.  The CUDA
code runs only on the card (``tests/test_torch_cuda.py``); here:

* the plan (``decode_splits``, ``split_ranges``, the workspace) covers
  each position once and is computed from shapes alone: the wrappers'
  host side runs on ``meta`` tensors, which hold no values to read;
* a test-local model of the kernels' arithmetic (the same split length
  and warp ranges, empty splits skipped, zeros at n = 0) against the
  plain versions: fp32 within 1e-5 (the same function, summed in another
  order), and with P rounded to bf16 before P @ V (the tensor-core
  body's rounding) within the kernels' bf16 tolerance 2e-2;
* the wrappers' checks refuse what the kernels do not take.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode as fd  # noqa: E402
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    decode_ref, paged_decode_ref)
from repro_torch.models import kv_quant  # noqa: E402

SPLIT = fd.SPLIT
WARP_KEYS = 32  # positions a warp of a split block owns
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("width", [1, 16, 127, 128, 129, 640, 1024, 1280])
def test_decode_splits_cover_each_position_once(width):
    n_split = fd.decode_splits(width)
    assert n_split == math.ceil(width / SPLIT)
    for n in sorted({-3, 0, 1, SPLIT - 1, SPLIT, SPLIT + 1, width - 1,
                     width, width + 1, 3 * width + 7}):
        ranges = fd.split_ranges(n, width)
        assert len(ranges) == n_split
        covered = [p for lo, hi in ranges for p in range(lo, hi)]
        assert covered == list(range(max(0, min(n, width))))
        for s, (lo, hi) in enumerate(ranges):
            assert hi - lo <= SPLIT
            if hi > lo:  # a live block starts on its fixed boundary
                assert lo == s * SPLIT


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_the_plan_reads_shapes_only():
    """The wrappers' checks and workspace run on meta tensors (no data:
    any read of ``lengths`` would raise), and the workspace size depends
    on the table or stripe width only."""
    B, H, Hk, D, N, bs, T = 8, 32, 4, 64, 513, 16, 64
    q = _meta(B, H, D)
    pool = _meta(N, bs, Hk, D)
    lens = _meta(B, dtype=torch.int32)
    tbl = _meta(B, T, dtype=torch.int32)
    with pytest.raises(Exception):
        lens.tolist()  # meta tensors hold nothing to read
    assert fd._check_inputs(q, pool, pool, lens, tbl, None) == 0
    n_split, ws = fd._workspace(q, T * bs)
    assert n_split == 8 and ws.dtype == torch.float32
    assert ws.numel() == B * H * n_split * (D + 2)
    stripes = _meta(B, 1000, Hk, D)
    fd._check_dense(q, stripes, stripes, lens)
    assert fd._workspace(q, 1000)[0] == 8
    scales = _meta(N, bs, Hk, dtype=torch.float32)
    assert fd._check_inputs(q, pool.to(torch.int8), pool.to(torch.int8),
                            lens, tbl, (scales, scales)) == 1


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    B, H, Hk, D, N, bs, T = 2, 8, 1, 64, 5, 4, 2
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    pool = torch.zeros(N, bs, Hk, D, dtype=torch.bfloat16)
    lens = torch.ones(B, dtype=torch.int32)
    tbl = torch.ones(B, T, dtype=torch.int32)
    assert fd._check_inputs(q, pool, pool, lens, tbl, None) == 0
    with pytest.raises(ValueError, match="D in"):
        fd._check_inputs(q[..., :32].contiguous(),
                         pool[..., :32].contiguous(),
                         pool[..., :32].contiguous(), lens, tbl, None)
    with pytest.raises(TypeError, match="int32"):
        fd._check_inputs(q, pool, pool, lens.long(), tbl, None)
    with pytest.raises(ValueError, match="unsupported"):
        fd._check_inputs(torch.zeros(B, 33, D, dtype=torch.bfloat16), pool,
                         pool, lens, tbl, None)
    with pytest.raises(TypeError, match="kv_scales"):
        fd._check_inputs(q, pool.to(torch.int8), pool.to(torch.int8), lens,
                         tbl, None)
    with pytest.raises(ValueError, match="contiguous"):
        fd._check_inputs(q, pool, pool, lens, tbl.t().contiguous().t(),
                         None)
    flat = torch.zeros(N * bs * Hk * D + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(N, bs, Hk, D)  # 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        fd._check_inputs(q, shifted, shifted, lens, tbl, None)
    stripes = torch.zeros(B, 16, Hk, D, dtype=torch.bfloat16)
    fd._check_dense(q, stripes, stripes, lens)
    with pytest.raises(TypeError, match="bf16"):
        fd._check_dense(q, stripes.float(), stripes.float(), lens)
    with pytest.raises(TypeError, match="lengths"):
        fd._check_dense(q, stripes, stripes, lens[:1])
    flat = torch.zeros(B * 16 * Hk * D + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(B, 16, Hk, D)
    with pytest.raises(ValueError, match="aligned"):
        fd._check_dense(q, shifted, shifted, lens)
    assert fd.MAX_REP == 32 and fd.HEAD_DIMS == (64, 128)
    assert "decode_attention.cuh" in _build.HEADERS


def split_model(q, k, v, lens, round_p):
    """The kernels' arithmetic, written out: q (B, H, D); k, v (B, W, Hk,
    D) per-row keys in q's dtype; lens (B,).  Per split block of
    ``split_ranges`` (empty ones skipped, as those blocks exit), per
    warp of 32 keys: fp32 scores, m = max * log2(e) / sqrt(D), p =
    2^(s * log2(e) / sqrt(D) - m), l = sum(p), o = p @ V (p rounded to
    bf16 first when ``round_p``); the block merges its warps, then the
    row's splits merge in split order, and o / l; zeros at n = 0."""
    B, H, D = q.shape
    W, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    c = math.log2(math.e) / math.sqrt(D)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        f = [torch.exp2(p[0] - m) for p in parts]
        return (m, sum(fi * p[1] for fi, p in zip(f, parts)),
                sum(fi[..., None] * p[2] for fi, p in zip(f, parts)))

    out = torch.zeros(B, H, D)
    for b in range(B):
        qs = q[b].float().reshape(Hk, rep, D)
        blocks = []
        for lo, hi in fd.split_ranges(int(lens[b]), W):
            if lo >= hi:
                continue
            warps = []
            for w0 in range(lo, hi, WARP_KEYS):
                w1 = min(w0 + WARP_KEYS, hi)
                kk = k[b, w0:w1].float().transpose(0, 1)   # (Hk, nk, D)
                vv = v[b, w0:w1].float().transpose(0, 1)
                s = qs @ kk.transpose(1, 2)                # (Hk, rep, nk)
                m = s.amax(-1) * c
                p = torch.exp2(s * c - m[..., None])
                pv = p.bfloat16().float() if round_p else p
                warps.append((m, p.sum(-1), pv @ vv))
            blocks.append(merge(warps))
        if blocks:
            _, l, o = merge(blocks)
            out[b] = (o / l[..., None]).reshape(H, D)
    return out


def _inputs(seed, B, H, Hk, D, N, bs, T, kv_dtype, dtype):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    q = mk(B, H, D).to(dtype)
    pools = [mk(N, bs, Hk, D).bfloat16() for _ in range(2)]
    scales = None
    if kv_dtype != "bf16":
        (kp, ks), (vp, vs) = (kv_quant.quantize(x, kv_dtype) for x in pools)
        pools, scales = [kp, vp], (ks, vs)
    tbl = torch.from_numpy(1 + rng.permutation(N - 1)[:B * T]
                           .reshape(B, T).astype(np.int32))
    return q, pools, scales, tbl


def _gather(pool, scale, tbl, dtype):
    """Each row's keys through its table, dequantized to ``dtype``."""
    t = tbl.long()
    x = kv_quant.raw(pool)[t].view(pool.dtype).reshape(t.shape[0], -1,
                                                       *pool.shape[2:])
    if scale is None:
        return x.to(dtype)
    return kv_quant.dequantize(x, scale[t].reshape(t.shape[0], -1,
                                                   pool.shape[2]), dtype)


#: Lengths over 5 splits of a 640-position table: a row of length 0 (all
#: splits empty), split boundaries, a short row (4 empty splits), the
#: whole table, a stale length past it.
LENS = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 300, 640, 900]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_split_model_matches_paged_plain(kv_dtype, dtype):
    B, H, Hk, D, bs, T = len(LENS), 16, 2, 64, 16, 40
    N = B * T + 1
    q, (kp, vp), sc, tbl = _inputs(3, B, H, Hk, D, N, bs, T, kv_dtype, dtype)
    lens = torch.tensor(LENS, dtype=torch.int32)
    ref = paged_decode_ref(q, kp, vp, lens, tbl, kv_scales=sc)
    k = _gather(kp, None if sc is None else sc[0], tbl, dtype)
    v = _gather(vp, None if sc is None else sc[1], tbl, dtype)
    got = split_model(q, k, v, lens, round_p=dtype == torch.bfloat16)
    live = lens > 0
    assert (got[~live] == 0).all()
    torch.testing.assert_close(got[live], ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hk,D", [(4, 4, 64), (24, 4, 64), (32, 1, 128)])
def test_split_model_matches_dense_plain(H, Hk, D, dtype):
    B, S = len(LENS), 640
    rng = np.random.default_rng(4)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    q = mk(B, H, D).to(dtype)
    kc, vc = mk(B, S, Hk, D).bfloat16(), mk(B, S, Hk, D).bfloat16()
    lens = torch.tensor(LENS, dtype=torch.int32)
    ref = decode_ref(q, kc, vc, lens)
    got = split_model(q, kc.to(dtype), vc.to(dtype), lens,
                      round_p=dtype == torch.bfloat16)
    live = lens > 0
    assert (got[~live] == 0).all()
    torch.testing.assert_close(got[live], ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_split_model_is_blind_to_width_and_batch():
    """A row's model output depends only on its keys and length: the
    same with a wider table and alone, as the fixed split length makes
    it for the kernels (bitwise there, ``tests/test_torch_cuda.py``)."""
    B, H, Hk, D, S = 4, 8, 2, 64, 512
    rng = np.random.default_rng(5)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, kc, vc = mk(B, H, D), mk(B, S, Hk, D), mk(B, S, Hk, D)
    lens = torch.tensor([300, 129, 0, 512], dtype=torch.int32)
    full = split_model(q, kc, vc, lens, round_p=False)
    for i in (0, 1):
        n = int(lens[i])
        alone = split_model(q[i:i + 1], kc[i:i + 1, :n], vc[i:i + 1, :n],
                            lens[i:i + 1], round_p=False)
        assert torch.equal(alone[0], full[i])
