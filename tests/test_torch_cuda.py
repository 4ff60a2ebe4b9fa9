"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
or interpret mode).  Run them on a card with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

Tolerance 2e-2 on bf16 outputs (the kernels score in fp32 where the plain
versions round scores to the compute dtype first), 1e-4 in fp32; pools
(and SCLAD scales) after the prefill scatter bit for bit.  The SCLD,
SSD and flash-attention kernels use the JAX package's kernel tolerances
(its tests/test_kernels.py): SCLD atol 1e-4 / rtol 2e-2 with fp32 x and
1e-1 / 5e-2 with bf16 x (the kernel rounds each weight to x's dtype, the
plain version keeps it exact); attention 2e-5 fp32, 2e-2 bf16; SSD five
times those (a chunked form against the step-by-step recurrence).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.examples import sclad_sparsity  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import (  # noqa: E402
    flash_decode, paged_flash_decode)
from repro_torch.kernels.flash_decode.ref import (  # noqa: E402
    decode_ref, paged_decode_ref)
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import \
    prefill_attention_ref  # noqa: E402
from repro_torch.kernels.sclad_matmul.ops import SCLDLinear  # noqa: E402
from repro_torch.kernels.sclad_matmul.ref import \
    sclad_matmul_ref  # noqa: E402
from repro_torch.kernels.sclad_matmul.sclad_matmul import (  # noqa: E402
    block_compress, k_split, sclad_matmul)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _tables(gen, B, T, N, used, bs):
    tbl = (1 + torch.randperm(N - 1, generator=gen, device="cuda")
           [:B * T]).reshape(B, T).int()
    for b in range(B):
        tbl[b, -(-int(used[b]) // bs):] = 0
    return tbl


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hk,D", [(32, 4, 64), (16, 2, 128)])
def test_decode_kernel_matches_plain(gen, dtype, H, Hk, D):
    B, bs, T = 5, 16, 8
    N = B * T + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(N, bs, Hk, D, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(N, bs, Hk, D, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor([1, 33, 128, 0, 70], dtype=torch.int32,
                        device="cuda")
    tbl = _tables(gen, B, T, N, lens, bs)
    tbl[3] = 0
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, lens, tbl)
    assert paged_flash_decode.launches == before + 1
    ref = paged_decode_ref(q, kp, vp, lens, tbl)
    live = lens > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_ctx", [False, True])
def test_prefill_kernel_matches_plain(gen, dtype, with_ctx):
    B, S, H, Hk, D, bs, T = 4, 24, 32, 4, 64, 16, 8
    N = B * T + 1
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    kn = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
    vn = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(N, bs, Hk, D, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(N, bs, Hk, D, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor([24, 1, 13, 7], dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 5, 16, 40], dtype=torch.int32,
                         device="cuda") if with_ctx else None
    used = lens + (start if with_ctx else 0)
    tbl = _tables(gen, B, T, N, used, bs)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out, _, _ = paged_flash_prefill(q, kn, vn, k1, v1, lens, tbl,
                                    start=start)
    ref, _, _ = prefill_attention_ref(q, kn, vn, k2, v2, lens, tbl,
                                      start=start)
    real = torch.arange(S, device="cuda")[None] >= (S - lens)[:, None]
    torch.testing.assert_close(out[real].float(), ref[real].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(k1.view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v1.view(torch.int16), v2.view(torch.int16))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.zeros(2, 8, 32, device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros(3, 4, 1, 32, device="cuda", dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    tbl = torch.ones(2, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="D in"):
        paged_flash_decode(q, pool, pool, lens, tbl)
    q = torch.zeros(2, 8, 64, device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros(3, 4, 1, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(q, pool, pool, lens.long(), tbl)


def test_engine_runs_through_the_kernels(gen):
    """A small dense model with tinyllama's head geometry served on the
    card: both kernels launch once per layer per step or chunk."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              num_heads=8, num_kv_heads=1, head_dim=64,
                              d_model=128)
    params = M.init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=64, eos_id=-1,
                        block_size=8, prefill_chunk=16, attn_kernel="on")
    d0, p0 = paged_flash_decode.launches, paged_flash_prefill.launches
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.integers(1, 256, size=n), max_new_tokens=5)
            for n in (3, 20, 9)]
    out = eng.run()
    assert all(len(out[u]) == 5 for u in uids)
    L = cfg.num_layers
    assert paged_flash_decode.launches - d0 == L * eng.stats.decode_steps
    assert paged_flash_prefill.launches - p0 == L * eng.stats.prefill_chunks


def _qpool(gen, N, bs, Hk, D, kv_dtype):
    x = torch.randn(N, bs, Hk, D, generator=gen, device="cuda").bfloat16()
    return kv_quant.quantize(x, kv_dtype)


def _bytes(x):
    return x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hk,D", [(32, 4, 64), (16, 2, 128)])
def test_quantized_decode_kernel_matches_plain(gen, dtype, H, Hk, D,
                                               kv_dtype):
    B, bs, T = 5, 16, 8
    N = B * T + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp, ks = _qpool(gen, N, bs, Hk, D, kv_dtype)
    vp, vs = _qpool(gen, N, bs, Hk, D, kv_dtype)
    lens = torch.tensor([1, 33, 128, 0, 70], dtype=torch.int32,
                        device="cuda")
    tbl = _tables(gen, B, T, N, lens, bs)
    tbl[3] = 0
    before = paged_flash_decode.launches
    out = paged_flash_decode(q, kp, vp, lens, tbl, kv_scales=(ks, vs))
    assert paged_flash_decode.launches == before + 1
    ref = paged_decode_ref(q, kp, vp, lens, tbl, kv_scales=(ks, vs))
    live = lens > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("with_ctx", [False, True])
def test_quantized_prefill_kernel_matches_plain(gen, with_ctx, D, dtype,
                                                kv_dtype):
    B, S, bs, T = 4, 24, 16, 8
    H, Hk = (32, 4) if D == 64 else (16, 2)
    N = B * T + 1
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    kn = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
    vn = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
    kn[0, -1] = 0.0  # an all-zero row: scale 1
    kp, ks = _qpool(gen, N, bs, Hk, D, kv_dtype)
    vp, vs = _qpool(gen, N, bs, Hk, D, kv_dtype)
    lens = torch.tensor([24, 1, 13, 7], dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 5, 16, 40], dtype=torch.int32,
                         device="cuda") if with_ctx else None
    used = lens + (start if with_ctx else 0)
    tbl = _tables(gen, B, T, N, used, bs)
    a = [x.clone() for x in (kp, vp, ks, vs)]
    b = [x.clone() for x in (kp, vp, ks, vs)]
    before = paged_flash_prefill.launches
    out = paged_flash_prefill(q, kn, vn, a[0], a[1], lens, tbl, start=start,
                              kv_scales=(a[2], a[3]), kv_dtype=kv_dtype)[0]
    assert paged_flash_prefill.launches == before + 1
    ref = prefill_attention_ref(q, kn, vn, b[0], b[1], lens, tbl,
                                start=start, kv_scales=(b[2], b[3]),
                                kv_dtype=kv_dtype)[0]
    real = torch.arange(S, device="cuda")[None] >= (S - lens)[:, None]
    torch.testing.assert_close(out[real].float(), ref[real].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for x, y in zip(a, b):
        assert torch.equal(_bytes(x), _bytes(y))
    assert not torch.equal(_bytes(a[0]), _bytes(kp))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hk,D", [(32, 4, 64), (16, 2, 128)])
def test_dense_decode_kernel_matches_plain(gen, dtype, H, Hk, D):
    B, S = 4, 300
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, Hk, D, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(B, S, Hk, D, generator=gen, device="cuda").bfloat16()
    lens = torch.tensor([1, 33, 300, 0], dtype=torch.int32, device="cuda")
    before = flash_decode.launches
    out = flash_decode(q, kc, vc, lens)
    assert flash_decode.launches == before + 1
    ref = decode_ref(q, kc, vc, lens)
    live = lens > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _small_cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               num_heads=8, num_kv_heads=1, head_dim=64,
                               d_model=128)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_engine_runs_through_the_kernels(gen, kv_dtype):
    cfg = _small_cfg()
    params = M.init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=64, eos_id=-1,
                        block_size=8, prefill_chunk=16, attn_kernel="on",
                        kv_dtype=kv_dtype)
    d0, p0 = paged_flash_decode.launches, paged_flash_prefill.launches
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.integers(1, 256, size=n), max_new_tokens=5)
            for n in (3, 20, 9)]
    out = eng.run()
    assert all(len(out[u]) == 5 for u in uids)
    L = cfg.num_layers
    assert paged_flash_decode.launches - d0 == L * eng.stats.decode_steps
    assert paged_flash_prefill.launches - p0 == L * eng.stats.prefill_chunks
    assert set(eng._cache) == {"k", "v", "k_scale", "v_scale"}


def test_wave_engine_runs_through_the_dense_kernel(gen):
    cfg = _small_cfg()
    params = M.init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, eos_id=-1,
                        attn_kernel="on", mode="wave")
    d0 = flash_decode.launches
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.integers(1, 256, size=n), max_new_tokens=m)
            for n, m in ((7, 5), (7, 3), (12, 4))]
    out = eng.run()
    assert [len(out[u]) for u in uids] == [5, 3, 4]
    assert flash_decode.launches - d0 == cfg.num_layers \
        * (eng.stats.decode_steps - 2)  # the last step of each wave samples only


SCLD_TOL = {torch.float32: (1e-4, 2e-2), torch.bfloat16: (1e-1, 5e-2)}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _sclad_inputs(M, K, N, C, x_dtype, vals_dtype, seed=0, w_scale=1.0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * w_scale).astype(np.float32)
    vals, rows = block_compress(w, C)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    return (x.to("cuda", x_dtype),
            torch.from_numpy(vals).to("cuda", vals_dtype),
            torch.from_numpy(rows).cuda())


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,C,block_m", [
    (256, 384, 256, 1, 128), (128, 256, 384, 16, 128),
    (96, 128, 256, 6, 32)])  # a partial 64-row tile
def test_sclad_kernel_matches_plain(gen, M, K, N, C, block_m, x_dtype,
                                    vals_dtype):
    x, vals, rows = _sclad_inputs(M, K, N, C, x_dtype, vals_dtype)
    before = sclad_matmul.launches
    y = sclad_matmul(x, vals, rows, block_m=block_m)
    assert sclad_matmul.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    ref = sclad_matmul_ref(x, vals, rows)
    atol, rtol = SCLD_TOL[x_dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (3, 384, 64, 128, 128), (2, 768, 32, 64, 256),
    (2, 288, 48, 16, 96)])  # partial 64-row tiles, P/16 = 3
def test_ssd_kernel_matches_plain(gen, BH, S, P, N, chunk, dtype):
    """At least three chunks, so the carried state is held too."""
    rng = np.random.default_rng(2)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    xdt = (mk(BH, S, P) * 0.1).to("cuda", dtype)
    a = (-mk(BH, S).abs() * 0.1).to("cuda", dtype)
    b = (mk(BH, S, N) * 0.3).to("cuda", dtype)
    c = (mk(BH, S, N) * 0.3).to("cuda", dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(xdt, a, b, c, chunk=chunk)
    assert ssd_scan.launches == before + 1
    yr, str_ = ssd_scan_ref(xdt, a, b, c)
    tol = 5 * ATTN_TOL[dtype]
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, str_, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,D,causal,blk", [
    (2, 256, 256, 4, 2, 64, True, 128),
    (1, 128, 384, 8, 8, 128, False, 128),
    (2, 256, 256, 4, 1, 64, True, 128),     # MQA
    (1, 128, 384, 4, 2, 128, True, 128),    # causal, Sq < Sk
    (1, 72, 136, 8, 2, 64, True, 8)])       # partial query and key tiles
def test_flash_attention_kernel_matches_plain(gen, B, Sq, Sk, H, Hk, D,
                                              causal, blk, dtype):
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hk, D, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, block_q=blk, block_k=blk)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [6, 16])
@pytest.mark.parametrize("M,K,N,block_m", [
    (128, 5632, 256, 128), (128, 2048, 640, 128),
    (128, 5632, 1280, 128),  # 13 K slices on 8 tiles, 14 on 2
    (96, 2048, 640, 32)])  # a partial 128-row tile
def test_sclad_tensor_core_body_at_tinyllama_widths(gen, M, K, N, block_m,
                                                    C, vals_dtype):
    """bf16 x at tinyllama-1.1b's MLP depths, on the K-split grid (the
    output tiles alone are fewer than the SMs), held to the plain version
    and bitwise equal from launch to launch (the slices' fp32 partials
    are summed in a fixed order).  Weights at the model's init scale
    (0.02, as chip_smoke.py): fp32 units are rounded to bf16 before their
    products by design (the TPU body's ``w.astype(x.dtype)``) while the
    plain version keeps them exact, and with unit-variance weights over
    K = 2048 that rounding alone reaches ~0.25 absolute on outputs near
    zero, past the JAX suite's atol."""
    x, vals, rows = _sclad_inputs(M, K, N, C, torch.bfloat16, vals_dtype,
                                  w_scale=0.02)
    assert k_split(M, K // 128, N // 128)[0] > 1
    before = sclad_matmul.launches
    y = sclad_matmul(x, vals, rows, block_m=block_m)
    assert sclad_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    atol, rtol = SCLD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), sclad_matmul_ref(x, vals, rows)
                               .float(), atol=atol, rtol=rtol)
    assert torch.equal(y.view(torch.int16), sclad_matmul(
        x, vals, rows, block_m=block_m).view(torch.int16))


@pytest.mark.parametrize("B,Sq,Sk,H,Hk,D,causal,blk", [
    (1, 1024, 1024, 32, 4, 64, True, 128),
    (1, 64, 1024, 32, 4, 64, True, 64),     # Sq under one query tile
    (1, 48, 1024, 32, 4, 64, False, 16)])
def test_flash_attention_tensor_core_body(gen, B, Sq, Sk, H, Hk, D, causal,
                                          blk):
    """bf16 at tinyllama-1.1b's heads, held to the plain version and
    bitwise equal from launch to launch."""
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
               .bfloat16() for S, h in ((Sq, H), (Sk, Hk), (Sk, Hk)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, block_q=blk, block_k=blk)
    assert flash_attention.launches == before + 1
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), attention_ref(
        q, k, v, causal=causal).float(), atol=tol, rtol=tol)
    again = flash_attention(q, k, v, causal=causal, block_q=blk, block_k=blk)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x, vals, rows = _sclad_inputs(128, 256, 128, 4, torch.bfloat16,
                                  torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        sclad_matmul(x.half(), vals, rows)
    with pytest.raises(TypeError, match="int32"):
        sclad_matmul(x, vals, rows.long())
    with pytest.raises(ValueError, match="K =="):
        sclad_matmul(x[:, :128], vals, rows)
    with pytest.raises(ValueError, match="contiguous"):
        sclad_matmul(x.t().contiguous().t(), vals, rows)
    z = torch.zeros(2, 128, 40, device="cuda")
    a = torch.zeros(2, 128, device="cuda")
    bn = torch.zeros(2, 128, 16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_scan(z, a, bn, bn, chunk=64)
    with pytest.raises(TypeError, match="fp32 or all bf16"):
        ssd_scan(z[..., :32], a.bfloat16(), bn, bn, chunk=64)
    with pytest.raises(ValueError, match="chunk up to"):
        ssd_scan(torch.zeros(1, 512, 32, device="cuda"),
                 torch.zeros(1, 512, device="cuda"),
                 torch.zeros(1, 512, 16, device="cuda"),
                 torch.zeros(1, 512, 16, device="cuda"), chunk=512)
    q = torch.zeros(1, 256, 4, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no key"):
        flash_attention(q, kv, kv, causal=True)
    flash_attention(q, kv, kv, causal=False)  # non-causal Sq > Sk is fine
    with pytest.raises(TypeError, match="fp32 or all bf16"):
        flash_attention(q.float(), kv, kv, causal=False)
    with pytest.raises(ValueError, match="D in"):
        flash_attention(q[..., :32].contiguous(), kv[..., :32].contiguous(),
                        kv[..., :32].contiguous(), causal=False)


def test_new_entry_points_launch_their_kernels(gen, capsys):
    """SCLDLinear, ops.ssd and ops.attention launch their kernels on CUDA
    tensors, and the SCLD example runs through SCLDLinear's kernel."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    lin = SCLDLinear.from_dense(w, 8)
    assert lin.vals.is_cuda and lin.sparsity == 0.5
    x = torch.randn(128, 256, generator=gen, device="cuda")
    n0 = sclad_matmul.launches
    y = lin(x)
    assert sclad_matmul.launches == n0 + 1
    torch.testing.assert_close(y, sclad_matmul_ref(x, lin.vals, lin.rows),
                               atol=1e-4, rtol=2e-2)

    BH, S, P, N = 2, 256, 64, 32
    xs = torch.randn(BH, S, P, generator=gen, device="cuda") * 0.1
    dt = torch.rand(BH, S, generator=gen, device="cuda") * 0.1
    A = -torch.rand(BH, generator=gen, device="cuda")
    b = torch.randn(BH, S, N, generator=gen, device="cuda") * 0.3
    c = torch.randn(BH, S, N, generator=gen, device="cuda") * 0.3
    n0 = ssd_scan.launches
    y, st = ssd_ops.ssd(xs, dt, A, b, c, chunk=64)
    assert ssd_scan.launches == n0 + 1
    yr, sr = ssd_scan_ref(xs * dt[..., None], dt * A[:, None], b, c)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=1e-4)

    q = torch.randn(1, 128, 8, 64, generator=gen, device="cuda")
    kv = torch.randn(1, 128, 2, 64, generator=gen, device="cuda")
    n0 = flash_attention.launches
    o = attn_ops.attention(q, kv, kv)
    assert flash_attention.launches == n0 + 1
    torch.testing.assert_close(o, attention_ref(q, kv, kv), atol=2e-5,
                               rtol=2e-5)

    n0 = sclad_matmul.launches
    res = sclad_sparsity.main([])
    assert sclad_matmul.launches == n0 + len(sclad_sparsity.UNITS)
    for y, ref in res["kernel"].values():
        torch.testing.assert_close(y, ref, atol=1e-4, rtol=2e-2)
    assert "max model scale at 60%: 1.64x" in capsys.readouterr().out
