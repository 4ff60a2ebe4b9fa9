"""The port's SCLAD int8/fp8 KV pool against ``repro.models.kv_quant``, the
JAX references and the interpret-mode Pallas kernels.

Inputs are made with numpy from a seed and handed to both frameworks;
fp8 arrays cross as their bytes (``uint8`` views), since
``torch.from_numpy`` does not take ml_dtypes.  Tolerances:

* the codec (``quantize``, ``dequantize``, ``fake_quant``) and every pool
  after a scatter (payload and scales): bitwise;
* plain vs JAX reference: 1e-5 in fp32 (dequantized values equal, the
  same attention arithmetic summed in another order), 2e-2 in bf16 (the
  frameworks round bf16 products at different places, about one ulp);
* plain vs Pallas kernel: 2e-2 (the kernel rounds its probabilities to
  the value dtype before P @ V where the reference keeps fp32);
* model logits vs the JAX model with fp32 params: 1e-4 (logits ~4);
  payloads bitwise, scales within 2e-6 relative (a scale is the amax of
  an fp32 K/V row that the two frameworks' matmuls compute an ulp or so
  apart); quantized vs the bf16 pool within the JAX package's
  ``LOGIT_ERR_GATE`` (int8 0.15, fp8 0.35 over a logit span of ~3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.kernels.flash_decode.flash_decode import \
    paged_flash_decode as pallas_decode  # noqa: E402
from repro.kernels.flash_decode.ref import \
    paged_decode_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill as pallas_prefill  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    prefill_attention_ref as jax_prefill_ref  # noqa: E402
from repro.models import kv_quant as jkq  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import \
    paged_flash_decode  # noqa: E402
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill  # noqa: E402
from repro_torch.models import kv_quant as tkq  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

QDTYPES = ["int8", "fp8"]
LOGIT_ERR_GATE = {"int8": 0.15, "fp8": 0.35}
HK, REP, D = 2, 8, 64
H = HK * REP
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(a) -> torch.Tensor:
    """A JAX/numpy array as a CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()) \
            .view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array, for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.view(torch.int16 if x.element_size() == 2
                        else torch.int32).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(a, b, tol, mask=None):
    a, b = f32(a), f32(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_codec_bitwise_equal_to_jax(kv_dtype, dtype):
    """quantize, dequantize and fake_quant equal the JAX codec bit for bit:
    zero rows (scale 1), tiny and huge magnitudes, and int8 never beyond
    127 in magnitude."""
    rng = np.random.default_rng(0)
    mag = rng.choice([1e-6, 1e-2, 1.0, 30.0, 1e6], size=(96, 3, 1))
    x = (rng.standard_normal((96, 3, 64)) * mag).astype(np.float32)
    x[0] = 0.0
    x[1, 1] = 0.0
    x[2, 0, 5] = -3.0  # a row whose amax is negative-signed
    xj = jnp.asarray(x, JDT[dtype])
    xt = to_torch(xj)
    pj, sj = jkq.quantize(xj, kv_dtype)
    pt, st = tkq.quantize(xt, kv_dtype)
    assert pt.dtype == tkq.payload_dtype(kv_dtype)
    assert st.dtype == torch.float32 and st.shape == xt.shape[:-1]
    assert np.array_equal(bits(pj), bits(pt))
    assert np.array_equal(bits(sj), bits(st))
    assert torch.all(st[0] == 1.0) and torch.all(st[1, 1] == 1.0)
    if kv_dtype == "int8":
        assert int(pt.abs().max()) <= 127
    else:
        assert torch.isfinite(pt.float()).all()
    for dt in (torch.float32, torch.bfloat16):
        jd = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        assert np.array_equal(bits(jkq.dequantize(pj, sj, jd)),
                              bits(tkq.dequantize(pt, st, dt)))
    fq = tkq.fake_quant(xt, kv_dtype)
    assert fq.dtype == xt.dtype
    assert np.array_equal(bits(jkq.fake_quant(xj, kv_dtype)), bits(fq))


def test_codec_names_match_jax():
    assert tkq.KV_DTYPES == jkq.KV_DTYPES
    assert tkq.QUANTIZED_KV_DTYPES == jkq.QUANTIZED_KV_DTYPES
    for kd in QDTYPES:
        assert tkq.qmax(kd) == jkq.qmax(kd)
        assert tkq.is_quantized(kd)
    assert not tkq.is_quantized("bf16")
    with pytest.raises(ValueError):
        tkq.is_quantized("int4")


# ---------------------------------------------------------------------------
# Plain quantized paged decode / prefill vs the JAX references and Pallas
# ---------------------------------------------------------------------------

def _qpool(rng, N, bs, kv_dtype, hk=HK, d=D):
    """A quantized pool made by the JAX codec: (jax payload, jax scales,
    torch payload, torch scales)."""
    x = rng.standard_normal((N, bs, hk, d)).astype(np.float32)
    x[0] = 0.0  # the trash block
    p, s = jkq.quantize(jnp.asarray(x, jnp.bfloat16), kv_dtype)
    return p, s, to_torch(p), to_torch(s)


def _pair(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    JDT[dtype])
    return j, to_torch(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_quantized_paged_decode_plain_matches_jax(kv_dtype, dtype):
    """Dead lanes (length 0, all-trash table), a block shared by two lanes
    and a Pallas tile smaller than the pool block."""
    rng = np.random.default_rng(3)
    B, bs, T = 4, 8, 5
    N = B * T + 1
    lens = np.array([13, 0, 40, 17], np.int32)
    tbl = (1 + np.arange(B * T)).reshape(B, T).astype(np.int32)
    tbl[1] = 0
    tbl[3, 0] = tbl[0, 0]
    qj, qt = _pair(rng, (B, H, D), dtype)
    kj, ksj, kt, kst = _qpool(rng, N, bs, kv_dtype)
    vj, vsj, vt, vst = _qpool(rng, N, bs, kv_dtype)
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
                          kv_scales=(ksj, vsj))
    got = paged_flash_decode(qt, kt, vt, torch.from_numpy(lens),
                             torch.from_numpy(tbl), kv_scales=(kst, vst))
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    live = lens > 0
    close(want, got, TOL_REF[dtype], live)
    kernel = pallas_decode(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
                           block_k=bs // 2, interpret=True,
                           kv_scales=(ksj, vsj))
    close(kernel, got, TOL_PALLAS, live)


# (S, lengths, start or None, patch prefix, (Hk, rep, D)); rep 6 at
# D = 128 is internvl2-26b's head geometry.
PREFILL_CASES = {
    "first_chunk": (8, [8, 3, 5], None, 0, (HK, REP, D)),
    "continuation": (8, [8, 2, 6], [8, 4, 12], 0, (HK, REP, D)),
    "single_token": (1, [1, 1, 1], [5, 16, 23], 0, (HK, REP, D)),
    "patch_prefix": (11, [8, 3, 5], None, 3, (HK, REP, D)),
    "rep6_continuation": (8, [8, 2, 6], [3, 9, 12], 0, (2, 6, 128)),
    "rep6_patch_prefix": (10, [7, 1, 4], None, 2, (2, 6, 128)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", QDTYPES)
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_quantized_paged_prefill_plain_matches_jax(case, kv_dtype, dtype):
    """Attention within tolerance; the scatter's payload and scales bit
    for bit with the JAX reference AND the interpret-mode Pallas kernel,
    including the rows it must leave alone."""
    S, lens, start, prefix, (hk, rep, d) = PREFILL_CASES[case]
    bs, T = 4, 6
    B = len(lens)
    N = B * T + 1
    rng = np.random.default_rng(20 + list(PREFILL_CASES).index(case))
    qj, qt = _pair(rng, (B, S, hk * rep, d), dtype)
    knj, knt = _pair(rng, (B, S, hk, d), dtype)
    vnj, vnt = _pair(rng, (B, S, hk, d), dtype)
    kj, ksj, kt, kst = _qpool(rng, N, bs, kv_dtype, hk, d)
    vj, vsj, vt, vst = _qpool(rng, N, bs, kv_dtype, hk, d)
    lens = np.array(lens, np.int32)
    st = None if start is None else np.array(start, np.int32)
    tbl = (1 + np.arange(B * T)).reshape(B, T).astype(np.int32)
    used = (0 if st is None else st) + prefix + lens
    tbl[np.arange(T)[None] * bs >= used[:, None]] = 0
    if st is not None:
        tbl[1, 0] = tbl[0, 0]
    idx, pad = np.arange(S)[None], (S - prefix - lens)[:, None]
    real = (idx < prefix) | (idx >= prefix + pad)
    jstart = None if st is None else jnp.asarray(st)

    want = jax_prefill_ref(qj, knj, vnj, kj, vj, jnp.asarray(lens),
                           jnp.asarray(tbl), start=jstart, prefix=prefix,
                           kv_scales=(ksj, vsj), kv_dtype=kv_dtype)
    pools = [x.clone() for x in (kt, vt, kst, vst)]
    got = paged_flash_prefill(
        qt, knt, vnt, pools[0], pools[1], torch.from_numpy(lens),
        torch.from_numpy(tbl),
        start=None if st is None else torch.from_numpy(st), prefix=prefix,
        kv_scales=(pools[2], pools[3]), kv_dtype=kv_dtype)
    assert len(got) == 5
    assert all(g is p for g, p in zip(got[1:], pools))  # in place
    close(want[0], got[0], TOL_REF[dtype], real)
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(bits(w), bits(g))
    # The scatter changed the pool (and only where the chunk writes).
    assert not np.array_equal(bits(kt), bits(got[1]))

    kernel = pallas_prefill(
        qj, knj, vnj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
        jnp.zeros(B, jnp.int32) if st is None else jstart,
        prefix=prefix, has_ctx=st is not None, interpret=True,
        kv_scales=(ksj, vsj), kv_dtype=kv_dtype)
    close(kernel[0], got[0], TOL_PALLAS, real)
    for w, g in zip(kernel[1:], got[1:]):
        assert np.array_equal(bits(w), bits(g))


# ---------------------------------------------------------------------------
# The model on quantized pools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_quantized_prefill_and_decode_match_jax(reduced, kv_dtype):
    """A first chunk, a continuation with every position's logits and a
    decode step (one dead lane) on an int8/fp8 pool, fp32 params: logits
    within 1e-4, payloads bitwise, scales within 2e-6 relative."""
    jcfg, tcfg, jparams, tparams = reduced
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    rng = np.random.default_rng(1)
    B, bs, T = 3, 4, 8
    N = 1 + B * T
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, T)
    jc = JM.init_paged_cache(jcfg, N, bs)
    tc = TM.init_paged_cache(tcfg, N, bs, device="cpu")
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale"}

    def check_pools():
        for leaf in ("k", "v"):
            assert np.array_equal(bits(jc[leaf]), bits(tc[leaf])), leaf
        for leaf in ("k_scale", "v_scale"):
            np.testing.assert_allclose(f32(tc[leaf]), f32(jc[leaf]),
                                       rtol=2e-6, atol=0)

    P, lens = 8, np.array([8, 5, 3], np.int32)
    toks = rng.integers(1, jcfg.vocab_size, (B, P)).astype(np.int32)
    toks[np.arange(P)[None] < (P - lens)[:, None]] = 0
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(tbl))
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(tbl))
    close(jl, tl, 1e-4)
    check_pools()

    start, P2, l2 = lens.copy(), 4, np.array([4, 2, 1], np.int32)
    t2 = rng.integers(1, jcfg.vocab_size, (B, P2)).astype(np.int32)
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(t2),
                              jnp.asarray(l2), jnp.asarray(tbl),
                              start=jnp.asarray(start), all_logits=True)
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(t2),
                              torch.from_numpy(l2), torch.from_numpy(tbl),
                              start=torch.from_numpy(start),
                              all_logits=True)
    close(jl, tl, 1e-4, np.arange(P2)[None] >= (P2 - l2)[:, None])
    check_pools()

    pos = (start + l2).astype(np.int32)
    dtbl = tbl.copy()
    dtbl[2] = 0
    tk = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tk),
                            jnp.asarray(pos), block_tables=jnp.asarray(dtbl))
    tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(tk),
                            torch.from_numpy(pos),
                            block_tables=torch.from_numpy(dtbl))
    close(f32(jl)[:2], f32(tl)[:2], 1e-4)
    check_pools()


@pytest.mark.parametrize("kv_dtype", QDTYPES)
def test_quantized_logits_within_gate_of_bf16_pool(reduced, kv_dtype):
    """Last-token logits after a chunked prefill of a 13-token prompt (the
    JAX package's gate, on its params cast to bf16) stay within
    LOGIT_ERR_GATE of the bf16 pool's, in the port as in JAX."""
    _, tcfg, jparams, _ = reduced
    tparams = params_from_numpy(
        tcfg, jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                           jparams), device="cpu")
    prompt = np.random.default_rng(0).integers(1, tcfg.vocab_size, size=13)
    logits = {}
    for mode in ("bf16", kv_dtype):
        c = dataclasses.replace(tcfg, kv_dtype=mode)
        cache = TM.init_paged_cache(c, 9, 4, device="cpu")
        lg, _ = TM.prefill_slots(
            c, tparams, cache, torch.from_numpy(prompt[None].astype(np.int32)),
            torch.tensor([13], dtype=torch.int32),
            torch.arange(1, 5, dtype=torch.int32)[None])
        logits[mode] = lg[0].float()
    err = (logits["bf16"] - logits[kv_dtype]).abs().max().item()
    assert 0 < err <= LOGIT_ERR_GATE[kv_dtype], err


def test_copy_cache_block_moves_payload_and_scales(reduced):
    _, tcfg, _, _ = reduced
    for kd in QDTYPES:
        c = dataclasses.replace(tcfg, kv_dtype=kd)
        cache = TM.init_paged_cache(c, 5, 4, device="cpu")
        assert cache["k"].dtype == tkq.payload_dtype(kd)
        assert cache["k_scale"].shape == cache["k"].shape[:-1]
        assert torch.all(cache["k_scale"] == 1.0)
        g = torch.Generator().manual_seed(0)
        for name, x in cache.items():
            fill = torch.randn(x.shape, generator=g) * 4
            x.copy_(fill.to(torch.int8) if x.dtype == torch.int8
                    else fill.to(x.dtype))
        before = {n: x[:, 1].clone() for n, x in cache.items()}
        out = TM.copy_cache_block(cache, 1, 3)
        assert out is cache
        for name, x in cache.items():
            assert np.array_equal(bits(x[:, 3]), bits(before[name])), name


def test_kv_block_bytes_equal_jax(reduced):
    """The engine prices a block as payload plus scales, the JAX engine's
    number for the same config, and int8/fp8 blocks cost less than bf16."""
    jcfg, tcfg, jparams, tparams = reduced
    got = {}
    for kd in ("bf16", "int8", "fp8"):
        je = JaxEngine(jcfg, jparams, max_batch=2, max_len=32, block_size=4,
                       kv_dtype=kd)
        te = ServingEngine(tcfg, tparams, max_batch=2, max_len=32,
                           block_size=4, kv_dtype=kd, device="cpu")
        assert te.kv_block_bytes == je.kv_block_bytes, kd
        got[kd] = te.kv_block_bytes
    assert got["int8"] == got["fp8"] < got["bf16"]
    # Full width (tinyllama-1.1b's heads, 16-token blocks), per layer:
    # 8,704 vs 16,384 bytes a block, 1.88x the blocks in the same memory.
    full = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=1)
    per_layer = {}
    for kd in ("bf16", "int8", "fp8"):
        cache = TM.init_paged_cache(dataclasses.replace(full, kv_dtype=kd),
                                    2, 16, device="cpu")
        per_layer[kd] = sum(x[:, 0].numel() * x.element_size()
                            for x in cache.values())
    assert per_layer == {"bf16": 16384, "int8": 8704, "fp8": 8704}
