"""``kv_dtype="f8"`` in the port against the JAX package: float8_e4m3fn
dense stripes for every family and the fp-exact f8 paged pool (no scale
leaves) through the plain K1/K2/K3 twins, the model and the engine.

Inputs are made with numpy from a seed; f8 arrays cross between the
frameworks as their bytes.  Tolerances:

* the cast: bitwise for every finite bf16 value up to 464 in magnitude
  (and sampled fp32 ones); above 464 JAX gives NaN and torch either NaN
  (2.11) or +-448 (2.13, a saturating cast), pinned as such;
* pools and stripes after a write: bitwise (both frameworks cast the
  same fp32 or bf16 K/V value once);
* plain attention vs the JAX ``ref.py`` oracles: 1e-5 in fp32 (the same
  values summed in another order), 2e-2 in bf16 (about one bf16 ulp: the
  frameworks round bf16 products at different places);
* plain vs the interpret-mode Pallas prefill: 2e-2 (the kernel rounds
  its probabilities before P @ V where the reference keeps fp32);
* model logits with fp32 params: 1e-4 (``torch_parity.TOL``, logits ~4)
  on the paged pool, 1e-4 of the logit range on the wave path (as the
  recurrent families' tests hold it);
* the engine with fp32 params: greedy tokens and scheduler counters
  equal to the JAX engine's, speculation included; within the port a
  2-way ``model`` mesh equals the meshless run bit for bit.  Speculation
  on an f8 pool is not bit for bit speculation off, in the reference as
  here: the verify pass reads the drafts' K/V unrounded, a decode step
  reads its own back from the pool (pinned in both frameworks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.kernels.flash_decode.ref import \
    decode_ref as jax_dense_ref  # noqa: E402
from repro.kernels.flash_decode.ref import \
    paged_decode_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill as pallas_prefill  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    prefill_attention_ref as jax_prefill_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import (  # noqa: E402
    flash_decode, paged_flash_decode)
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import kv_quant as tkq  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paged import CHAIN_ROOT, chain_root_for  # noqa: E402

F8 = torch.float8_e4m3fn
JF8 = jnp.float8_e4m3fn
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = 2e-2
#: Up to this magnitude the two frameworks' float8 casts agree (464
#: itself is a tie that rounds to even, 448, in both).
CAST_LIMIT = 464.0
FAMILIES = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "internvl2-26b",
            "mamba2-1.3b", "zamba2-7b", "whisper-base")
PAGED = FAMILIES[:3]


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
        return torch.from_numpy(a.view(np.uint8).copy()).view(F8)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array, for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[x.element_size()]).numpy()
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
# The cast
# ---------------------------------------------------------------------------

def _bf16_patterns():
    """Every bf16 bit pattern, as (numpy float32 values, torch bf16)."""
    u = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    t = torch.from_numpy(u.view(np.int16)).view(torch.bfloat16)
    return t.float().numpy(), t


def test_cast_bitwise_equal_to_jax_up_to_464():
    """Every finite bf16 value with |x| <= 464, and 2^20 sampled fp32
    values (fp32 params write fp32 K/V), cast to float8_e4m3fn: the same
    byte in both frameworks (round to nearest even, subnormals too)."""
    x, t = _bf16_patterns()
    keep = np.isfinite(x) & (np.abs(x) <= CAST_LIMIT)
    got = bits(t.to(F8))[keep]
    want = bits(jnp.asarray(to_bf16_jax(t)).astype(JF8))[keep]
    assert keep.sum() > 30000 and np.array_equal(got, want)
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(
        -12, 2.6, 1 << 20)).astype(np.float32)
    y = y[np.abs(y) <= CAST_LIMIT]
    assert np.array_equal(bits(torch.from_numpy(y).to(F8)),
                          bits(jnp.asarray(y).astype(JF8)))


def to_bf16_jax(t):
    return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))


def test_cast_divergence_above_464():
    """The one place the casts can part: every finite value of magnitude
    above 464 is NaN in JAX, and in torch NaN too or, where the build's
    cast saturates (``kv_quant.f8_saturates``: 2.13 does), +-448.  The
    port follows torch on both of its routes; the kernels' encoder
    repeats torch's cast."""
    x, t = _bf16_patterns()
    big = np.isfinite(x) & (np.abs(x) > CAST_LIMIT)
    got = t.to(F8).float().numpy()[big]
    if tkq.f8_saturates("cpu"):
        assert np.array_equal(got, np.sign(x[big]) * 448.0)
    else:
        assert np.isnan(got).all()
    want = np.asarray(jnp.asarray(to_bf16_jax(t)).astype(JF8)
                      .astype(jnp.float32))[big]
    assert np.isnan(want).all()
    # Just below the line both round to nearest even.
    edge = np.array([447.0, 455.9, 463.9, 464.0, -464.0, 100.3, 3e-3, 1e-9],
                    np.float32)
    assert np.array_equal(bits(torch.from_numpy(edge).to(F8)),
                          bits(jnp.asarray(edge).astype(JF8)))
    assert torch.from_numpy(edge).to(F8).float().tolist() == \
        [448.0, 448.0, 448.0, 448.0, -448.0, 104.0, 2.0 ** -8, 0.0]
    assert np.isnan(np.asarray(jnp.asarray(np.float32(464.01)).astype(JF8)
                               .astype(jnp.float32)))


def _f8_encode(x: np.ndarray, saturate: bool) -> np.ndarray:
    """``csrc/paged_attention.cuh``'s ``f8_encode`` (the prefill kernel's
    f8 scatter) written out in numpy, step for step: float32 -> e4m3
    bytes."""
    mag_sign = x.astype(np.float32).view(np.uint32)
    sign = mag_sign & np.uint32(0x80000000)
    mag = mag_sign ^ sign
    r = np.full(x.shape, 0x7f, np.uint32)          # 480 and above, inf, NaN
    sub = mag < np.uint32(121 << 23)               # a subnormal result
    denorm = np.uint32(141 << 23)
    r[sub] = ((mag[sub].view(np.float32) + denorm.view(np.float32))
              .view(np.uint32) - denorm)
    nor = ~sub & (mag < np.uint32(1087 << 20))
    odd = (mag[nor] >> np.uint32(20)) & np.uint32(1)
    bias = np.uint32(((7 - 127) << 23) & 0xffffffff)  # wraps, as uint32
    r[nor] = (mag[nor] + bias + np.uint32(0x7ffff) + odd) >> np.uint32(20)
    if saturate:
        r[(r == 0x7f) & (mag <= np.uint32(0x7f800000))] = 0x7e
    return (r | (sign >> np.uint32(24))).astype(np.uint8)


def test_kernel_f8_encoder_matches_both_casts():
    """The prefill kernel's f8 encoder, transcribed: with ``saturate`` as
    this torch answers (``f8_saturates``) it gives torch's cast, without
    it JAX's, on every bf16 bit pattern (NaN and inf included for torch)
    and on 2^20 sampled fp32 values.  On the card ``chip_smoke.py`` holds
    the CUDA code itself to torch's cast, planted values past 448
    included."""
    x, _ = _bf16_patterns()
    rng = np.random.default_rng(1)
    y = rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(-12, 4, 1 << 20)
    x = np.concatenate([x, y.astype(np.float32)])
    assert np.array_equal(_f8_encode(x, tkq.f8_saturates("cpu")),
                          bits(torch.from_numpy(x).to(F8)))
    finite = np.isfinite(x)
    assert np.array_equal(_f8_encode(x, False)[finite],
                          bits(jnp.asarray(x).astype(JF8))[finite])


def test_f8_names_and_kinds():
    """f8 has no scale leaves, keeps the fp chain root, and is kernel
    kind 3 (float8 without scales), apart from SCLAD fp8 (kind 2)."""
    assert "f8" in tkq.KV_DTYPES and not tkq.is_quantized("f8")
    assert chain_root_for("f8") == chain_root_for("fp") == CHAIN_ROOT
    pool = torch.zeros(3, 4, 2, 64, dtype=F8)
    sc = torch.ones(3, 4, 2)
    assert _build.kv_kind("x", pool, None) == 3
    assert _build.kv_kind("x", pool, (sc, sc)) == 2
    assert _build.kv_kind("x", pool.to(torch.bfloat16), None) == 0
    with pytest.raises(TypeError, match="kv_scales"):
        _build.kv_kind("x", pool.view(torch.int8), None)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              kv_dtype="f8")
    assert TM.kv_store_dtype(cfg) == F8
    assert TM.kv_store_dtype(dataclasses.replace(cfg, kv_dtype="fp8")) == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# Cache shapes and block bytes
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, (tuple(v.shape), np.dtype(v.dtype).name
                               if not isinstance(v, torch.Tensor)
                               else str(v.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_shapes_match_jax(arch):
    """init_cache (every family) and init_paged_cache (attention
    families) at f8: the reference's leaves, shapes and dtypes; the
    Mamba-2 conv/state leaves keep theirs."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), kv_dtype="f8")
    tcfg = dataclasses.replace(get_config(arch).reduced(), kv_dtype="f8")
    want = dict(_leaves(jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 12))))
    got = dict(_leaves(TM.init_cache(tcfg, 2, 12, device="cpu")))
    assert got == want
    stripes = {k for k, (_, dt) in got.items() if dt == "float8_e4m3fn"}
    assert stripes == {k for k in got if k.split(".")[-1] in (
        "k", "v", "attn_k", "attn_v", "cross_k", "cross_v")}
    if arch in PAGED:
        want = dict(_leaves(jax.eval_shape(
            lambda: JM.init_paged_cache(jcfg, 5, 4))))
        got = dict(_leaves(TM.init_paged_cache(tcfg, 5, 4, device="cpu")))
        assert got == want and set(got) == {"k", "v"}
        assert got["k"][1] == "float8_e4m3fn"


def test_kv_block_bytes_equal_jax():
    """The engine prices an f8 block at one byte an element with no
    scales, the JAX engine's number; at full width (tinyllama-1.1b, 16
    positions a block, 22 layers) 180224 bytes, half of bf16's 360448 and
    below SCLAD's 191488."""
    jcfg, jparams, tcfg, tparams = tp.pair("tinyllama-1.1b")
    got = {}
    for kd in ("bf16", "f8", "int8"):
        je = JaxEngine(jcfg, jparams, max_batch=2, max_len=32, block_size=4,
                       kv_dtype=kd)
        te = ServingEngine(tcfg, tparams, max_batch=2, max_len=32,
                           block_size=4, kv_dtype=kd, device="cpu")
        assert te.kv_block_bytes == je.kv_block_bytes, kd
        got[kd] = te.kv_block_bytes
    assert 2 * got["f8"] == got["bf16"] and got["f8"] < got["int8"]
    full = {}
    for kd in ("bf16", "f8", "int8"):
        cache = TM.init_paged_cache(dataclasses.replace(
            get_config("tinyllama-1.1b"), kv_dtype=kd), 2, 16, device="meta")
        full[kd] = sum(x[:, 0].numel() * x.element_size()
                       for x in cache.values())
    assert full == {"bf16": 360448, "f8": 180224, "int8": 191488}


# ---------------------------------------------------------------------------
# The plain K1, K2, K3 on f8 pools and stripes
# ---------------------------------------------------------------------------

def _f8(rng, shape, scale=1.0):
    """f8 values made by the JAX cast: (jax array, torch tensor)."""
    j = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)
                    ).astype(JF8)
    return j, to_torch(j)


def _pair(rng, shape, dtype, scale=1.0):
    j = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32),
                    JDT[dtype])
    return j, to_torch(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hk,rep,d", [(2, 8, 64), (2, 6, 128), (4, 1, 128)])
def test_paged_decode_plain_matches_jax(hk, rep, d, dtype):
    """K1's plain twin on an f8 pool: dead lanes, a shared block, any rep."""
    rng = np.random.default_rng(3 + rep)
    B, bs, T = 4, 8, 5
    N = B * T + 1
    lens = np.array([13, 0, 40, 17], np.int32)
    tbl = (1 + np.arange(B * T)).reshape(B, T).astype(np.int32)
    tbl[1] = 0
    tbl[3, 0] = tbl[0, 0]
    qj, qt = _pair(rng, (B, hk * rep, d), dtype)
    kj, kt = _f8(rng, (N, bs, hk, d))
    vj, vt = _f8(rng, (N, bs, hk, d))
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl))
    got = paged_flash_decode(qt, kt, vt, torch.from_numpy(lens),
                             torch.from_numpy(tbl))
    assert got.dtype == qt.dtype and got.shape == (B, hk * rep, d)
    close(want, got, TOL_REF[dtype], lens > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hk,rep,d", [(2, 8, 64), (4, 1, 112), (2, 6, 128)])
def test_dense_decode_plain_matches_jax(hk, rep, d, dtype):
    """K3's plain twin on f8 stripes (D 64, 112, 128): per-row lengths,
    one of them 0 and one past S."""
    rng = np.random.default_rng(d)
    B, S = 4, 40
    qj, qt = _pair(rng, (B, hk * rep, d), dtype)
    kj, kt = _f8(rng, (B, S, hk, d))
    vj, vt = _f8(rng, (B, S, hk, d))
    lens = np.array([1, 17, 45, 0], np.int32)
    want = jax_dense_ref(qj, kj, vj, jnp.asarray(lens))
    got = flash_decode(qt, kt, vt, torch.from_numpy(lens))
    close(want, got, TOL_REF[dtype], lens > 0)


# (S, lengths, start or None, patch prefix, (Hk, rep, D)).
PREFILL_CASES = {
    "first_chunk": (8, [8, 3, 5], None, 0, (2, 8, 64)),
    "continuation": (8, [8, 2, 6], [8, 4, 12], 0, (2, 8, 64)),
    "single_token": (1, [1, 1, 1], [5, 16, 23], 0, (2, 8, 64)),
    "patch_prefix": (11, [8, 3, 5], None, 3, (2, 8, 64)),
    "rep6_continuation": (8, [8, 2, 6], [3, 9, 12], 0, (2, 6, 128)),
    "rep1_continuation": (8, [8, 2, 6], [3, 9, 12], 0, (4, 1, 128)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_plain_matches_jax(case, dtype):
    """K2's plain twin on an f8 pool: attention within tolerance of the
    JAX reference and the interpret-mode Pallas kernel; the scatter's
    bytes bit for bit with both, rows it must leave alone included."""
    S, lens, start, prefix, (hk, rep, d) = PREFILL_CASES[case]
    bs, T = 4, 6
    B = len(lens)
    N = B * T + 1
    rng = np.random.default_rng(40 + list(PREFILL_CASES).index(case))
    qj, qt = _pair(rng, (B, S, hk * rep, d), dtype)
    knj, knt = _pair(rng, (B, S, hk, d), dtype)
    vnj, vnt = _pair(rng, (B, S, hk, d), dtype)
    kj, kt = _f8(rng, (N, bs, hk, d))
    vj, vt = _f8(rng, (N, bs, hk, d))
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
                           jnp.asarray(tbl), start=jstart, prefix=prefix)
    pools = [kt.clone(), vt.clone()]
    got = paged_flash_prefill(
        qt, knt, vnt, pools[0], pools[1], torch.from_numpy(lens),
        torch.from_numpy(tbl),
        start=None if st is None else torch.from_numpy(st), prefix=prefix)
    assert len(got) == 3 and got[1] is pools[0] and got[2] is pools[1]
    close(want[0], got[0], TOL_REF[dtype], real)
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(bits(w), bits(g))
    assert not np.array_equal(bits(kt), bits(got[1]))
    kernel = pallas_prefill(
        qj, knj, vnj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
        jnp.zeros(B, jnp.int32) if st is None else jstart,
        prefix=prefix, has_ctx=st is not None, interpret=True)
    close(kernel[0], got[0], TOL_PALLAS, real)
    for w, g in zip(kernel[1:], got[1:]):
        assert np.array_equal(bits(w), bits(g))


def test_plain_scatter_follows_torchs_cast_past_448():
    """Planted values past 448 (and subnormals) in a chunk row: the plain
    scatter stores torch's cast (past 464 +-448 where it saturates, NaN
    where it does not), and the reference's bytes up to 464."""
    rng = np.random.default_rng(7)
    B, S, hk, d, bs, T = 1, 4, 2, 64, 4, 2
    row = np.array([440, 447, 448, 460, 463.9, 464, 470, 1e3, 1e4, -500,
                    -1e4, 1e-3, 2.0 ** -9, 2.0 ** -11, 3e-3, -2.0 ** -8],
                   np.float32)
    kn = rng.standard_normal((B, S, hk, d)).astype(np.float32)
    kn[0, 2, 1] = np.tile(row, d // 16)
    knt = torch.from_numpy(kn)
    pool = torch.zeros(1 + T, bs, hk, d, dtype=F8)
    tbl = torch.tensor([[1, 2]], dtype=torch.int32)
    paged_flash_prefill(knt.repeat_interleave(2, 2), knt, knt, pool,
                        pool.clone(), torch.tensor([S], dtype=torch.int32),
                        tbl)
    stored = pool[1, 2, 1].float().numpy()
    assert np.array_equal(bits(pool[1, 2, 1]),
                          bits(torch.from_numpy(kn[0, 2, 1]).to(F8)))
    big = np.abs(kn[0, 2, 1]) > CAST_LIMIT
    if tkq.f8_saturates("cpu"):
        assert np.array_equal(stored[big],
                              np.sign(kn[0, 2, 1][big]) * 448.0)
    else:
        assert np.isnan(stored[big]).all()
    ref = np.asarray(jnp.asarray(kn[0, 2, 1]).astype(JF8))
    assert np.array_equal(bits(pool[1, 2, 1])[~big], ref.view(np.uint8)[~big])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PAGED)
def test_paged_model_steps_match_jax(arch):
    """prefill_slots (first chunk, continuation) and decode_step on an f8
    pool, fp32 params: logits within TOL, the pool's bytes bit for bit
    (a vlm row behind a random image)."""
    models = tp.pair(arch, kv_dtype="f8")
    tcfg = models[2]
    pe = None
    if tcfg.family == "vlm":
        pe = np.random.default_rng(2).standard_normal(
            (3, tcfg.num_patches, tcfg.d_model)).astype(np.float32)
    steps, jc, tc = tp.model_steps(models, patch_embeds=pe)
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, atol=tp.TOL, rtol=tp.TOL,
                                   err_msg=what)
    assert set(tc) == set(jc) == {"k", "v"} and tc["k"].dtype == F8
    for leaf in ("k", "v"):
        assert np.array_equal(bits(jc[leaf]), bits(tc[leaf])), leaf


def _wave_run(models, S=6, steps=3):
    """prefill (2 rows of S tokens; a vlm image, whisper frames) and
    ``steps`` decode steps in both packages at a scalar position:
    [(what, jax logits, port logits)], and both caches after each."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(S)
    toks = rng.integers(1, tcfg.vocab_size, (2, S + steps)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    tb = {"tokens": torch.from_numpy(toks[:, :S])}
    if tcfg.family == "vlm":
        pe = rng.standard_normal((2, tcfg.num_patches, tcfg.d_model)) \
            .astype(np.float32)
        tb["patch_embeds"] = torch.from_numpy(pe).bfloat16()
        jb["patch_embeds"] = jnp.asarray(pe).astype(jnp.bfloat16)
    if tcfg.family == "audio":
        fr = torch.from_numpy(rng.standard_normal(
            (2, tcfg.encdec.encoder_seq_len, tcfg.d_model))
            .astype(np.float32)).bfloat16()
        tb["frames"] = fr
        jb["frames"] = jnp.asarray(fr.float().numpy())  # fp32: see audio
    max_len = S + steps + 4
    jl, jc = JM.prefill(jcfg, jparams, jb, max_len)
    tl, tc = TM.prefill(tcfg, tparams, tb, max_len)
    # The port writes its caches in place: keep a copy of the prompt's.
    out, caches = [("prefill", f32(jl), f32(tl))], [(jc, _clone(tc))]
    for i in range(steps):
        t = toks[:, S + i:S + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(t),
                                jnp.int32(S + i))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(t),
                                torch.tensor(S + i))
        out.append((f"decode {i}", f32(jl), f32(tl)))
    caches.append((jc, tc))
    return out, caches


@pytest.mark.parametrize("arch", FAMILIES)
def test_wave_model_matches_jax(arch):
    """model.prefill into f8 stripes then three dense decode steps, fp32
    params: logits within 1e-4 of their range; every f8 stripe (k/v,
    hybrid attn_k/attn_v, audio cross_k/cross_v) bit for bit after the
    prompt and after the steps; fp32 recurrent leaves within 1e-4 of
    their range."""
    models = tp.models_of(arch)
    models = tuple(dataclasses.replace(m, kv_dtype="f8") if i in (0, 2)
                   else m for i, m in enumerate(models))
    steps, caches = _wave_run(models)
    for what, want, got in steps:
        assert np.abs(got - want).max() <= 1e-4 * np.ptp(want), what
    n_f8 = 0
    for jc, tc in caches:
        jl, tl = dict(_flat(jc)), dict(_flat(tc))
        assert set(jl) == set(tl)
        for k, v in tl.items():
            if v.dtype == F8:
                n_f8 += 1
                assert np.array_equal(bits(jl[k]), bits(v)), k
            elif v.dtype == torch.float32:
                want = f32(jl[k])
                assert np.abs(f32(v) - want).max() <= \
                    1e-4 * max(np.ptp(want), 1e-30), k
    assert n_f8 == {"ssm": 0, "audio": 8}.get(models[2].family, 4)


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


def _flat(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PAGED)
def test_engine_matches_jax(arch):
    """The mixed trace (prefix-cache hits, chunked prefill) on an f8
    pool: greedy tokens and scheduler counters equal the JAX engine's."""
    models = tp.pair(arch, kv_dtype="f8")
    (jout, jstats), (tout, tstats) = tp.both_engines(
        models, tp.mixed_trace(), **tp.MIXED_KW)
    assert tout == jout
    assert tp.stats_of(tstats, tp.STATS) == tp.stats_of(jstats, tp.STATS)
    assert tstats.kv_block_bytes == jstats.kv_block_bytes


@pytest.mark.parametrize("arch", FAMILIES)
def test_wave_engine_matches_jax(arch, monkeypatch):
    """Waves on f8 stripes: greedy tokens and wave counters equal the
    JAX engine's (whisper's zero stub frames reach the JAX encoder in
    fp32, as in tests/test_torch_audio.py)."""
    encode = JM.encode_audio
    monkeypatch.setattr(JM, "encode_audio", lambda cfg, params, frames, *a:
                        encode(cfg, params,
                               frames.astype(params["embed"].dtype), *a))
    models = tp.pair(arch, kv_dtype="f8")
    (jout, jstats), (tout, tstats) = tp.both_engines(
        models, tp.wave_trace(), mode="wave")
    assert tout == jout
    assert tp.stats_of(tstats, tp.WAVE_STATS) == \
        tp.stats_of(jstats, tp.WAVE_STATS)


def _requests(cfg, n=5, seed=3):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=9)
    cyc = rng.integers(1, cfg.vocab_size, size=3)
    reqs = []
    for i in range(n):
        tail = np.tile(cyc, 3) if i % 2 else \
            rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 9)))
        reqs.append((np.concatenate([system, tail]) if i < 3 else tail, 6,
                     None))
    return reqs


def _port_run(tcfg, tparams, reqs, **kw):
    eng = ServingEngine(tcfg, tparams, max_batch=3, max_len=32, block_size=4,
                        prefill_chunk=8, eos_id=-1, seed=5, device="cpu",
                        **kw)
    out = tp.run(eng, reqs)
    return out, eng


@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_engine_matches_jax(spec_k):
    """Speculation on an f8 pool: greedy tokens, the spec counters and
    the scheduler's equal the JAX spec engine's (the reference refuses
    neither)."""
    models = tp.pair("tinyllama-1.1b", kv_dtype="f8")
    reqs = _requests(models[2])
    (jout, js), (tout, ts) = tp.both_engines(
        models, reqs, max_batch=3, block_size=4, prefill_chunk=8,
        spec_decode="ngram", spec_k=spec_k)
    assert tout == jout
    names = ("spec_passes", "spec_proposed", "spec_accepted") + tp.STATS
    assert tp.stats_of(ts, names) == tp.stats_of(js, names)
    assert ts.spec_passes > 0 and ts.spec_accepted > 0


def _verify_vs_decode(models, kv_dtype, jax_side):
    """Logits of 3 tokens after a cached 8-token prompt, scored two ways
    from copies of one pool: one verify pass (``prefill_slots`` with
    ``start`` and ``all_logits``) and 3 ``decode_step``s.  Returns the
    largest difference."""
    jcfg, jparams, tcfg, tparams = models
    cfg = dataclasses.replace(jcfg if jax_side else tcfg, kv_dtype=kv_dtype)
    mod, params = (JM, jparams) if jax_side else (TM, tparams)
    arr = jnp.asarray if jax_side else torch.from_numpy
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, (1, 11)).astype(np.int32)
    tbl = np.arange(1, 5, dtype=np.int32)[None]
    kw = {} if jax_side else {"device": "cpu"}
    cache = mod.init_paged_cache(cfg, 5, 4, **kw)
    _, cache = mod.prefill_slots(cfg, params, cache, arr(toks[:, :8]),
                                 arr(np.array([8], np.int32)), arr(tbl))
    copy = (dict(cache) if jax_side
            else {k: v.clone() for k, v in cache.items()})
    ver, _ = mod.prefill_slots(cfg, params, copy, arr(toks[:, 8:]),
                               arr(np.array([3], np.int32)), arr(tbl),
                               start=arr(np.array([8], np.int32)),
                               all_logits=True)
    dec = []
    for i in range(3):
        lg, cache = mod.decode_step(cfg, params, cache,
                                    arr(toks[:, 8 + i:9 + i]),
                                    arr(np.array([8 + i], np.int32)),
                                    block_tables=arr(tbl))
        dec.append(f32(lg)[:, 0])
    return np.abs(f32(ver)[0] - np.concatenate(dec)).max()


def _one_vs_two_chunks(models, kv_dtype, jax_side):
    """Largest difference between the last-token logits of an 8-token
    prompt prefilled in one chunk and in two of 4."""
    jcfg, jparams, tcfg, tparams = models
    cfg = dataclasses.replace(jcfg if jax_side else tcfg, kv_dtype=kv_dtype)
    mod, params = (JM, jparams) if jax_side else (TM, tparams)
    arr = jnp.asarray if jax_side else torch.from_numpy
    kw = {} if jax_side else {"device": "cpu"}
    toks = np.random.default_rng(12).integers(
        1, cfg.vocab_size, (1, 8)).astype(np.int32)
    tbl, four = arr(np.arange(1, 5, dtype=np.int32)[None]), \
        arr(np.array([4], np.int32))
    one, _ = mod.prefill_slots(cfg, params, mod.init_paged_cache(
        cfg, 5, 4, **kw), arr(toks), arr(np.array([8], np.int32)), tbl)
    _, c = mod.prefill_slots(cfg, params, mod.init_paged_cache(
        cfg, 5, 4, **kw), arr(toks[:, :4]), four, tbl)
    two, _ = mod.prefill_slots(cfg, params, c, arr(toks[:, 4:]), four, tbl,
                               start=four)
    return np.abs(f32(one) - f32(two)).max()


def test_verify_pass_reads_drafts_unrounded_as_the_reference():
    """Why speculation on an f8 pool is not bit for bit speculation off
    (on bf16 and SCLAD pools it is): the verify pass attends to the
    drafts' own K/V unrounded, as the reference's fp route does, while a
    decode step reads its token's K/V back from the pool cast to e4m3.
    Both frameworks show it (bf16 params, so a bf16 pool stores K/V
    unrounded): no gap on a bf16 pool, a few hundredths of a logit on f8
    (0.057 here, 0.074 in JAX: the frameworks' bf16 arithmetic differs),
    the same order in both."""
    jcfg, jparams, tcfg, _ = tp.pair("tinyllama-1.1b")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    models = (jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    gaps = {(kd, side): _verify_vs_decode(models, kd, side)
            for kd in ("bf16", "f8") for side in (False, True)}
    # The same reason makes a prompt's logits depend on its chunking
    # (and on prefix-cache hits), in both frameworks.
    gaps.update({(kd, side, "chunks"): _one_vs_two_chunks(models, kd, side)
                 for kd in ("bf16", "f8") for side in (False, True)})
    for key in (("bf16", False), ("bf16", True)):
        assert gaps[key] == 0 and gaps[key + ("chunks",)] == 0
    for what in ((), ("chunks",)):
        port, ref = gaps[("f8", False) + what], gaps[("f8", True) + what]
        assert port > 1e-2 and ref > 1e-2 and 0.5 < port / ref < 2


def test_model_mesh_equals_meshless_within_the_port():
    """On an f8 pool a 2-way model mesh equals the meshless run: greedy
    tokens and counters bit for bit, and the mesh's pool bytes (cut on
    the kv heads) equal the meshless pool's."""
    _, _, tcfg, tparams = tp.pair("tinyllama-1.1b", kv_dtype="f8")
    reqs = _requests(tcfg)
    off, e_off = _port_run(tcfg, tparams, reqs)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    sh, e_sh = _port_run(tcfg, tparams, reqs, mesh=mesh)
    assert sh == off
    assert tp.stats_of(e_sh.stats, tp.STATS) == \
        tp.stats_of(e_off.stats, tp.STATS)
    assert isinstance(e_sh._cache["k"], sharding.Sharded)
    assert e_sh._cache["k"].dim is not None  # cut on the kv heads
    for leaf in ("k", "v"):
        whole = sharding.to_whole(e_sh._cache[leaf])
        assert whole.dtype == F8
        assert np.array_equal(bits(whole), bits(e_off._cache[leaf]))
