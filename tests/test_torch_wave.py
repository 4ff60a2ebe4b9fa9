"""The port's wave path (dense KV stripes) against the JAX package: the
plain dense decode (``decode_ref``, the CPU side of the dense
flash-decode kernel), ``layers._sdpa``, ``chunked_attention`` and
``attention``, and ``model.prefill`` + a dense ``decode_step``.

The JAX Pallas ``flash_decode`` body no longer traces on the installed
jax, so its oracle ``ref.decode_ref`` is the reference here.  Inputs are
made with numpy from a seed.  Tolerances: 1e-5 in fp32 (the same
arithmetic summed in another order), 2e-2 in bf16 (about one bf16 ulp:
the frameworks round bf16 products at different places).  Model, fp32
params: logits 1e-4 (logits ~4), bf16 stripes within one bf16 ulp (an
fp32 K/V value a few fp32 ulps apart can round to a neighbouring bf16
value: one element in the three steps here does).  Model, bf16 params:
1e-1 on logits and stripes — the whole prompt's attention runs in bf16
in both frameworks, one ulp at |logit| ~4 is 0.016, and two layers
compound it (measured at most 0.052).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.kernels.flash_decode.ref import \
    decode_ref as jax_decode_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import \
    flash_decode  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
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


def _pair(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.float32 if dtype == "float32" else torch.bfloat16)


def _close(a, b, tol, mask=None):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()
    b = np.asarray(jnp.asarray(b).astype(jnp.float32)) \
        if not isinstance(b, torch.Tensor) else b.float().numpy()
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_plain_matches_jax(dtype):
    """Per-row lengths (one of them 0, one past S) and a scalar length,
    through the wrapper and through ``ops.decode_attention``."""
    rng = np.random.default_rng(0)
    B, S, Hk, rep, D = 4, 40, 2, 8, 64
    qj, qt = _pair(rng, (B, Hk * rep, D), dtype)
    kj, kt = _pair(rng, (B, S, Hk, D), "bfloat16")
    vj, vt = _pair(rng, (B, S, Hk, D), "bfloat16")
    lens = np.array([1, 17, 40, 0], np.int32)
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(lens))
    got = flash_decode(qt, kt, vt, torch.from_numpy(lens))
    assert got.dtype == qt.dtype
    _close(want, got, TOL[dtype], lens > 0)
    via_ops = decode_ops.decode_attention(qt, kt, vt,
                                          torch.from_numpy(lens))
    assert torch.equal(via_ops, got)
    want = jax_decode_ref(qj, kj, vj, jnp.int32(23))
    got = decode_ops.decode_attention(qt, kt, vt, torch.tensor(23))
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_and_attention_match_jax(dtype):
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    rng = np.random.default_rng(1)
    B, S, H, Hk, D = 2, 11, 4, 2, 16
    qj, qt = _pair(rng, (B, S, H, D), dtype)
    kj, kt = _pair(rng, (B, S, Hk, D), dtype)
    vj, vt = _pair(rng, (B, S, Hk, D), dtype)
    mask = np.tril(np.ones((S, S), bool))
    mask[:, 0] = False  # a key no query sees
    want = JL._sdpa(jcfg, qj, kj, vj, jnp.asarray(mask)[None, None, None])
    got = TL._sdpa(tcfg, qt, kt, vt, torch.from_numpy(mask))
    assert got.shape == (B, S, H * D)
    _close(want, got, TOL[dtype], np.broadcast_to(
        mask.any(-1)[None, :, None], (B, S, H * D)))
    _close(JL._sdpa(jcfg, qj, kj, vj), TL._sdpa(tcfg, qt, kt, vt),
           TOL[dtype])

    d = jcfg.d_model
    names = ("wq", "wk", "wv", "wo")
    shapes = ((d, H * D), (d, Hk * D), (d, Hk * D), (H * D, d))
    pj, pt = {}, {}
    for n, shp in zip(names, shapes):
        pj[n], pt[n] = _pair(rng, shp, dtype)
        pj[n], pt[n] = pj[n] * 0.1, pt[n] * 0.1
    xj, xt = _pair(rng, (B, S, d), dtype)
    pos = np.arange(S)
    # 5x the tolerance: rope and the QKV and output projections add three
    # more products rounded in the compute dtype around the attention.
    for causal in (True, False):
        _close(JL.attention(jcfg, pj, xj, jnp.asarray(pos), causal=causal),
               TL.attention(tcfg, pt, xt, torch.from_numpy(pos),
                            causal=causal), 5 * TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(dtype, causal):
    """Blockwise attention called directly with small chunks (4 query
    chunks, 3 key chunks), against JAX's and against one ``_sdpa``."""
    rng = np.random.default_rng(2)
    B, S, H, Hk, D = 2, 24, 4, 2, 16
    qj, qt = _pair(rng, (B, S, H, D), dtype)
    kj, kt = _pair(rng, (B, S, Hk, D), dtype)
    vj, vt = _pair(rng, (B, S, Hk, D), dtype)
    want = JL.chunked_attention(qj, kj, vj, causal, q_chunk=6, k_chunk=8)
    got = TL.chunked_attention(qt, kt, vt, causal, q_chunk=6, k_chunk=8)
    assert got.shape == (B, S, H * D) and got.dtype == qt.dtype
    _close(want, got, TOL[dtype])
    tcfg = get_config("tinyllama-1.1b").reduced()
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool)) if causal else None
    _close(TL._sdpa(tcfg, qt, kt, vt, mask), got, 2 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_dense_decode_match_jax(dtype):
    """model.prefill into dense stripes, then three dense decode steps at
    a scalar position, against the JAX model at attn_kernel="off"."""
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    jparams = jax.tree.map(lambda x: x.astype(JDT[dtype]),
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tol = {"float32": 1e-4, "bfloat16": 1e-1}[dtype]
    rng = np.random.default_rng(3)
    B, S, max_len = 3, 7, 16
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        max_len)
    tl, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        max_len)
    assert tc["k"].shape == (jcfg.num_layers, B, max_len,
                             jcfg.num_kv_heads, jcfg.head_dim)
    assert tc["k"].dtype == torch.bfloat16
    _close(jl, tl, tol)

    def check_stripes():
        for leaf in ("k", "v"):
            if dtype == "float32":  # within one bf16 ulp
                np.testing.assert_allclose(
                    tc[leaf].float().numpy(),
                    np.asarray(jc[leaf].astype(jnp.float32)),
                    rtol=2.0 ** -7, atol=0)
            else:
                _close(jc[leaf], tc[leaf], tol)

    check_stripes()
    for step in range(3):
        tk = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tk),
                                jnp.int32(S + step))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(tk),
                                torch.tensor(S + step, dtype=torch.int32))
        assert tl.shape == (B, 1, jcfg.vocab_size)
        _close(jl, tl, tol)
        check_stripes()


def test_unported_stripe_dtype_raises():
    """kv_dtype="f8" stores float8 stripes (it once raised here); the
    SCLAD spellings keep bf16 stripes, as in the reference."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              kv_dtype="f8")
    c = TM.init_cache(cfg, 2, 8, device="cpu")
    assert c["k"].dtype == c["v"].dtype == torch.float8_e4m3fn
    assert c["k"].shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads,
                            cfg.head_dim)
    assert TM.init_cache(dataclasses.replace(cfg, kv_dtype="int8"), 2, 8,
                         device="cpu")["k"].dtype == torch.bfloat16
