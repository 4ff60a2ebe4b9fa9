"""The port's audio family (whisper-base: encoder over stub frames,
decoder with causal self-attention and cross-attention, sinusoidal
positions, no rope) against the JAX package.

Weights come from the JAX ``init_params`` through ``params_from_numpy``
(``torch_parity.pair``: fp32, ``attn_kernel="off"``); frames and tokens
from numpy seeds.  Tolerances: sinusoidal positions bitwise; the encoder
output and logits within 1e-4 of their range (fp32 summed in another
order); bf16 cache leaves (stripes, cross K/V) within a bf16 rounding
(1e-2); with bf16 params, logits within 5e-2 of their range.  Greedy
outputs and wave counters exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (WAVE_STATS, as_np, both_engines,  # noqa: E402
                          pair, stats_of, wave_trace)

ARCH = "whisper-base"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


def _frames(cfg, B, seed=0, dtype=jnp.float32):
    """Random frame embeddings, bf16 values (the stub's type), handed to
    JAX in ``dtype``: the reference's encoder scan traces only with
    frames in the parameters' dtype (the port casts them so)."""
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16()
    return jnp.asarray(x.float().numpy()).astype(dtype), x


def _within(got, want, share, what=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= share * np.ptp(want), what


@pytest.mark.parametrize("S,d", [(1500, 512), (17, 64), (1, 6)])
def test_sinusoidal_positions_bitwise(S, d):
    want = as_np(JL.sinusoidal_positions(S, d))
    got = TL.sinusoidal_positions(S, d, torch.device("cpu"))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(as_np(got), want)


def test_encoder_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jf, tf = _frames(tcfg, 2)
    _within(TM.encode_audio(tcfg, tparams, tf),
            JM.encode_audio(jcfg, jparams, jf), 1e-4)


def _run(models, S, frames_seed=0, steps=3, shift=None,
         frames_dtype=jnp.float32):
    """prefill (2 rows of S tokens behind random frames) and ``steps``
    decode steps in both packages; ``shift`` hands the port's decode row
    1's self-attention stripes in row 0 (a planted fault).  Returns
    [(what, jax logits, port logits)] and both caches."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(S)
    toks = rng.integers(1, tcfg.vocab_size, (2, S + steps)).astype(np.int32)
    jf, tf = _frames(tcfg, 2, frames_seed, frames_dtype)
    max_len = S + steps + 4
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S]),
                                        "frames": jf}, max_len)
    tl, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :S]), "frames": tf}, max_len)
    out = [("prefill", as_np(jl), as_np(tl))]
    caches = [(jc, {k: v.clone() for k, v in tc.items()})]
    if shift:
        for k in ("k", "v"):
            tc[k][:, 0] = tc[k][:, 1].clone()
    for i in range(steps):
        t = toks[:, S + i:S + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(t),
                                jnp.int32(S + i))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(t),
                                torch.tensor(S + i))
        out.append((f"decode {i}", as_np(jl), as_np(tl)))
    return out, caches + [(jc, tc)]


@pytest.mark.parametrize("S", [1, 6])
def test_model_fp32_matches_jax(models, S):
    """Logits of prefill and three decode steps within 1e-4 of their
    range; after prefill and after the steps, the self-attention stripes
    and the cross K/V of the frames within a bf16 rounding."""
    steps, caches = _run(models, S)
    for what, want, got in steps:
        _within(got, want, 1e-4, what)
    for jc, tc in caches:
        assert set(jc) == set(tc)
        for k, v in tc.items():
            np.testing.assert_allclose(as_np(v), as_np(jc[k]), atol=1e-2,
                                       rtol=1e-2, err_msg=k)


def test_decode_reading_another_rows_stripes_fails(models):
    """The 1e-4 limit sees a decode step that reads row 1's
    self-attention stripes for row 0."""
    steps, _ = _run(models, 6, steps=1, shift=True)
    _, want, got = steps[-1]
    assert np.abs(got[0] - want[0]).max() > 100 * 1e-4 * np.ptp(want)
    _within(got[1], want[1], 1e-4)


def test_model_bf16_matches_jax():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), attn_kernel="off")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), attn_kernel="off")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    steps, _ = _run((jcfg, jparams, tcfg, tparams), 6,
                    frames_dtype=jnp.bfloat16)
    for what, want, got in steps:
        _within(got, want, 5e-2, what)


def test_decode_takes_one_position(models):
    _, _, tcfg, tparams = models
    _, tf = _frames(tcfg, 2)
    toks = torch.ones(2, 3, dtype=torch.int32)
    _, cache = TM.prefill(tcfg, tparams, {"tokens": toks, "frames": tf}, 8)
    with pytest.raises(ValueError, match="scalar"):
        TM.decode_step(tcfg, tparams, cache, toks[:, :1],
                       torch.tensor([3, 3]))


def test_wave_engine_matches_jax(models, monkeypatch):
    """Greedy outputs and wave counters of the JAX engine (zero stub
    frames in both); 'auto' resolves to 'wave' and 'continuous' raises
    the reference's ValueError.  The JAX engine's bf16 stub frames do not
    trace through its encoder with fp32 parameters, so its encoder gets
    them in fp32 here (zeros: the same values), as the port takes them."""
    encode = JM.encode_audio
    monkeypatch.setattr(JM, "encode_audio", lambda cfg, params, frames, *a:
                        encode(cfg, params,
                               frames.astype(params["embed"].dtype), *a))
    (jout, jstats), (tout, tstats) = both_engines(models, wave_trace(),
                                                  mode="auto")
    assert tout == jout
    assert stats_of(tstats, WAVE_STATS) == stats_of(jstats, WAVE_STATS)
    _, _, tcfg, tparams = models
    assert ServingEngine(tcfg, tparams, device="cpu").mode == "wave"
    with pytest.raises(ValueError, match="block-addressable"):
        ServingEngine(tcfg, tparams, mode="continuous", device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        TM.init_paged_cache(tcfg, 5, 4, device="cpu")


def test_launcher_serves_reduced_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert len(out) == 3 and all(len(t) == 4 for t in out.values())
    assert "wave engine" in capsys.readouterr().out
