"""The port's vlm family (internvl2-26b's stub patch prefix) against the
JAX package: model steps with non-zero patch embeddings, the engine's
per-request prefix-cache chain seed, and engine runs that mix two images
and the zero stub, continuous and wave.

Tolerances: logits ``TOL`` (1e-4, ``torch_parity``); chain seeds, greedy
outputs (fp32 params), scheduler counters and prefix-cache matches
exactly.  A control: the port's decode step at a position shifted by
``num_patches`` (the prefix counted twice) must miss the JAX logits by
more than the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (MAX_LEN, STATS, TOL, WAVE_STATS,  # noqa: E402
                          both_engines, model_steps, pair, stats_of)

ARCH = "internvl2-26b"


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


def _images(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.num_patches, cfg.d_model))
            .astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("stub", [False, True])
def test_model_steps_match_jax(models, stub):
    """First chunk (patches ahead of the tokens), continuation (its start
    counts the patches) and decode, with per-row images or the stub."""
    tcfg = models[2]
    pe = None if stub else np.stack(_images(tcfg, 3))
    steps, _, _ = model_steps(models, patch_embeds=pe)
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=what)


def test_decode_shifted_by_the_prefix_fails(models):
    """The decode position counted with the prefix twice writes and reads
    the wrong cache positions: the comparison must catch it."""
    tcfg = models[2]
    steps, _, _ = model_steps(models, patch_embeds=np.stack(_images(tcfg, 3)),
                              decode_shift=tcfg.num_patches)
    (_, w1, g1), (_, w2, g2), (_, w3, g3) = steps
    np.testing.assert_allclose(g1, w1, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g2, w2, atol=TOL, rtol=TOL)
    assert np.abs(g3 - w3).max() > 100 * TOL


def test_chain_seed_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    img = _images(tcfg, 1)[0]
    for kv_dtype in ("bf16", "int8"):
        j = JaxEngine(jcfg, jparams, max_len=MAX_LEN, kv_dtype=kv_dtype)
        t = ServingEngine(tcfg, tparams, max_len=MAX_LEN, kv_dtype=kv_dtype,
                          device="cpu")
        seeds = [t._chain_seed(img), t._chain_seed(None)]
        assert seeds == [j._chain_seed(img), j._chain_seed(None)]
        assert len(set(seeds + [t._chain_root])) == 3


def test_submit_checks_patch_embeds(models):
    _, _, tcfg, tparams = models
    eng = ServingEngine(tcfg, tparams, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.submit(np.arange(1, 5), patch_embeds=np.zeros((3, tcfg.d_model)))
    dense = pair("tinyllama-1.1b")
    eng = ServingEngine(dense[2], dense[3], max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="vlm-only"):
        eng.submit(np.arange(1, 5), patch_embeds=_images(tcfg, 1)[0])


def _image_trace(cfg):
    """Two images and the stub over one 8-token system prompt: same-image
    requests hit the prefix cache past the patch prefix; the same tokens
    behind the other image, or the stub, must not."""
    a, b = _images(cfg, 2)
    rng = np.random.default_rng(6)
    system = rng.integers(1, 256, size=8)

    def prompt(n):
        return np.concatenate([system, rng.integers(1, 256, size=n)])

    p = prompt(5)
    return [(p, 4, a), (prompt(3), 3, None), (prompt(6), 5, a),
            (p.copy(), 4, b), (prompt(2), 3, b), (prompt(4), 2, None),
            (rng.integers(1, 256, size=7), 3, None)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_matches_jax(models, kv_dtype):
    tcfg = models[2]
    reqs = _image_trace(tcfg)
    kw = dict(max_batch=2, block_size=4, prefill_chunk=4, kv_dtype=kv_dtype)
    (jout, jstats), (tout, tstats) = both_engines(models, reqs, **kw)
    assert tout == jout
    assert stats_of(tstats, STATS) == stats_of(jstats, STATS)
    assert tstats.cached_prompt_tokens > 0


def test_match_cached_blocks_matches_jax(models):
    """After a trace, the prefix-cache probe of each request's prompt
    behind each image (and the stub) answers as the JAX engine's."""
    jcfg, jparams, tcfg, tparams = models
    reqs = _image_trace(tcfg)
    kw = dict(max_batch=2, block_size=4, prefill_chunk=4)
    answers = []
    for eng in (JaxEngine(jcfg, jparams, max_len=MAX_LEN, eos_id=-1, **kw),
                ServingEngine(tcfg, tparams, max_len=MAX_LEN, eos_id=-1,
                              device="cpu", **kw)):
        for p, m, pe in reqs:
            eng.submit(p, max_new_tokens=m, patch_embeds=pe)
        eng.run()
        answers.append([eng.match_cached_blocks(p, patch_embeds=pe)
                        for p, _, pe in reqs]
                       + [eng.match_cached_blocks(reqs[0][0], patch_embeds=x)
                          for x in (None, reqs[3][2])])
    assert answers[0] == answers[1]
    assert max(answers[1]) > 1


def test_wave_mode_matches_jax(models):
    tcfg = models[2]
    a, b = _images(tcfg, 2, seed=7)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(1, 256, size=n), m, pe)
            for n, m, pe in ((5, 4, a), (9, 6, None), (5, 2, b), (5, 5, None),
                             (9, 3, a))]
    (jout, jstats), (tout, tstats) = both_engines(models, reqs, max_batch=2,
                                                  mode="wave")
    assert tout == jout
    assert stats_of(tstats, WAVE_STATS) == stats_of(jstats, WAVE_STATS)
