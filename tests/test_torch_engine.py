"""The port's ServingEngine against the JAX engine, and the port's own
scheduling invariances.

Cross-framework: reduced tinyllama with the JAX package's parameters cast
to fp32 and carried across (bf16 reduction-order noise can flip greedy
near-ties between frameworks; fp32 does not at this size), the JAX engine
at ``attn_kernel="off"``, ``eos_id=-1``.  Greedy outputs must be
identical and the scheduler's counters equal, on three traces: mixed
prompt lengths and budgets, chunked prefill behind a shared prefix
(prefix-cache hits), and a pool small enough to force preemption.

Within the port: outputs are unchanged by the prefix cache, the prefill
chunk size, ``decode_steps``, co-tenants and preemption, greedy and
stochastic alike (sampling keys are positional).

SCLAD pools: with ``kv_dtype="int8"`` the greedy outputs and counters
equal the JAX engine's on the same three traces.  fp8 greedy tokens may
flip on near-ties between implementations, so fp8 is held to identical
counters, bitwise run-to-run pool determinism and the within-port
invariance matrix.  ``mode="wave"``: greedy outputs and counters equal
the JAX wave engine's.

The deprecated ``decode_kernel`` spellings (engine keyword, launcher
flag, config property) map onto ``attn_kernel`` as in the reference
(twins of ``tests/test_prefill_dispatch.py``'s shim tests; on the CPU
the mapped mode is "off": "on" needs CUDA tensors).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.serve import resolve_attn_kernel_arg  # noqa: E402
from repro_torch.serving import paged  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402

MAX_LEN = 32
STATS = ("preemptions", "cached_prompt_tokens", "prefix_hit_rate",
         "decode_steps", "prefill_chunks", "generated_tokens",
         "prefill_tokens", "admissions")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(name):
    """-> (engine kwargs, [(prompt, budget)])."""
    rng = np.random.default_rng({"mixed": 0, "shared": 1, "tight": 2}[name])
    if name == "mixed":
        reqs = [(rng.integers(1, 256, size=n), m)
                for n, m in ((5, 4), (9, 6), (13, 3), (3, 5), (11, 2))]
        return dict(max_batch=3, block_size=4, prefill_chunk=8), reqs
    if name == "shared":
        system = rng.integers(1, 256, size=12)
        reqs = [(np.concatenate([system, rng.integers(1, 256, size=n)]), m)
                for n, m in ((3, 4), (5, 3), (2, 5), (6, 2))]
        return dict(max_batch=2, block_size=4, prefill_chunk=4), reqs
    reqs = [(rng.integers(1, 256, size=5), 16) for _ in range(3)]
    return dict(max_batch=3, block_size=4, num_blocks=10,
                prefill_chunk=8), reqs


def _run(engine, reqs):
    uids = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    out = engine.run()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = get_config("tinyllama-1.1b").reduced()
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_runs(models, **extra):
    jcfg, jparams, _, _ = models
    runs = {}
    for name in ("mixed", "shared", "tight"):
        kw, reqs = _trace(name)
        eng = JaxEngine(jcfg, jparams, max_len=MAX_LEN, eos_id=-1,
                        attn_kernel="off", **kw, **extra)
        runs[name] = (_run(eng, reqs), eng.stats)
    return runs


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each trace through the JAX engine, once per module."""
    return _jax_runs(models)


@pytest.fixture(scope="module")
def jax_quant_runs(models):
    """Each trace through the JAX engine on int8 and fp8 pools."""
    return {kd: _jax_runs(models, kv_dtype=kd) for kd in ("int8", "fp8")}


def _port(models, **kw):
    _, _, tcfg, tparams = models
    kw.setdefault("attn_kernel", "auto")
    return ServingEngine(tcfg, tparams, max_len=MAX_LEN, eos_id=-1,
                         device="cpu", **kw)


@pytest.mark.parametrize("name", ["mixed", "shared", "tight"])
def test_greedy_outputs_and_stats_match_jax(models, jax_runs, name):
    kw, reqs = _trace(name)
    eng = _port(models, **kw)
    out = _run(eng, reqs)
    want, jstats = jax_runs[name]
    assert out == want
    for s in STATS:
        assert getattr(eng.stats, s) == getattr(jstats, s), s
    if name == "shared":
        assert eng.stats.cached_prompt_tokens > 0
    if name == "tight":
        assert eng.stats.preemptions >= 1
    eng._alloc.check_invariants()
    assert eng._alloc.live_blocks == 0


def test_outputs_invariant_to_prefix_cache_chunk_and_decode_steps(models):
    kw, reqs = _trace("shared")
    base = _run(_port(models, **kw), reqs)
    variants = [dict(prefix_cache=False), dict(prefill_chunk=16),
                dict(prefill_chunk=None), dict(decode_steps=4),
                dict(decode_steps=4, prefill_chunk=None)]
    for v in variants:
        assert _run(_port(models, **dict(kw, **v)), reqs) == base, v
    kw, reqs = _trace("mixed")
    base = _run(_port(models, **kw), reqs)
    for v in (dict(prefill_chunk=4), dict(decode_steps=4)):
        assert _run(_port(models, **dict(kw, **v)), reqs) == base, v


@pytest.mark.parametrize("sampler", [SamplerConfig(),
                                     SamplerConfig(temperature=0.8,
                                                   top_k=20)])
def test_outputs_invariant_to_cotenants_and_preemption(models, sampler):
    """A request's tokens depend on (seed, uid, position) only: the same
    alone as with co-tenants, and the same after preemption recompute."""
    kw, reqs = _trace("mixed")
    together = _run(_port(models, sampler=sampler, seed=5, **kw), reqs)
    for i, req in enumerate(reqs):
        eng = _port(models, sampler=sampler, seed=5, **kw)
        for _ in range(i):  # zero-budget requests only advance the uid
            eng.submit(req[0], max_new_tokens=0)
        assert _run(eng, [req]) == [together[i]]
    kw, reqs = _trace("tight")
    pressed = _port(models, sampler=sampler, seed=5, **kw)
    roomy = _port(models, sampler=sampler, seed=5,
                  **dict(kw, num_blocks=24))
    assert _run(pressed, reqs) == _run(roomy, reqs)
    assert pressed.stats.preemptions >= 1 and roomy.stats.preemptions == 0
    if sampler.temperature > 0:
        greedy = _run(_port(models, seed=5, **kw), reqs)
        assert _run(_port(models, sampler=sampler, seed=6, **kw), reqs) \
            != _run(_port(models, sampler=sampler, seed=5, **kw), reqs)
        assert greedy != _run(_port(models, sampler=sampler, seed=5, **kw),
                              reqs)


@pytest.mark.parametrize("policy", ["largest", "deadline"])
def test_preempt_policies_match_jax(models, policy):
    """The other two victim policies pick the same victims as the JAX
    engine (same outputs, same counters) on the tight trace."""
    jcfg, jparams, _, _ = models
    kw, reqs = _trace("tight")
    kw = dict(kw, preempt_policy=policy)
    deadlines = [3.0, None, 1.0]
    outs = []
    for eng in (JaxEngine(jcfg, jparams, max_len=MAX_LEN, eos_id=-1,
                          attn_kernel="off", **kw), _port(models, **kw)):
        uids = [eng.submit(p, max_new_tokens=m, deadline=d)
                for (p, m), d in zip(reqs, deadlines)]
        res = eng.run()
        outs.append(([res[u] for u in uids], eng.stats.preemptions,
                      eng.stats.prefill_tokens))
    assert outs[0] == outs[1]
    assert outs[1][1] >= 1


def test_cancel_and_match_cached_blocks(models):
    kw, reqs = _trace("shared")
    eng = _port(models, **kw)
    u0 = eng.submit(reqs[0][0], max_new_tokens=8)
    u1 = eng.submit(reqs[1][0], max_new_tokens=8)
    for _ in range(4):  # 4-token chunks: the 12-token system is cached
        eng.step()
    assert eng.match_cached_blocks(reqs[2][0]) == 3
    assert eng.cancel(u1) and not eng.cancel(999)
    done = eng.run()
    assert list(done) == [u0] and len(done[u0]) == 8
    assert eng.stats.cancellations == 1
    eng._alloc.check_invariants()
    assert eng._alloc.live_blocks == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["mixed", "shared", "tight"])
def test_quantized_pool_matches_jax(models, jax_quant_runs, name, kv_dtype):
    """int8: greedy outputs identical to the JAX engine's.  Both: the
    scheduler's counters, peak pool bytes and block bytes identical."""
    kw, reqs = _trace(name)
    eng = _port(models, kv_dtype=kv_dtype, **kw)
    out = _run(eng, reqs)
    want, jstats = jax_quant_runs[kv_dtype][name]
    if kv_dtype == "int8":
        assert out == want
    for s in STATS + ("kv_block_bytes", "peak_pool_bytes",
                      "peak_live_blocks"):
        assert getattr(eng.stats, s) == getattr(jstats, s), s
    eng._alloc.check_invariants()
    assert eng._alloc.live_blocks == 0


def _pool_bits(eng):
    return {n: x.contiguous().view(torch.uint8).clone()
            for n, x in eng._cache.items()}


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_deterministic_and_invariant(models, kv_dtype):
    """Two runs of one trace leave the same pool bytes (payload and
    scales); outputs are unchanged by the prefix cache, chunk sizes,
    ``decode_steps`` and preemption recompute."""
    kw, reqs = _trace("shared")
    a = _port(models, kv_dtype=kv_dtype, **kw)
    b = _port(models, kv_dtype=kv_dtype, **kw)
    base = _run(a, reqs)
    assert _run(b, reqs) == base
    pa, pb = _pool_bits(a), _pool_bits(b)
    assert set(pa) == {"k", "v", "k_scale", "v_scale"}
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for v in (dict(prefix_cache=False), dict(prefill_chunk=16),
              dict(prefill_chunk=None), dict(decode_steps=4)):
        assert _run(_port(models, kv_dtype=kv_dtype, **dict(kw, **v)),
                    reqs) == base, v
    kw, reqs = _trace("tight")
    pressed = _port(models, kv_dtype=kv_dtype, **kw)
    roomy = _port(models, kv_dtype=kv_dtype, **dict(kw, num_blocks=24))
    assert _run(pressed, reqs) == _run(roomy, reqs)
    assert pressed.stats.preemptions >= 1


WAVE_STATS = ("decode_steps", "generated_tokens", "prefill_tokens",
              "admissions", "occupied_slot_steps", "slot_steps")


def _wave_trace():
    """Prompt lengths repeat, so waves hold several requests; budgets
    differ inside a wave, so members finish at different steps."""
    rng = np.random.default_rng(3)
    return [(rng.integers(1, 256, size=n), m)
            for n, m in ((5, 4), (9, 6), (5, 2), (5, 5), (9, 3), (12, 4))]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_wave_mode_matches_jax(models, kv_dtype):
    """mode="wave": greedy outputs and counters equal the JAX wave
    engine's (a SCLAD kv_dtype leaves the wave's bf16 stripes as they
    are, there as here)."""
    jcfg, jparams, _, _ = models
    reqs = _wave_trace()
    outs, stats = [], []
    for eng in (JaxEngine(jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                          eos_id=-1, attn_kernel="off", mode="wave",
                          kv_dtype=kv_dtype),
                _port(models, max_batch=2, mode="wave", kv_dtype=kv_dtype)):
        outs.append(_run(eng, reqs))
        stats.append([getattr(eng.stats, s) for s in WAVE_STATS])
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    assert [len(o) for o in outs[1]] == [m for _, m in reqs]


def test_wave_mode_surface(models):
    """The wave engine drains through run(); step() and cancel() are the
    continuous path's and refuse, as in the reference; greedy outputs
    equal the continuous engine's (the same model, another schedule)."""
    reqs = _wave_trace()
    wave = _port(models, max_batch=4, mode="wave")
    assert wave.mode == "wave" and _port(models).mode == "continuous"
    for p, m in reqs:
        wave.submit(p, max_new_tokens=m)
    assert wave.has_pending_work()
    with pytest.raises(RuntimeError, match="continuous"):
        wave.step()
    with pytest.raises(RuntimeError, match="continuous"):
        wave.cancel(1)
    assert wave.match_cached_blocks(reqs[0][0]) == 0
    out = wave.run()
    assert not wave.has_pending_work()
    cont = _run(_port(models, max_batch=4, block_size=4), reqs)
    assert [out[u] for u in sorted(out)] == cont


# ---------------------------------------------------------------------------
# deprecation shim: decode_kernel spellings map onto attn_kernel
# ---------------------------------------------------------------------------

def test_engine_decode_kernel_kwarg_deprecated(models):
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(53)
    reqs = [(rng.integers(1, tcfg.vocab_size, size=5), 4)]
    with pytest.warns(DeprecationWarning, match="attn_kernel"):
        eng = ServingEngine(tcfg, tparams, max_len=MAX_LEN, eos_id=-1,
                            max_batch=1, block_size=4, decode_kernel="off",
                            device="cpu")
    assert eng.cfg.attn_kernel == "off"
    out_dep = _run(eng, reqs)
    out_new = _run(_port(models, max_batch=1, block_size=4,
                         attn_kernel="off"), reqs)
    assert out_dep == out_new  # the alias selects the same implementation
    with pytest.raises(ValueError, match="conflicting"), \
            pytest.warns(DeprecationWarning):
        ServingEngine(tcfg, tparams, attn_kernel="on", decode_kernel="off",
                      device="cpu")


def test_serve_flag_decode_kernel_deprecated():
    with pytest.warns(DeprecationWarning, match="attn-kernel"):
        assert resolve_attn_kernel_arg(None, "off") == "off"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning on the new spelling
        assert resolve_attn_kernel_arg("on", None) == "on"
        assert resolve_attn_kernel_arg(None, None) == "auto"
    with pytest.warns(DeprecationWarning):
        with pytest.raises(SystemExit):
            resolve_attn_kernel_arg("on", "off")


def test_config_decode_kernel_property_alias():
    cfg = get_config("tinyllama-1.1b").reduced()
    cfg = dataclasses.replace(cfg, attn_kernel="off")
    assert cfg.decode_kernel == "off"  # read-only back-compat alias
    assert paged.BlockAllocator is paged.BlockStore
    assert paged._CHAIN_ROOT == paged.CHAIN_ROOT
