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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402

MAX_LEN = 32
STATS = ("preemptions", "cached_prompt_tokens", "prefix_hit_rate",
         "decode_steps", "prefill_chunks", "generated_tokens",
         "prefill_tokens", "admissions")


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


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each trace through the JAX engine, once per module."""
    jcfg, jparams, _, _ = models
    runs = {}
    for name in ("mixed", "shared", "tight"):
        kw, reqs = _trace(name)
        eng = JaxEngine(jcfg, jparams, max_len=MAX_LEN, eos_id=-1,
                        attn_kernel="off", **kw)
        runs[name] = (_run(eng, reqs), eng.stats)
    return runs


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
