"""The port's moe family against the JAX package: ``models.moe``
(``capacity``, ``route``, ``_dispatch_indices``, ``apply_moe``), the
model steps of reduced qwen2-moe-a2.7b (shared expert) and
qwen3-moe-235b-a22b (none), and the serving engine.

Tolerances: routing weights and the aux loss 1e-6 (fp32 softmax of the
same logits), experts and dispatch indices exactly; ``apply_moe`` 1e-5
in fp32 (the same sums in another order: the port combines each token's
slots by gather where the reference scatter-adds); logits ``TOL`` (1e-4,
``torch_parity``).  Engines: greedy outputs and scheduler counters
identical, fp32 params, on a mixed trace on bf16 and int8 pools and in
wave mode; within the port, outputs bitwise unchanged by the prefix
cache, the chunk size and ``decode_steps``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (MAX_LEN, MIXED_KW, STATS, TOL,  # noqa: E402
                          WAVE_STATS, both_engines, mixed_trace,
                          model_steps, pair, run, stats_of, wave_trace)

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cfg in (get_config(arch), get_config(arch).reduced()):
        jcfg = jax_config(arch) if "smoke" not in cfg.name \
            else jax_config(arch).reduced()
        for T in (1, 7, 8, 33, 64, 255, 1024, 4096):
            for cf in (0.5, 1.25, 4.0):
                c = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cf))
                j = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=cf))
                assert TMoE.capacity(c, T) == JMoE.capacity(j, T)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.moe.num_experts))
         / np.sqrt(cfg.d_model)).astype(np.float32)
    jw, je, jaux = JMoE.route(jcfg, jnp.asarray(w), jnp.asarray(x))
    tw, te, taux = TMoE.route(cfg, torch.from_numpy(w), torch.from_numpy(x))
    assert np.array_equal(np.asarray(je), te.numpy())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(float(taux) - float(jaux)) < 1e-6


def _experts(rng, G, T, k, E):
    """Distinct experts per token, as top-k gives them."""
    return np.stack([np.stack([rng.permutation(E)[:k] for _ in range(T)])
                     for _ in range(G)]).astype(np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_dispatch_indices_bitwise(masked):
    """Two groups, a capacity (8) well under the 20 assignments each
    expert gets, so FIFO order decides who is dropped; with a validity
    mask, invalid tokens take no slot and let later tokens in."""
    cfg = get_config(ARCHS[0]).reduced()
    jcfg = jax_config(ARCHS[0]).reduced()
    rng = np.random.default_rng(1)
    G, T, k, E, C = 2, 40, 2, cfg.moe.num_experts, 8
    experts = _experts(rng, G, T, k, E)
    valid = rng.random((G, T)) < 0.7 if masked else None
    js, jb = JMoE._dispatch_indices(
        jcfg, jnp.asarray(experts), C,
        None if valid is None else jnp.asarray(valid))
    ts, tb = TMoE._dispatch_indices(
        cfg, torch.from_numpy(experts), C,
        None if valid is None else torch.from_numpy(valid))
    assert ts.dtype == tb.dtype == torch.int32
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert (ts.numpy() == C).sum() > 0  # drops happened
    if masked:
        assert (ts.numpy()[~valid] == C).all()


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf):
    """One layer's MoE FFN in fp32, with a validity mask; at capacity
    factor 0.5 tokens are dropped."""
    jcfg = jax_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JMoE.init_moe(jcfg, jax.random.PRNGKey(2)))
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    rng = np.random.default_rng(3)
    B, S = 4, 16  # 128 assignments over 4 experts: 16 slots at 0.5
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    valid = rng.random((B, S)) < 0.8
    jo, jaux = JMoE.apply_moe(jcfg, jp, jnp.asarray(x),
                              valid=jnp.asarray(valid))
    to, taux = TMoE.apply_moe(cfg, tp, torch.from_numpy(x),
                              valid=torch.from_numpy(valid))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-6
    # Whether the tight factor dropped a valid token, from the indices.
    C = TMoE.capacity(cfg, B * S)
    _, experts, _ = TMoE.route(cfg, tp["router"],
                               torch.from_numpy(x).reshape(B * S, -1))
    slot, _ = TMoE._dispatch_indices(cfg, experts.reshape(1, B * S, -1), C,
                                     torch.from_numpy(valid).reshape(1, -1))
    dropped = (slot[0].numpy() == C)[valid.reshape(-1)].any()
    assert dropped == (cf < 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_steps_match_jax(arch):
    models = pair(arch)
    assert models[3]["blocks"]["moe"]["router"].dtype == torch.float32
    steps, _, _ = model_steps(models)
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=what)


def test_router_stays_fp32():
    """The router is fp32 in the port's init at any dtype and through
    ``params_from_numpy`` without a dtype; an asked-for dtype casts it
    with everything else."""
    cfg = get_config(ARCHS[0]).reduced()
    jcfg = jax_config(ARCHS[0]).reduced()
    p = TM.init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    assert p["blocks"]["moe"]["router"].dtype == torch.float32
    assert p["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    q = params_from_numpy(cfg, tree, device="cpu")
    assert q["blocks"]["moe"]["router"].dtype == torch.float32
    assert q["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    assert q["blocks"]["moe"]["shared"]["w_down"].dtype == torch.bfloat16
    r = params_from_numpy(cfg, tree, device="cpu", dtype=torch.float32)
    assert r["blocks"]["moe"]["w_up"].dtype == torch.float32


@pytest.fixture(scope="module")
def models():
    return pair(ARCHS[0])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_matches_jax(models, kv_dtype):
    (jout, jstats), (tout, tstats) = both_engines(
        models, mixed_trace(), kv_dtype=kv_dtype, **MIXED_KW)
    assert tout == jout
    assert stats_of(tstats, STATS) == stats_of(jstats, STATS)
    assert tstats.cached_prompt_tokens > 0


def test_wave_mode_matches_jax(models):
    (jout, jstats), (tout, tstats) = both_engines(
        models, wave_trace(), max_batch=2, mode="wave")
    assert tout == jout
    assert stats_of(tstats, WAVE_STATS) == stats_of(jstats, WAVE_STATS)


def test_engine_invariant_to_cache_chunk_and_decode_steps(models):
    _, _, tcfg, tparams = models
    reqs = mixed_trace()

    def port(**kw):
        return run(ServingEngine(tcfg, tparams, max_len=MAX_LEN, eos_id=-1,
                                 device="cpu", **dict(MIXED_KW, **kw)), reqs)

    base = port()
    for v in (dict(prefix_cache=False), dict(prefill_chunk=4),
              dict(prefill_chunk=None), dict(decode_steps=4)):
        assert port(**v) == base, v
