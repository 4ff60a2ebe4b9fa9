"""The port's async serving front (``AsyncFrontend``, the open-loop driver,
``ReplicaRouter``, fault injection, warmup) against the JAX package's, and
its own contracts over the port's engine.

Against JAX (tinyllama-1.1b reduced, fp32 parameters carried across,
greedy): the streams of the port's frontend equal the JAX frontend's on the
same trace, with speculation off and on; the circuit breaker walks the same
states tick for tick under the same pressure; the router orders replicas
the same way (affinity, round robin, spillover) over fleets in the same
state; ``FaultPlan.seeded`` draws the same events; the warmup's coverage
rule picks the same prompt lengths.

Within the port: streams equal ``engine.run()``, cancel and a stop
without drain release every block, backpressure rejects at exactly the
queue depth, a failover mid-stream is bit-identical to a solo engine,
``aclose`` releases every block, ``warmup_prefill`` resets the stats, the
``on_token`` hook sees every token in order, and the launcher's async
two-replica path runs to its summary.
"""
import asyncio
import dataclasses
import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import frontend as jfrontend  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import warmup as jwarmup  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import EngineStats, ServingEngine  # noqa
from repro_torch.serving.faults import FaultPlan, FaultyEngine  # noqa: E402
from repro_torch.serving.frontend import (AsyncFrontend,  # noqa: E402
                                          CircuitBreaker, RejectedError)
from repro_torch.serving.openloop import TraceItem  # noqa: E402
from repro_torch.serving.router import (ReplicaHealth,  # noqa: E402
                                        ReplicaRouter, run_open_loop_router)
from repro_torch.serving.warmup import (trace_prompt_lens,  # noqa: E402
                                        warmup_prefill)

KW = dict(max_batch=3, max_len=tp.MAX_LEN, eos_id=-1, block_size=4,
          prefill_chunk=8)
FLEET_KW = dict(max_batch=3, max_len=tp.MAX_LEN, block_size=8, num_blocks=24,
                prefill_chunk=8, eos_id=-1)


@pytest.fixture(scope="module")
def models():
    return tp.pair("tinyllama-1.1b")


def _port(models, **over):
    _, _, tcfg, tparams = models
    return ServingEngine(tcfg, tparams, device="cpu", **{**FLEET_KW, **over})


def _jax(models, **over):
    jcfg, jparams, _, _ = models
    return JaxEngine(jcfg, jparams, **{**FLEET_KW, **over})


def _wire(fe):
    """What ``start()`` does, minus the pump: for manual stepping."""
    fe.engine.on_token = fe._on_token
    return fe


def _step_until(fe, pred, limit=120):
    for _ in range(limit):
        fe._dispatch(fe._tick())
        if pred():
            return
    raise AssertionError(f"condition not reached in {limit} ticks")


def _prompts(vocab, seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=8)
    cyc = rng.integers(1, vocab, size=2)
    return [np.concatenate([shared, rng.integers(1, vocab, size=n)])
            for n in (3, 7, 5)] + [np.tile(cyc, 5)], (4, 6, 3, 6)


async def _stream_all(fe_cls, eng, prompts, budgets):
    async with fe_cls(eng, max_queue_depth=8) as fe:
        streams = [await fe.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        return [await s.collect() for s in streams], fe.stats


# -- streams -----------------------------------------------------------------


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_streams_equal_run_and_jax_frontend(models, spec):
    """The frontend adds admission control, never arithmetic: each
    stream equals the port engine's ``run()`` on the same trace, and the
    JAX frontend's stream over the JAX engine."""
    prompts, budgets = _prompts(models[2].vocab_size)
    kw = dict(KW, spec_decode=spec)
    outs = {}
    for name, make, fe_cls in (
            ("port", lambda: _port(models, **kw), AsyncFrontend),
            ("jax", lambda: _jax(models, **kw), jfrontend.AsyncFrontend)):
        eng = make()
        uids = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        ref = eng.run()
        got, stats = asyncio.run(_stream_all(fe_cls, eng, prompts, budgets))
        assert got == [ref[u] for u in uids]
        assert stats.accepted == stats.completed == len(prompts)
        eng._alloc.check_invariants()
        assert eng.live_blocks == 0
        outs[name] = got
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("arch,prefix_cache,spec", [
    ("tinyllama-1.1b", False, "off"),
    ("qwen2-moe-a2.7b", True, "ngram"),
    ("internvl2-26b", True, "ngram"),
])
def test_stream_equals_run_across_families(arch, prefix_cache, spec):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, device="cpu", prefix_cache=prefix_cache,
                        spec_decode=spec, **KW)
    prompts, budgets = _prompts(cfg.vocab_size, seed=6)
    uids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    ref = eng.run()
    got, _ = asyncio.run(_stream_all(AsyncFrontend, eng, prompts, budgets))
    assert got == [ref[u] for u in uids]
    assert eng.live_blocks == 0 and eng.pool_saturation == 0.0


def test_on_token_sees_every_token_in_order(models):
    """Decode, speculation and the wave path all announce each token once,
    in order, before the request finishes."""
    prompts, budgets = _prompts(models[2].vocab_size, seed=8)
    for kw in ({}, {"spec_decode": "ngram"}, {"mode": "wave"}):
        eng = _port(models, **kw)
        seen = {}
        eng.on_token = lambda u, t: seen.setdefault(u, []).append(t)
        uids = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        out = eng.run()
        assert {u: seen[u] for u in uids} == {u: out[u] for u in uids}, kw


def test_pool_saturation_and_live_blocks(models):
    eng = _port(models)
    assert eng.live_blocks == 0 and eng.pool_saturation == 0.0
    eng.submit(np.arange(1, 12), max_new_tokens=4)
    eng.step()
    assert eng.live_blocks == eng._alloc.live_blocks > 0
    assert eng.pool_saturation == eng.live_blocks / eng._alloc.num_blocks
    eng.run()
    assert eng.live_blocks == 0
    wave = _port(models, mode="wave")
    assert wave.live_blocks == 0 and wave.pool_saturation == 0.0


# -- cancellation, stop, backpressure ----------------------------------------


def test_cancel_mid_stream_releases_blocks(models):
    eng = _port(models, max_batch=2, spec_decode="ngram")
    pa, pb = np.arange(1, 10), np.arange(2, 8)
    ra = eng.submit(pa, max_new_tokens=16)
    rb = eng.submit(pb, max_new_tokens=6)
    expected = eng.run()

    async def main():
        async with AsyncFrontend(eng, max_queue_depth=4) as fe:
            a = await fe.submit(pa, max_new_tokens=16)
            b = await fe.submit(pb, max_new_tokens=6)
            got = []
            async for tok in a:
                got.append(tok)
                if len(got) == 3:
                    break
            await a.aclose()
            return fe.stats, got, await b.collect()

    stats, got, out_b = asyncio.run(main())
    assert got == expected[ra][:3]
    assert out_b == expected[rb]
    assert stats.cancelled == 1 and stats.completed == 1
    assert eng.stats.cancellations == 1
    eng._alloc.check_invariants()
    assert eng.live_blocks == 0 and not eng._spec_next


def test_stop_without_drain_cancels_inflight(models):
    eng = _port(models)

    async def main():
        fe = AsyncFrontend(eng, max_queue_depth=4)
        await fe.start()
        a = await fe.submit(np.arange(1, 9), max_new_tokens=20)
        b = await fe.submit(np.arange(3, 9), max_new_tokens=20)
        await a.__anext__()  # the pump is decoding
        await fe.stop(drain=False)
        await a.collect()
        await b.collect()
        return fe.stats, a, b

    stats, a, b = asyncio.run(main())
    assert stats.cancelled == 2 and stats.completed == 0
    assert not a.done and not b.done
    eng._alloc.check_invariants()
    assert eng.live_blocks == 0


def test_backpressure_rejects_at_exact_depth(models):
    eng = _port(models)
    prompt = np.arange(1, 8)

    async def main():
        fe = AsyncFrontend(eng, max_queue_depth=3)
        streams = [await fe.submit(prompt, max_new_tokens=2)
                   for _ in range(3)]
        assert fe.queue_depth == 3
        with pytest.raises(RejectedError) as ei:
            await fe.submit(prompt, max_new_tokens=2)
        assert ei.value.kind == "backpressure"
        assert fe.stats.rejected_backpressure == 1 and fe.queue_depth == 3
        await fe.start()
        outs = [await s.collect() for s in streams]
        assert fe.queue_depth == 0
        late = await (await fe.submit(prompt, max_new_tokens=2)).collect()
        await fe.stop()
        return outs, late

    outs, late = asyncio.run(main())
    assert outs[0] == outs[1] == outs[2] == late
    assert eng.live_blocks == 0


def test_frontend_rejects_wave_engines(models):
    with pytest.raises(ValueError, match="continuous"):
        AsyncFrontend(_port(models, mode="wave"))


# -- the circuit breaker -----------------------------------------------------


def _breaker_walk(cls, knobs, script):
    """Run ``script`` (("tick", preemptions, saturation) | ("allow",) |
    ("probe", ok) | ("abandon",)) through a breaker; the observable state
    after every operation."""
    br = cls(**knobs)
    seen = []
    for op in script:
        if op[0] == "tick":
            br.record_tick(op[1], op[2])
            out = None
        elif op[0] == "allow":
            out = br.allow()
        elif op[0] == "probe":
            br.record_probe_end(ok=op[1])
            out = None
        else:
            br.abandon_probe()
            out = None
        seen.append((br.state, out, br.opens, br.shed))
    return seen, [tuple(t[-2:]) for t in br.transitions]


def _scripts():
    yield dict(window=4, trip_pressure=2, sat_threshold=1.0,
               cooldown_ticks=3, probes=2), [
        ("allow",), ("tick", 0, 0.0), ("tick", 1, 0.0), ("tick", 0, 1.0),
        ("allow",), ("tick", 0, 0.0), ("tick", 0, 0.0), ("tick", 0, 0.0),
        ("allow",), ("allow",), ("allow",), ("probe", True),
        ("probe", True), ("tick", 1, 0.0), ("allow",)]
    rng = np.random.default_rng(11)
    for knobs in (dict(window=4, trip_pressure=1, cooldown_ticks=1,
                       probes=1),
                  dict(window=6, trip_pressure=3, sat_threshold=0.5,
                       cooldown_ticks=2, probes=2)):
        script = []
        for _ in range(200):
            r = rng.random()
            if r < 0.5:
                script.append(("tick", int(rng.random() < 0.3),
                               float(rng.random())))
            elif r < 0.8:
                script.append(("allow",))
            elif r < 0.95:
                script.append(("probe", bool(rng.random() < 0.7)))
            else:
                script.append(("abandon",))
        yield knobs, script


def test_breaker_walk_matches_jax():
    """closed -> open -> half_open -> closed and back, tick for tick, on a
    scripted cycle and on seeded random pressure sequences."""
    for knobs, script in _scripts():
        ours = _breaker_walk(CircuitBreaker, knobs, script)
        ref = _breaker_walk(jfrontend.CircuitBreaker, knobs, script)
        assert ours == ref
        states = {s for s, *_ in ours[0]}
        assert states == {"closed", "open", "half_open"}
    with pytest.raises(ValueError, match="never fire"):
        CircuitBreaker(window=4, trip_pressure=5)


# -- the router ---------------------------------------------------------------


def _fleet_orders(router_cls, engines, system, vocab, policy):
    """Warm replica 2's prefix cache, queue work on replica 0, then the
    order of placement preference for a run of prompts."""
    warm = engines[2]
    warm.submit(np.concatenate([system, [7, 8]]), max_new_tokens=2)
    warm.run()
    engines[0].submit(np.arange(1, 9), max_new_tokens=2)
    r = router_cls(engines, policy=policy)
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([system, [9, 10, 11]]),
               rng.integers(1, vocab, size=6),
               np.concatenate([system[:8], [4, 4, 4]]),
               np.concatenate([system, rng.integers(1, vocab, size=9)]),
               rng.integers(1, vocab, size=12)]
    orders = [r._order(p, None) for p in prompts]
    loads = [r._load(i) for i in range(len(engines))]
    return orders, loads, dataclasses.asdict(r.stats)


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_router_placements_match_jax(models, policy):
    vocab = models[2].vocab_size
    system = np.random.default_rng(4).integers(1, vocab, size=16)
    ours = _fleet_orders(ReplicaRouter, [_port(models) for _ in range(3)],
                         system, vocab, policy)
    ref = _fleet_orders(jrouter.ReplicaRouter,
                        [_jax(models) for _ in range(3)], system, vocab,
                        policy)
    assert ours == ref
    if policy == "affinity":
        assert ours[0][0][0] == 2 and ours[2]["affinity_hits"] >= 2


def _spill(router_cls, error_cls, engines):
    r = router_cls(engines, policy="round_robin")

    async def reject(*a, **k):
        raise error_cls("full", kind="backpressure")

    async def accept(*a, **k):
        return SimpleNamespace(uid=1)

    r.frontends[0].submit = reject
    r.frontends[1].submit = accept
    uids = [asyncio.run(r.submit(np.arange(1, 6), max_new_tokens=2)).uid
            for _ in range(3)]
    return uids, dataclasses.asdict(r.stats)


def test_router_spillover_matches_jax(models):
    ours = _spill(ReplicaRouter, RejectedError,
                  [_port(models) for _ in range(2)])
    ref = _spill(jrouter.ReplicaRouter, jfrontend.RejectedError,
                 [_jax(models) for _ in range(2)])
    assert ours == ref and ours[1]["spillovers"] >= 1


# -- faults and failover -----------------------------------------------------


def test_seeded_fault_plans_match_jax():
    for seed, kw in itertools.product(
            range(12), ({}, {"crash_p": 0.5}, {"crash_p": 1.0,
                                               "horizon": 16})):
        ours = FaultPlan.seeded(seed, **kw)
        ref = jfaults.FaultPlan.seeded(seed, **kw)
        assert [dataclasses.astuple(e) for e in ours.events] \
            == [dataclasses.astuple(e) for e in ref.events]
        assert ours.describe() == ref.describe()


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_failover_midstream_is_bit_identical(models, spec):
    """A replica crashes after streaming part of a request: the request
    moves to the other replica as prompt + emitted tokens and the whole
    stream equals a solo engine's output."""
    prompt, budget = np.arange(1, 9), 6
    ref = _port(models, spec_decode=spec)
    uid = ref.submit(prompt, max_new_tokens=budget)
    ref_out = ref.run()[uid]
    fx = FaultyEngine(_port(models), FaultPlan.crash_at(3))
    r = ReplicaRouter([fx, _port(models, spec_decode=spec)],
                      policy="round_robin",
                      health_factory=lambda: ReplicaHealth(
                          crash_threshold=2))
    fe0, fe1 = (_wire(fe) for fe in r.frontends)
    s = asyncio.run(r.submit(prompt, max_new_tokens=budget))
    for _ in range(6):
        fe0._dispatch(fe0._tick())
    assert r.health[0].state == "dead"
    assert 0 < len(s._ticket.emitted) < budget
    assert asyncio.run(r.fail_over_dead()) == 1
    assert fx.engine.live_blocks == 0
    _step_until(fe1, lambda: s.done)
    assert asyncio.run(s.collect()) == ref_out
    asyncio.run(r.aclose())
    assert all(e.live_blocks == 0 for e in r.engines)


def test_crash_one_replica_open_loop_is_bit_identical(models):
    vocab = models[2].vocab_size
    rng = np.random.default_rng(7)
    trace = [TraceItem(arrival_s=0.01 * i,
                       prompt=rng.integers(1, vocab, size=8).astype(np.int32),
                       max_new_tokens=10) for i in range(6)]
    clean, _ = run_open_loop_router([_port(models) for _ in range(3)],
                                    trace, policy="round_robin")
    engines = [FaultyEngine(_port(models, spec_decode="ngram"),
                            FaultPlan.crash_at(6)),
               _port(models, spec_decode="ngram"), _port(models)]
    chaos, _ = run_open_loop_router(engines, trace, policy="round_robin")
    assert engines[0].crashed
    assert [r.status for r in chaos.records] == ["completed"] * 6
    assert [r.tokens for r in chaos.records] \
        == [r.tokens for r in clean.records]
    ft = chaos.summary(slo_ttft_s=10.0)["fault_tolerance"]
    assert ft["replica_deaths"] == 1 and ft["failovers"] >= 1
    assert all(e.live_blocks == 0 for e in engines)


def test_aclose_releases_every_block(models):
    r = ReplicaRouter([_port(models) for _ in range(2)],
                      policy="round_robin")
    for fe in r.frontends:
        _wire(fe)
    streams = [asyncio.run(r.submit(np.arange(1 + k, 9 + k),
                                    max_new_tokens=20)) for k in range(3)]
    for fe in r.frontends:
        fe._dispatch(fe._tick())
        fe._dispatch(fe._tick())
    assert any(e.live_blocks > 0 for e in r.engines)
    asyncio.run(r.aclose())
    assert all(e.live_blocks == 0 for e in r.engines)
    for s in streams:
        assert len(asyncio.run(s.collect())) <= 20


# -- warmup and the launcher -------------------------------------------------


def test_warmup_prefill_resets_stats_and_matches_jax_coverage(models):
    vocab = models[2].vocab_size
    rng = np.random.default_rng(2)
    trace = [TraceItem(arrival_s=0.0, prompt=rng.integers(1, vocab, size=n),
                       max_new_tokens=m)
             for n, m in ((4, 4), (9, 8), (17, 3), (28, 3))]
    eng = _port(models, spec_decode="ngram")
    lens = trace_prompt_lens(trace, eng, extra=(16,))
    shape = SimpleNamespace(prefill_chunk=eng.prefill_chunk,
                            max_len=eng.max_len)
    assert lens == jwarmup.trace_prompt_lens(trace, shape, extra=(16,))
    warmup_prefill(eng, vocab, prompt_lens=lens)
    assert eng.stats == EngineStats()
    assert eng.live_blocks == 0 and not eng.has_pending_work()
    eng._alloc.check_invariants()


def test_launcher_async_two_replicas_with_spec_and_a_crash(capsys):
    out = serve.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--frontend", "async", "--replicas", "2", "--spec-decode", "ngram",
        "--fault-crash-replica", "1", "--fault-crash-tick", "6",
        "--requests", "8", "--max-new", "8", "--temperature", "0"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert out["requests"] == 8 and out["completed"] == 8
    ft = out["fault_tolerance"]
    assert ft["replica_deaths"] == 1 and ft["failovers"] >= 1
    assert out["routing"]["live_blocks"] == [0, 0]
    assert out["fault_plans"] == {"1": "crash@6"}
    with pytest.raises(SystemExit, match="--frontend async"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                    "cpu", "--replicas", "2"])
