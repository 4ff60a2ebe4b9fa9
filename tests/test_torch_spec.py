"""Speculative decoding in the port against the JAX engine, and within the
port against itself.

Cross-framework (``tests/torch_parity.py``: reduced configs, the JAX
package's parameters cast to fp32 and carried across, plain attention,
``eos_id=-1``): with ``spec_decode="ngram"`` the port's greedy outputs and
its ``spec_passes`` / ``spec_proposed`` / ``spec_accepted`` equal the JAX
engine's, for dense, moe and vlm (behind a random image and behind the zero
stub), at ``spec_k`` 1 and 4.  ``NgramProposer`` proposes what JAX's does.

Within the port (bf16 params): outputs with speculation on are bit for
bit those with it off, greedy and stochastic (the verify pass samples each
position with the positional key decode would use), across prefix cache
off, chunked prefill, preemption under a tight pool, an int8 pool, every
``spec_k``, EOS inside a draft and budget edges.  Pool invariants hold
after every run, and the verify pass runs no decode step and scores only
live lanes (no row of length 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402
from repro.serving.spec import NgramProposer as JaxNgram  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paged import BlockStore  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402
from repro_torch.serving.spec import (SPEC_DECODE_MODES,  # noqa: E402
                                      NgramProposer, make_proposer)

SPEC = ("spec_passes", "spec_proposed", "spec_accepted")
ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "internvl2-26b")
STOCHASTIC = SamplerConfig(temperature=0.8, top_k=10)


# -- the proposer ------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _histories():
    rng = np.random.default_rng(0)
    out = [[], [7], [7, 7], [5, 6, 7, 9, 5, 6, 7], [1, 2, 8, 1, 2, 4, 1, 2]]
    for n in (5, 12, 30):
        out.append(list(rng.integers(0, 6, size=n)))  # small alphabet
        out.append(list(rng.integers(0, 1000, size=n)))
    for period in (1, 2, 3, 5):
        cyc = list(rng.integers(0, 50, size=period))
        out.append((cyc * 8)[:int(rng.integers(period + 1, 8 * period + 1))])
    return out


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (2, 2), (4, 2)])
def test_ngram_proposer_matches_jax(max_n, min_n):
    """Seeded random histories (small and large alphabets) and periodic
    ones: the same drafts as the JAX proposer for every k."""
    ours, ref = NgramProposer(max_n, min_n), JaxNgram(max_n, min_n)
    for h in _histories():
        for k in (0, 1, 2, 4, 7):
            assert ours.propose(h, k) == ref.propose(h, k), (h, k)


def test_make_proposer_and_constructor_checks():
    assert SPEC_DECODE_MODES == ("off", "ngram")
    assert make_proposer("off") is None
    p = make_proposer("ngram")
    assert isinstance(p, NgramProposer) and (p.max_n, p.min_n) == (3, 1)
    assert p.propose([5, 6, 7, 9, 5, 6, 7], 3) == [9, 5, 6]
    assert p.propose([7] * 6, 3) == [7, 7, 7]
    with pytest.raises(ValueError):
        make_proposer("oracle")
    with pytest.raises(ValueError):
        NgramProposer(max_n=1, min_n=2)
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="spec_decode"):
        ServingEngine(cfg, params, spec_decode="oracle", device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(cfg, params, spec_decode="ngram", spec_k=0,
                      device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(cfg, params, mode="wave", spec_decode="ngram",
                      device="cpu")
    for shape in ((2, 2), (1, 2)):
        assert ServingEngine(cfg, params, spec_decode="ngram", device="cpu",
                             mesh=make_mesh(shape, ("data", "model"), "cpu")
                             ).mode == "continuous"
    f8 = ServingEngine(cfg, params, spec_decode="ngram", kv_dtype="f8",
                       device="cpu")
    assert f8._cache["k"].dtype == torch.float8_e4m3fn \
        and f8.spec_decode == "ngram"
    eng = ServingEngine(cfg, params, spec_decode="ngram", spec_k=3,
                        device="cpu")
    assert (eng.spec_decode, eng.spec_k) == ("ngram", 3)


# -- against the JAX engine --------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jax cfg, jax params, port cfg, port params), made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tp.pair(arch)
        return cache[arch]
    return get


def _spec_trace(cfg, seed=0):
    """Random prompts, a periodic one (long n-gram matches: drafts get
    accepted) and, on a vlm config, a random image on one request."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12))),
             m, None) for m in (6, 8, 5)]
    cyc = rng.integers(1, cfg.vocab_size, size=3)
    reqs.append((np.tile(cyc, 4), 8, None))
    if cfg.family == "vlm":
        img = rng.standard_normal((cfg.num_patches, cfg.d_model)) \
            .astype(np.float32)
        reqs[1] = (reqs[1][0], reqs[1][1], img)
    return reqs


@pytest.mark.parametrize("spec_k", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_engine_matches_jax(pairs, arch, spec_k):
    """Greedy tokens, the spec counters and the scheduler's counters equal
    the JAX spec engine's on the same trace (a vlm lane speculates right
    after its first chunk, behind the patch prefix)."""
    models = pairs(arch)
    reqs = _spec_trace(models[2])
    (jout, js), (tout, ts) = tp.both_engines(
        models, reqs, max_batch=3, spec_decode="ngram", spec_k=spec_k)
    assert tout == jout
    assert tp.stats_of(ts, SPEC + tp.STATS) == tp.stats_of(js, SPEC + tp.STATS)
    assert ts.spec_passes > 0 and ts.spec_proposed > 0


# -- within the port ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tinyllama-1.1b").reduced()
    return cfg, M.init_params(cfg, 0, device="cpu")


def _requests(cfg, n=3, seed=0, budgets=(6, 8, 5)):
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12))),
             budgets[i % len(budgets)]) for i in range(n)]
    cyc = rng.integers(1, cfg.vocab_size, size=2)
    return reqs + [(np.tile(cyc, 5), budgets[0])]


def _run(cfg, params, reqs, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", tp.MAX_LEN)
    kw.setdefault("eos_id", -1)
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    uids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    out = eng.run()
    eng._alloc.check_invariants()
    assert eng.live_blocks == 0
    return [out[u] for u in uids], eng.stats


KNOBS = {
    "default": {},
    "prefix_off": {"prefix_cache": False},
    "chunked": {"prefill_chunk": 4, "block_size": 4},
    "int8": {"kv_dtype": "int8"},
    "preempt": {"num_blocks": 8, "block_size": 4},
    "spec_k1": {"spec_k": 1},
    "spec_k2": {"spec_k": 2},
}


@pytest.mark.parametrize("sampling", ["greedy", "stochastic"])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_spec_bit_identical_to_off(tiny, knob, sampling):
    """Every scheduling knob crossed with speculation, greedy and
    stochastic: the tokens do not move."""
    cfg, params = tiny
    kw = dict(KNOBS[knob])
    spec_k = kw.pop("spec_k", 4)
    if sampling == "stochastic":
        kw["sampler"] = STOCHASTIC
    reqs = _requests(cfg, seed=3)
    off, _ = _run(cfg, params, reqs, **kw)
    on, s = _run(cfg, params, reqs, spec_decode="ngram", spec_k=spec_k,
                 **kw)
    assert on == off
    assert s.spec_passes > 0
    if knob == "preempt":
        assert s.preemptions >= 1, "a tight pool should preempt under spec"


@pytest.mark.parametrize("sampling", ["greedy", "stochastic"])
@pytest.mark.parametrize("arch", ARCHS[1:])
def test_spec_bit_identical_moe_vlm(arch, sampling):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    kw = {"sampler": STOCHASTIC} if sampling == "stochastic" else {}
    reqs = _requests(cfg, seed=4)
    off, _ = _run(cfg, params, reqs, **kw)
    on, s = _run(cfg, params, reqs, spec_decode="ngram", **kw)
    assert on == off and s.spec_passes > 0


def test_spec_matches_decode_steps_window(tiny):
    cfg, params = tiny
    reqs = _requests(cfg, seed=5)
    off, _ = _run(cfg, params, reqs, decode_steps=3)
    on, _ = _run(cfg, params, reqs, spec_decode="ngram", spec_k=4)
    assert on == off


def test_spec_budget_edges_and_eos_inside_draft(tiny):
    """A chunk clamps to the remaining budget (budget 1 drafts nothing),
    and an EOS inside an accepted draft prefix retires the request where
    plain decode would."""
    cfg, params = tiny
    rng = np.random.default_rng(9)
    cyc = rng.integers(1, cfg.vocab_size, size=2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (5, 8)] \
        + [np.tile(cyc, 4)]
    for budget in (1, 2):
        reqs = [(p, budget) for p in prompts]
        off, _ = _run(cfg, params, reqs)
        on, s = _run(cfg, params, reqs, spec_decode="ngram", spec_k=4)
        assert on == off
        assert all(len(t) == budget for t in on)
        if budget == 1:
            assert s.spec_proposed == 0
    reqs = [(p, 8) for p in prompts]
    off, _ = _run(cfg, params, reqs)
    for eos in {off[0][3], off[2][4]}:
        off_eos, _ = _run(cfg, params, reqs, eos_id=eos)
        on_eos, _ = _run(cfg, params, reqs, eos_id=eos, spec_decode="ngram",
                         spec_k=4)
        assert on_eos == off_eos
        assert any(t and t[-1] == eos and len(t) < 8 for t in off_eos)


def test_spec_stats_accounting(tiny):
    """One verify pass per step, acceptance within proposals, rejected
    drafts (the truncate path ran) and accepted ones."""
    cfg, params = tiny
    reqs = _requests(cfg, seed=7, budgets=(8, 8, 8))
    on, s = _run(cfg, params, reqs, spec_decode="ngram", spec_k=4)
    assert s.spec_passes == s.decode_steps > 0
    assert 0 < s.spec_accepted < s.spec_proposed
    assert s.generated_tokens == sum(len(t) for t in on)
    assert 0.0 < s.spec_acceptance_rate < 1.0


def test_verify_runs_no_decode_step_and_only_live_rows(tiny, monkeypatch):
    """Steady-state speculation scores decode positions through
    ``prefill_slots`` only: no ``decode_step`` call, every verify row has
    spec_k + 1 columns and a length of at least 1."""
    cfg, params = tiny
    rows = []
    real = M.prefill_slots

    def spy(cfg_, params_, cache, tokens, lengths, tables, start=None,
            patch_embeds=None, all_logits=False, **kw):
        if all_logits:
            rows.append((tuple(tokens.shape), lengths.tolist()))
        return real(cfg_, params_, cache, tokens, lengths, tables,
                    start=start, patch_embeds=patch_embeds,
                    all_logits=all_logits, **kw)

    def no_decode(*a, **k):
        raise AssertionError("decode_step ran under speculation")

    monkeypatch.setattr(M, "prefill_slots", spy)
    monkeypatch.setattr(M, "decode_step", no_decode)
    _, s = _run(cfg, params, _requests(cfg, seed=3), spec_decode="ngram",
                spec_k=3)
    assert len(rows) == s.spec_passes > 0
    assert all(shape[1] == 4 and 1 <= min(lens) and len(lens) == shape[0]
               for shape, lens in rows)
    assert any(len(lens) < 3 for _, lens in rows)  # a retired lane left


def test_truncate_keeps_invariants():
    """The rollback path alone: drafted tokens past a full block, a
    shared prefix block, truncation to inside the shared prefix's tail."""
    st = BlockStore(12, 4, 2, 6)
    content = list(range(1, 9))
    st.admit(0)
    st.grow(0, 8)
    st.commit_full(0, content)
    st.admit(1, content=content + [9], max_cached_tokens=8)
    assert st.seq_len(1) == 8
    st.grow(1, 14)
    st.check_invariants()
    freed = st.truncate(1, 9)
    st.check_invariants()
    assert len(freed) == 1 and st.seq_len(1) == 9
    st.truncate(1, 8)
    st.check_invariants()
    assert st.ref_count(st.block_table()[0][0]) == 2
    for slot in (0, 1):
        st.release(slot)
    st.check_invariants()
    assert st.live_blocks == 0
