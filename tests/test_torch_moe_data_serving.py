"""The moe family served over a (data, model) mesh with data above 1, on
the CPU: reduced qwen2-moe-a2.7b (a shared expert) and
qwen3-moe-235b-a22b on meshes naming the CPU d x m times — (2, 1), (2, 2),
(4, 1), and d = 3 over 4 lanes (uneven: every data place holds every
lane, the 4 experts whole over data).

The oracle is the JAX package run meshless under
``repro.parallel.sharding.use_axes`` of the same data and model axes: its
MoE then dispatches in the data axes' groups (``moe._num_groups``) —
contiguous rows of each call, their own capacity and FIFO order — as it
does over a mesh.  Its wave calls route without a mask, which under a
model axis above 1 takes the manual path, whose shard_map needs a real
mesh; that path's groups are the data shards' contiguous rows, the same
groups, so the wave oracle runs under the data axes with ``model`` 1.
The reduced configs' capacity factor 4.0 drops nothing and hides the
grouping, so every check also runs at a tight factor (0.5), where
assignments are dropped.

  * placement: each place holds its E / d experts' d / m slice where E
    divides d, the experts whole over data (cut on f) where it does not;
    every placed leaf gathers back bit for bit;
  * model steps: a first chunk over four lanes, two continuation
    cohorts (lanes 0 and 1, one data place at d = 2; lanes 3, 1, 2), a
    decode step with a dead lane, a verify-shaped continuation over
    three live lanes of four, a wave prefill and decode — within 1e-5
    of the logits' range of the oracle, the pool replicas bit for bit
    among themselves, the bytes of every paged call equal to
    ``dryrun.serve_collectives``;
  * the engine: greedy tokens and ``EngineStats`` equal the oracle
    engine's (a subclass of the JAX engine whose ``_scoped`` uses the
    axis hint), paged — bf16 and int8 pools, prefix hits across data
    places, a preemption, speculation off and on — and in waves;
  * controls: slots formed by data place instead of the reference's
    groups, and the experts' outputs returned to the wrong data place,
    each leave the limit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import STATS, WAVE_STATS, pair, run, stats_of  # noqa: E402

#: Over a mesh vs the oracle, a share of the logits' range.
TOL = 1e-5
ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
#: The reduced configs' capacity factor (None) and a tight one.
FACTORS = (None, 0.5)
MESHES = ((2, 1), (2, 2), (4, 1), (3, 1))
#: Lanes of the model steps and the engine.
W = 4
ENGINE_KW = dict(max_batch=W, block_size=4, prefill_chunk=8, max_len=32,
                 eos_id=-1, num_blocks=14)
WAVE_KW = dict(max_batch=W, max_len=32, eos_id=-1)
SCHED = STATS + ("spec_passes", "spec_proposed", "spec_accepted",
                 "peak_live_blocks", "kv_block_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


@functools.lru_cache(maxsize=None)
def models(arch, factor=None, kv_dtype=None):
    """``pair(arch)`` with the capacity factor and pool dtype changed in
    both packages' configs (the weights do not depend on them)."""
    jcfg, jparams, tcfg, tparams = base(arch)
    for name, val in (("capacity_factor", factor), ("kv_dtype", kv_dtype)):
        if val is None:
            continue
        if name == "kv_dtype":
            jcfg = dataclasses.replace(jcfg, kv_dtype=val)
            tcfg = dataclasses.replace(tcfg, kv_dtype=val)
            continue
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=val))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=val))
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def base(arch):
    return pair(arch)


def hint(d, m):
    return jsh.AxisState((("data", d), ("model", m)))


def within(got, want, what):
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    err = (got - want).abs().max().item()
    span = (want.max() - want.min()).item()
    assert err <= TOL * span, f"{what}: {err} > {TOL} x {span}"
    return err / span


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (3, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_experts_placed_as_the_serve_rule(arch, shape):
    """E over data where E (4) divides d: place (i, j) holds experts [i E
    / d, (i + 1) E / d) and, over ``model``, its d slice (w_gate / w_up
    on dim 1, w_down on dim 2) — no place holds another place's experts;
    at d = 3 the experts are whole over data and cut on f.  The router
    and the shared expert are whole over data.  Every placed leaf
    gathers back to the whole leaf bit for bit."""
    _, _, cfg, params = models(arch)
    d, m = shape
    mesh = mesh_of(shape)
    placed = tsh.place_serve(cfg, params, mesh)
    di, mi = tsh.axis_index(mesh, "data"), tsh.axis_index(mesh, "model")
    moe = placed["blocks"]["moe"]
    whole = params["blocks"]["moe"]
    E, D = cfg.moe.num_experts, cfg.d_model
    for name in ("w_gate", "w_up", "w_down"):
        x = moe[name]
        assert torch.equal(tsh.to_whole(x), whole[name]), name
        if E % d:
            assert x.rows is None, name
            assert x.dim == (3 if name != "w_down" else 2) or m == 1, name
            continue
        assert x.rows == (("data",), 1), name
        for q, part in enumerate(x.parts):
            e = slice(di[q] * E // d, (di[q] + 1) * E // d)
            c = slice(mi[q] * D // m, (mi[q] + 1) * D // m)
            want = whole[name][:, e][:, :, c] if name != "w_down" \
                else whole[name][:, e][..., c]
            assert torch.equal(part, want), (name, q)
    for leaf in ([moe["router"]] + list(moe.get("shared", {}).values())):
        assert leaf.rows is None
        assert leaf.parts[0] is leaf.parts[di.index(d - 1)] or m > 1
    for (path, leaf), (_, w) in zip(flat(placed), flat(params)):
        assert torch.equal(tsh.to_whole(leaf), w), path


def flat(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.flatten(tree)


# ---------------------------------------------------------------------------
# Model steps against the JAX package under the same axis hint
# ---------------------------------------------------------------------------

BS, TW = 4, 12  # block size, table width (blocks a lane)


def step_inputs(vocab):
    """Numpy-seeded inputs of the paged calls over W lanes."""
    rng = np.random.default_rng(1)
    tbl = np.arange(1, 1 + W * TW, dtype=np.int32).reshape(W, TW)
    lens = rng.integers(1, 9, W).astype(np.int32)
    toks = rng.integers(1, vocab, (W, 8)).astype(np.int32)
    toks[np.arange(8)[None] < (8 - lens)[:, None]] = 0
    return dict(rng=rng, tbl=tbl, lens=lens, toks=toks)


def paged_calls(vocab):
    """[(name, lanes, all_lanes, kwargs)]: the calls' numpy inputs, rows
    serving ``lanes`` of W.  Positions advance as the calls write."""
    inp = step_inputs(vocab)
    rng, tbl, pos = inp["rng"], inp["tbl"], inp["lens"].copy()
    calls = [("first chunk", (0, 1, 2, 3), False,
              dict(tokens=inp["toks"], lengths=inp["lens"], tables=tbl))]
    for lanes, P in (((0, 1), 32), ((3, 1, 2), 4)):
        n = len(lanes)
        lens = rng.integers(1, P + 1, n).astype(np.int32)
        toks = rng.integers(1, vocab, (n, P)).astype(np.int32)
        toks[np.arange(P)[None] < (P - lens)[:, None]] = 0
        calls.append((f"cohort {lanes}", lanes, False, dict(
            tokens=toks, lengths=lens, tables=tbl[list(lanes)],
            start=pos[list(lanes)].copy(), all_logits=True)))
        pos[list(lanes)] += lens
    active = np.arange(W) != 2
    calls.append(("decode", tuple(range(W)), False, dict(
        tokens=rng.integers(1, vocab, (W, 1)).astype(np.int32),
        position=pos.copy(), active=active,
        tables=np.where(active[:, None], tbl, 0).astype(np.int32))))
    pos[active] += 1
    live, P = (0, 2, 3), 3
    lens = np.array([3, 2, 3], np.int32)
    toks = rng.integers(1, vocab, (3, P)).astype(np.int32)
    toks[np.arange(P)[None] < (P - lens)[:, None]] = 0
    calls.append(("verify", live, True, dict(
        tokens=toks, lengths=lens, tables=tbl[list(live)],
        start=pos[list(live)].copy(), all_logits=True)))
    return calls


def jax_call(jcfg, jparams, cache, name, lanes, all_lanes, kw):
    """One call through the JAX package; a verify pass over all W lanes
    (the others of length 0), as its engine runs it.  Returns (logits of
    the call's rows, cache)."""
    kw = dict(kw)
    if name == "decode":
        lg, cache = JM.decode_step(
            jcfg, jparams, cache, jnp.asarray(kw["tokens"]),
            jnp.asarray(kw["position"]), active=jnp.asarray(kw["active"]),
            block_tables=jnp.asarray(kw["tables"]))
        return as_np(lg), cache
    rows = list(lanes)
    if all_lanes:
        full = step_inputs(jcfg.vocab_size)["tbl"]
        P = kw["tokens"].shape[1]
        toks = np.zeros((W, P), np.int32)
        lens, start = np.zeros(W, np.int32), np.zeros(W, np.int32)
        toks[rows], lens[rows] = kw["tokens"], kw["lengths"]
        start[rows] = kw["start"]
        kw.update(tokens=toks, lengths=lens, tables=full, start=start)
    start = kw.get("start")
    lg, cache = JM.prefill_slots(
        jcfg, jparams, cache, jnp.asarray(kw["tokens"]),
        jnp.asarray(kw["lengths"]), jnp.asarray(kw["tables"]),
        start=None if start is None else jnp.asarray(start),
        all_logits=kw.get("all_logits", False))
    lg = as_np(lg)
    return (lg[rows] if all_lanes else lg), cache


def torch_call(cfg, params, cache, mesh, name, lanes, all_lanes, kw):
    """The same call through the port."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()
         if k != "all_logits"}
    if name == "decode":
        return TM.decode_step(cfg, params, cache, t["tokens"],
                              t["position"], active=t["active"],
                              block_tables=t["tables"], mesh=mesh)[0]
    return TM.prefill_slots(
        cfg, params, cache, t["tokens"], t["lengths"], t["tables"],
        start=t.get("start"), all_logits=kw.get("all_logits", False),
        mesh=mesh, lanes=tsh.Lanes(lanes, W, all_lanes))[0]


def real_rows(name, kw, lg):
    """The logits of real tokens: every row of a last-token call, the
    real columns of an all-positions one."""
    if not kw.get("all_logits"):
        return lg.reshape(lg.shape[0], -1)
    P = kw["tokens"].shape[1]
    return lg[np.arange(P)[None] >= (P - kw["lengths"])[:, None]]


def wave_batch(vocab):
    rng = np.random.default_rng(2)
    return rng.integers(1, vocab, (W, 6)).astype(np.int32), \
        rng.integers(1, vocab, (W, 1)).astype(np.int32)


#: The (arch, capacity factor, data places) whose model steps are held to
#: the JAX package itself; every other case to the port run meshless
#: under the same hint, which the first of these hold to the JAX package
#: (each JAX run takes ~10 s on the CPU).
JAX_ORACLES = (("qwen2-moe-a2.7b", 0.5, 2), ("qwen2-moe-a2.7b", 0.5, 4),
               ("qwen2-moe-a2.7b", 0.5, 3), ("qwen3-moe-235b-a22b", 0.5, 2))


@functools.lru_cache(maxsize=None)
def oracle(arch, factor, d):
    """The JAX package under the hint of d data places (the model axis
    changes nothing on the masked paged calls; the waves run under
    ``model`` 1, see the module docstring): {call: (logits of its real
    tokens, the cache it started from)} and the final pool."""
    jcfg, jparams, tcfg, _ = models(arch, factor)
    out = {}
    with jsh.use_axes(hint(d, 1)):
        cache = JM.init_paged_cache(jcfg, 1 + W * TW, BS)
        for name, lanes, al, kw in paged_calls(jcfg.vocab_size):
            before = {k: as_np(v) for k, v in cache.items()}
            lg, cache = jax_call(jcfg, jparams, cache, name, lanes, al, kw)
            out[name] = (real_rows(name, kw, lg), before)
        toks, nxt = wave_batch(jcfg.vocab_size)
        lg, wc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 16)
        out["wave prefill"] = (as_np(lg), None)
        before = {k: as_np(v) for k, v in wc.items()}
        lg, _ = JM.decode_step(jcfg, jparams, wc, jnp.asarray(nxt),
                               jnp.asarray(6, jnp.int32))
        out["wave decode"] = (as_np(lg)[:, 0], before)
    return out, {k: as_np(v) for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def reference(arch, factor, d):
    """``oracle`` where ``JAX_ORACLES`` names the case, else the port's own
    meshless run under the hint of d data places, in the same form."""
    if (arch, factor, d) in JAX_ORACLES:
        return oracle(arch, factor, d)
    got, cache, _, _, before = port_steps(arch, factor, None, d)
    return {k: (v, before.get(k)) for k, v in got.items()}, \
        {k: as_np(v) for k, v in cache.items()}


def load(cache, values):
    """Every part of the port's cache (pool replicas, a placed wave cache)
    set to its piece of the reference's ``values``."""
    for k, x in cache.items():
        w = torch.from_numpy(values[k].copy()).to(x.dtype)
        if not isinstance(x, tsh.Sharded):
            x.copy_(w)
            continue
        ref = tsh.place_like(w, x)
        for part, piece in zip(x.parts, ref.parts):
            part.copy_(piece)


def port_steps(arch, factor, mesh, d=None, want=None):
    """The port's logits for every call over ``mesh`` (None: meshless
    under the hint of d data places), each call starting from the cache
    ``want`` (a reference's) started it from, so that no bf16 rounding of
    an earlier call's writes, which fp32 noise may flip between two runs,
    is carried over; the final pool, the bytes of each paged call, the
    count of live assignments dropped at the capacity and the cache each
    call started from."""
    _, _, cfg, params = models(arch, factor)
    placed = params if mesh is None else tsh.place_serve(cfg, params, mesh)
    dropped = [0]
    dispatch = TMOE._dispatch_indices

    def counting(cfg_, experts, C, valid=None):
        slot, buf = dispatch(cfg_, experts, C, valid)
        live = slot < C if valid is None else valid[..., None]
        dropped[0] += int(((slot == C) & live).sum())
        return slot, buf

    def start(name, cache):
        if want is not None:
            load(cache, want[name][1])
        before[name] = {k: as_np(tsh.to_whole(v)) for k, v in cache.items()}

    out, moved, before = {}, {}, {}
    TMOE._dispatch_indices = counting
    try:
        with tsh.use_axes(mesh if mesh is not None
                          else tsh.AxisState((("data", d),))):
            cache = TM.init_paged_cache(cfg, 1 + W * TW, BS, device="cpu",
                                        mesh=mesh)
            for name, lanes, al, kw in paged_calls(cfg.vocab_size):
                start(name, cache)
                if mesh is not None:
                    mesh.moved_bytes.clear()
                lg = torch_call(cfg, placed, cache, mesh, name, lanes, al,
                                kw)
                out[name] = real_rows(name, kw, as_np(lg))
                if mesh is not None:
                    moved[name] = dict(mesh.moved_bytes)
            toks, nxt = wave_batch(cfg.vocab_size)
            lg, wc = TM.prefill(cfg, placed,
                                {"tokens": torch.from_numpy(toks)}, 16,
                                mesh=mesh)
            out["wave prefill"] = as_np(lg)
            start("wave decode", wc)
            lg, _ = TM.decode_step(cfg, placed, wc, torch.from_numpy(nxt),
                                   6, mesh=mesh)
            out["wave decode"] = as_np(lg)[:, 0]
    finally:
        TMOE._dispatch_indices = dispatch
    return out, cache, moved, dropped[0], before


def counted(cfg, mesh):
    """``dryrun.serve_collectives`` of each paged call."""
    out = {}
    for name, lanes, al, kw in paged_calls(cfg.vocab_size):
        n = len(lanes)
        if name == "decode":
            out[name] = dryrun.serve_collectives(
                cfg, mesh, n, table_width=TW, written=int(kw["active"].sum()),
                act=4)
            continue
        out[name] = dryrun.serve_collectives(
            cfg, mesh, n, chunk=kw["tokens"].shape[1], table_width=TW,
            written=int(kw["lengths"].sum()), act=4,
            first="start" not in kw, all_logits=kw.get("all_logits", False),
            lanes=tsh.Lanes(lanes, W, al))
    return out


def replica(x, mesh, i):
    """Data index i's replica of a placed pool leaf, whole over model."""
    di = tsh.axis_index(mesh, "data")
    mi = tsh.axis_index(mesh, "model")
    m = mesh.shape["model"]
    pick = {mi[k]: k for k in range(len(x.parts)) if di[k] == i}
    return tsh.to_whole(tsh.Sharded(tuple(x.parts[pick[j]] for j in range(m)),
                                    x.dim, mesh_of((1, m))))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_steps_match_the_grouped_reference(arch, factor, shape):
    """Every call within TOL of the reference under the same data axes
    (``reference``: the JAX package, or the port meshless) at the reduced
    and the tight capacity — assignments dropped at the tight one, none
    at 4.0; the pool's data replicas bit for bit among themselves and
    each bf16 entry within one rounding (2^-7 of its size) of the
    reference's pool; each paged call's bytes equal the dry run's."""
    d, m = shape
    _, _, cfg, _ = models(arch, factor)
    mesh = mesh_of(shape)
    want, wpool = reference(arch, factor, d)
    got, pool, moved, dropped, _ = port_steps(arch, factor, mesh, want=want)
    assert (dropped > 0) == (factor is not None), dropped
    for name, (w, _) in want.items():
        within(got[name], w, f"{arch} {factor} {shape} {name}")
    for k, x in pool.items():
        reps = [kv_quant.raw(replica(x, mesh, i))[:, 1:] for i in range(d)]
        for i, r in enumerate(reps[1:], 1):
            assert torch.equal(r, reps[0]), (k, i)
        # bf16 entries: one rounding of a value within TOL may flip.
        got_k = replica(x, mesh, 0)[:, 1:].float()
        want_k = torch.from_numpy(wpool[k][:, 1:].copy())
        assert ((got_k - want_k).abs() <= 2.0 ** -7 * want_k.abs()).all(), k
    assert moved == counted(cfg, mesh)


@pytest.mark.parametrize("arch,factor,d", JAX_ORACLES[:1] + JAX_ORACLES[3:])
def test_meshless_hint_matches_jax_and_groups_matter(arch, factor, d):
    """The port meshless under the hint of d data places (the other cases'
    reference, and the chip check's) within TOL of the JAX package under
    it; at the tight capacity the cohort of lanes 0 and 1 differs from
    the one-group dispatch by far more than the limit."""
    want, _ = oracle(arch, factor, d)
    got = port_steps(arch, factor, None, d, want=want)[0]
    for name, (w, _) in want.items():
        within(got[name], w, f"meshless under the hint: {name}")
    one = port_steps(arch, factor, None, 1, want=want)[0]["cohort (0, 1)"]
    w = want["cohort (0, 1)"][0]
    assert np.abs(one - w).max() > 100 * TOL * (w.max() - w.min())


# ---------------------------------------------------------------------------
# Controls
# ---------------------------------------------------------------------------

def by_place(rows, d):
    """Slots formed per data place: each place's rows one group, in the
    order it holds them (the wrong groups)."""
    split = rows.split
    of, pos = [0] * rows.n, [0] * rows.n
    for i, r in enumerate(split.rows):
        for p, j in enumerate(r):
            of[j], pos[j] = i, p
    per = max(len(r) for r in split.rows)
    return tsh.Groups(d, per, tuple(of), tuple(pos))


def test_slots_by_data_place_fail():
    """With each data place's rows taken as its own group, the tight
    cohort of lanes 0 and 1 (both on data place 0 at d = 2) leaves the
    limit."""
    arch, shape = "qwen2-moe-a2.7b", (2, 1)
    want, _ = oracle(arch, 0.5, 2)
    keep = tsh.dispatch_groups
    tsh.dispatch_groups = by_place
    try:
        got = port_steps(arch, 0.5, mesh_of(shape), want=want)[0]
    finally:
        tsh.dispatch_groups = keep
    w = want["cohort (0, 1)"][0]
    err = np.abs(got["cohort (0, 1)"] - w).max()
    assert err > 100 * TOL * (w.max() - w.min()), err


def test_outputs_returned_to_the_wrong_place_fail():
    """The reverse all_to_all delivering each data place's expert outputs
    to the next data place: the decode step and the wave leave the
    limit."""
    arch, shape = "qwen2-moe-a2.7b", (2, 2)
    want, _ = oracle(arch, 0.5, 2)
    keep = tsh.all_to_all

    def wrong(s, axis, split_dim, concat_dim):
        out = keep(s, axis, split_dim, concat_dim)
        if split_dim != 2:  # the forward all_to_all
            return out
        mesh = s.mesh
        di, mi = tsh.axis_index(mesh, "data"), tsh.axis_index(mesh, "model")
        d = tsh.data_size(mesh)
        at = {(di[k], mi[k]): k for k in range(len(out.parts))}
        return out.with_parts([out.parts[at[(di[k] + 1) % d, mi[k]]]
                               for k in range(len(out.parts))])

    tsh.all_to_all = wrong
    try:
        got = port_steps(arch, 0.5, mesh_of(shape), want=want)[0]
    finally:
        tsh.all_to_all = keep
    for name in ("decode", "wave decode"):
        w = want[name][0]
        err = np.abs(got[name] - w).max()
        assert err > 100 * TOL * (w.max() - w.min()), (name, err)


# ---------------------------------------------------------------------------
# The engine against the JAX engine under the axis hint
# ---------------------------------------------------------------------------

class HintedEngine(JaxEngine):
    """The JAX package's engine with its calls under an axis hint and no
    mesh: the reference's grouped values without devices."""

    def __init__(self, *args, hint_state, **kw):
        self._hint = hint_state
        super().__init__(*args, **kw)

    def _scoped(self, fn):
        state = self._hint

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jsh.use_axes(state):
                return fn(*args, **kwargs)
        return wrapped


def engine_reqs(vocab):
    """Seven requests over 4 lanes: three behind an 8-token system prefix
    (a prefix hit read across data places), budgets that free lane 2
    first, one preemption at 14 blocks."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, size=8)
    spec = [(True, 3, 8), (False, 6, 7), (False, 4, 2), (False, 9, 6),
            (True, 5, 5), (True, 2, 4), (False, 7, 3)]
    return [(np.concatenate([system, rng.integers(1, vocab, size=n)])
             if sys_ else rng.integers(1, vocab, size=n), b, None)
            for sys_, n, b in spec]


def wave_reqs(vocab):
    """Waves of 4 rows, 2 rows and 1 row."""
    rng = np.random.default_rng(3)
    return [(rng.integers(1, vocab, size=n), b, None)
            for n, b in ((5, 4), (9, 6), (5, 2), (5, 5), (9, 3), (5, 4),
                         (12, 2))]


@functools.lru_cache(maxsize=None)
def jax_engine(arch, factor, d, spec="off", kv=None, mode="continuous"):
    """The JAX engine's (tokens, counters) under the hint of d data places
    (``model`` 1: its unmasked wave calls, see the module docstring)."""
    jcfg, jparams, tcfg, _ = models(arch, factor, kv)
    kw = dict(hint_state=hint(d, 1), mode=mode)
    if mode == "wave":
        eng = HintedEngine(jcfg, jparams, **kw, **WAVE_KW)
        return run(eng, wave_reqs(tcfg.vocab_size)), \
            stats_of(eng.stats, WAVE_STATS)
    eng = HintedEngine(jcfg, jparams, spec_decode=spec, **kw, **ENGINE_KW)
    return run(eng, engine_reqs(tcfg.vocab_size)), stats_of(eng.stats, SCHED)


def port_engine(arch, factor, shape, spec="off", kv=None, mode="continuous",
                d=None):
    """The port engine's (tokens, counters) over a mesh of ``shape``, or
    meshless (``shape`` None) under the hint of d data places; and the
    mesh."""
    _, _, cfg, params = models(arch, factor, kv)
    mesh = None if shape is None else mesh_of(shape)
    wave = mode == "wave"
    eng = ServingEngine(cfg, params, mesh=mesh, mode=mode, device="cpu",
                        **({} if wave else dict(spec_decode=spec)),
                        **(WAVE_KW if wave else ENGINE_KW))
    if mesh is None:
        eng._axes = tsh.AxisState((("data", d), ("model", 1)))
    reqs = (wave_reqs if wave else engine_reqs)(cfg.vocab_size)
    return (run(eng, reqs), stats_of(eng.stats, WAVE_STATS if wave
                                     else SCHED)), mesh


#: (arch, factor, spec, pool, mode, meshes, reference): the engine runs,
#: each held to the JAX engine ("jax") or to the port's meshless engine
#: under the same data axes ("port"; the JAX runs cost ~8 s each).
ENGINES = (
    ("qwen2-moe-a2.7b", 0.5, "off", None, "continuous",
     ((2, 1), (2, 2)), "jax"),
    ("qwen2-moe-a2.7b", 0.5, "off", None, "continuous", ((3, 1),), "port"),
    ("qwen2-moe-a2.7b", 0.5, "ngram", None, "continuous", ((2, 2),), "jax"),
    ("qwen2-moe-a2.7b", 0.5, "off", "int8", "continuous", ((2, 2),), "jax"),
    ("qwen2-moe-a2.7b", 0.5, "off", "int8", "continuous", ((4, 1),), "port"),
    ("qwen3-moe-235b-a22b", 0.5, "off", None, "continuous", ((4, 1),),
     "jax"),
    ("qwen3-moe-235b-a22b", None, "ngram", None, "continuous", ((2, 2),),
     "port"),
    ("qwen2-moe-a2.7b", 0.5, "off", None, "wave", ((2, 2),), "jax"),
    ("qwen3-moe-235b-a22b", 0.5, "off", None, "wave", ((4, 1), (3, 1)),
     "port"),
)


@pytest.mark.parametrize("arch,factor,spec,kv,mode,shapes,ref", ENGINES)
def test_engine_matches_the_grouped_reference(arch, factor, spec, kv, mode,
                                              shapes, ref):
    """Greedy tokens and the scheduler's counters equal the reference
    engine's under the same data axes: paged — prefix hits across data
    places, chunked prefill cohorts, a preemption and its recompute,
    verify passes over every lane's groups, bf16 and int8 pools — and in
    waves of 4, 2 and 1 rows; the experts' exchange counted."""
    for shape in shapes:
        d = shape[0]
        want = jax_engine(arch, factor, d, spec, kv, mode) if ref == "jax" \
            else port_engine(arch, factor, None, spec, kv, mode, d)[0]
        if mode != "wave" and spec == "off":
            assert want[1]["preemptions"] >= 1 \
                and want[1]["cached_prompt_tokens"] > 0
        got, mesh = port_engine(arch, factor, shape, spec, kv, mode)
        assert got == want, shape
        if d != 3:
            assert mesh.moved_bytes["all_to_all"] > 0, shape
