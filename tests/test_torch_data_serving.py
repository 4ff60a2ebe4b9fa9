"""The port's serving over a (data, model) mesh with data axes above 1, on
the CPU: meshes naming the CPU d x m times, (2, 1), (2, 2), (4, 1), and
d = 3 over 8 lanes for the uneven-lanes rule.

  * placement: the weights whole over data (one part a device), every
    placed leaf — weights, the pool's data replicas, the wave caches cut
    on their batch — gathers back to the whole leaf bit for bit;
  * model steps: ``prefill_slots`` (a first chunk, a continuation) and
    ``decode_step`` on bf16, int8 and f8 pools within 1e-5 of the
    logits' range of meshless; every pool replica (the trash block, each
    replica's own sink, left out) bit for bit the pool of the same
    model axis without data axes — meshless at m = 1 — and the bytes
    each call moves equal to ``dryrun.serve_collectives``;
  * the engine: greedy tokens and ``EngineStats`` equal the JAX
    package's meshless engine for dense and vlm paged runs (prefix hits
    across data places, chunked prefill, one preemption, speculation
    off and on, two requests behind images) and in waves for dense,
    ssm, hybrid and audio;
  * controls: with the gather of written pool rows skipped, a lane on
    data place 1 reads a prefix block place 0 wrote as zeros — the
    logits leave the limit and the engine's tokens change;
  * uneven lanes: every data place holds every lane (no value changes,
    nothing gathered); the moe family's serve specs over data (its
    serving: ``test_torch_moe_data_serving.py``) and the refusals that
    stand.

Weights come from the JAX ``init_params`` (fp32) through
``torch_parity.pair``; inputs from numpy seeds.  A one-row product
takes another summation route than a several-row one on the CPU (a
GEMV), so the bit-for-bit pool checks give each data place two rows or
more; the one-row places of (4, 1) over 4 lanes are held to the logits'
limit and to replicas equal among themselves.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (STATS, WAVE_STATS, masked_d_cut_moe,  # noqa
                          pair, run, stats_of)

#: fp32 over a mesh vs meshless, a share of the logits' range.
TOL = 1e-5
MESHES = ((2, 1), (2, 2), (4, 1))
#: The engine's knobs: 4 lanes (2 a data place at d = 2), 4-token
#: blocks, 8-token chunks, a pool of 14 blocks (one preemption).
ENGINE_KW = dict(max_batch=4, block_size=4, prefill_chunk=8, max_len=32,
                 eos_id=-1, num_blocks=14)
WAVE_KW = dict(max_batch=4, max_len=32, eos_id=-1)
SCHED = STATS + ("spec_passes", "spec_proposed", "spec_accepted",
                 "peak_live_blocks", "kv_block_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors (several workers share
    a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


@functools.lru_cache(maxsize=None)
def models(arch):
    """``pair(arch)``; zamba2-7b at 5 layers (two groups and a tail)."""
    return pair(arch, num_layers=5) if arch == "zamba2-7b" else pair(arch)


def with_kv(cfg, kv_dtype):
    return cfg if kv_dtype == "fp" else dataclasses.replace(
        cfg, kv_dtype=kv_dtype)


def bits(x):
    return kv_quant.raw(x.contiguous())


def within(got, want, what):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    span = (want.max() - want.min()).item()
    assert err <= TOL * span, f"{what}: {err} > {TOL} x {span}"


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b",
                                  "mamba2-1.3b", "zamba2-7b",
                                  "whisper-base"])
def test_placed_leaves_gather_back_bitwise(arch):
    """At (2, 2): every weight leaf whole over data (its data places'
    parts one object) and bit for bit the whole leaf; the wave caches
    after a prefill of 4 rows cut on their batch over data and equal, bit
    for bit, to the (1, 2) run's; an attention family's pool one replica
    a data index, each gathering back to the (1, 2) pool."""
    _, _, cfg, params = models(arch)
    mesh, one = mesh_of((2, 2)), mesh_of((1, 2))
    placed = tsh.place_serve(cfg, params, mesh)
    di = tsh.axis_index(mesh, "data")
    for (path, leaf), (_, whole) in zip(tsh_flat(placed), tsh_flat(params)):
        assert torch.equal(tsh.to_whole(leaf), whole), path
        assert leaf.rows is None, path
        assert leaf.parts[0] is leaf.parts[di.index(1)], path
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(4, cfg.encdec.encoder_seq_len,
                                      cfg.d_model)
    with tsh.use_axes(mesh):
        _, cache = TM.prefill(cfg, placed, batch, 12, mesh=mesh)
    with tsh.use_axes(one):
        _, ref = TM.prefill(cfg, tsh.place_serve(cfg, params, one), batch,
                            12, mesh=one)
    for (path, x), (_, y) in zip(tsh_flat(cache), tsh_flat(ref)):
        assert x.rows is not None and x.rows[0] == ("data",), path
        assert x.parts[0].shape[x.rows[1]] == 2, path
        assert torch.equal(bits(tsh.to_whole(x)), bits(tsh.to_whole(y))), \
            path
    if cfg.family in ("dense", "vlm"):
        pool = TM.init_paged_cache(cfg, 9, 4, mesh=mesh)
        a = tsh.attn_shard_size(mesh, cfg.num_kv_heads)
        for k, x in pool.items():
            assert len(x.distinct_parts()) == 2 * a, k
            x.parts[0].fill_(1)
            assert not torch.equal(x.parts[0], x.parts[di.index(1)]), k


def tsh_flat(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.flatten(tree)


# ---------------------------------------------------------------------------
# Model steps: logits, replicas, bytes
# ---------------------------------------------------------------------------

def paged_steps(cfg, params, mesh, lanes=4):
    """A first chunk, a continuation with every position's logits and a
    decode step with one dead lane, on ``lanes`` rows over a fresh pool
    of 4-token blocks; the mesh's bytes read after each call.  Returns
    ([logits], [bytes], pool, (table width, written rows per call))."""
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    rng = np.random.default_rng(1)
    bs, T = 4, -(-(16 + prefix) // 4)
    tbl = torch.arange(1, 1 + lanes * T, dtype=torch.int32) \
        .reshape(lanes, T)
    lens = torch.from_numpy(rng.integers(1, 9, lanes).astype(np.int32))
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (lanes, 8)).astype(np.int32))
    toks[torch.arange(8)[None] < (8 - lens)[:, None]] = 0
    l2 = torch.from_numpy(rng.integers(1, 5, lanes).astype(np.int32))
    active = torch.arange(lanes) != 2
    kw = {}
    if prefix:
        kw["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (lanes, prefix, cfg.d_model)).astype(np.float32)).bfloat16()
    cache = TM.init_paged_cache(cfg, 1 + lanes * T, bs, device="cpu",
                                mesh=mesh)
    out, moved = [], []

    def read():
        if mesh is not None:
            moved.append(dict(mesh.moved_bytes))
            mesh.moved_bytes.clear()

    with tsh.use_axes(mesh):
        out.append(TM.prefill_slots(cfg, params, cache, toks, lens, tbl,
                                    mesh=mesh, **kw)[0])
        read()
        out.append(TM.prefill_slots(cfg, params, cache, toks[:, :4], l2,
                                    tbl, start=prefix + lens,
                                    all_logits=True, mesh=mesh)[0])
        read()
        out.append(TM.decode_step(
            cfg, params, cache, toks[:, :1], lens + l2, active=active,
            block_tables=torch.where(active[:, None], tbl, 0),
            mesh=mesh)[0])
        read()
    written = (int((lens + prefix).sum()), int(l2.sum()),
               int(active.sum()))
    return out, moved, cache, (T, written)


@functools.lru_cache(maxsize=None)
def reference_steps(arch, kv_dtype, m, lanes):
    """paged_steps without data axes: meshless at m = 1, else on (1, m)."""
    _, _, cfg, params = models(arch)
    cfg = with_kv(cfg, kv_dtype)
    mesh = None if m == 1 else mesh_of((1, m))
    placed = params if mesh is None else tsh.place_serve(cfg, params, mesh)
    out, _, cache, _ = paged_steps(cfg, placed, mesh, lanes)
    return out, {k: tsh.to_whole(v) for k, v in cache.items()}


def replica(x, mesh, i):
    """Data index i's replica of a placed pool leaf, whole over model."""
    di = tsh.axis_index(mesh, "data")
    mi = tsh.axis_index(mesh, "model")
    pick = {mi[k]: k for k in range(len(x.parts)) if di[k] == i}
    one = mesh_of((1, mesh.shape["model"]))
    return tsh.to_whole(tsh.Sharded(tuple(
        x.parts[pick[j]] for j in range(mesh.shape["model"])), x.dim, one))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "f8"])
@pytest.mark.parametrize("shape", MESHES)
def test_paged_steps_match_meshless(shape, kv_dtype):
    """Logits within TOL of meshless; every pool replica bit for bit the
    pool without data axes (8 lanes at (4, 1): two rows a place; with 4
    lanes, one a place, the logits and the replicas among themselves);
    the bytes of each call equal ``serve_collectives``."""
    d, m = shape
    _, _, cfg, params = models("tinyllama-1.1b")
    cfg = with_kv(cfg, kv_dtype)
    mesh = mesh_of(shape)
    placed = tsh.place_serve(cfg, params, mesh)
    for lanes in ((4, 8) if d == 4 else (4,)):
        got, moved, pool, (T, written) = paged_steps(cfg, placed, mesh,
                                                     lanes)
        want, _ = reference_steps("tinyllama-1.1b", kv_dtype, 1, lanes)
        for name, g, w in zip(("first", "continuation", "decode"), got,
                              want):
            within(g, w, f"{shape} {kv_dtype} {lanes} lanes {name}")
        _, ref = reference_steps("tinyllama-1.1b", kv_dtype, m, lanes)
        for k, x in pool.items():
            reps = [bits(replica(x, mesh, i))[:, 1:] for i in range(d)]
            for i, r in enumerate(reps[1:], 1):
                assert torch.equal(r, reps[0]), (k, i)
            if lanes // d > 1:
                assert torch.equal(reps[0], bits(ref[k])[:, 1:]), k
        counts = [dryrun.serve_collectives(cfg, mesh, lanes, chunk=c,
                                           table_width=T, written=w, act=4,
                                           first=f, all_logits=not f)
                  for c, w, f in ((8, written[0], True),
                                  (4, written[1], False))]
        counts.append(dryrun.serve_collectives(cfg, mesh, lanes,
                                               table_width=T,
                                               written=written[2], act=4))
        assert moved == counts, (lanes, moved, counts)
        assert all(c["pool_gather"] > 0 and c["row_gather"] > 0
                   for c in counts)


def test_vlm_steps_match_meshless():
    """internvl2-26b (a 4-position patch prefix reduced, a vocab that
    does not divide 2) at (2, 2): logits within TOL, replicas equal the
    (1, 2) pool, bytes equal the count."""
    _, _, cfg, params = models("internvl2-26b")
    mesh = mesh_of((2, 2))
    got, moved, pool, (T, written) = paged_steps(
        cfg, tsh.place_serve(cfg, params, mesh), mesh)
    want, _ = reference_steps("internvl2-26b", "fp", 1, 4)
    for g, w in zip(got, want):
        within(g, w, "internvl2-26b (2, 2)")
    _, ref = reference_steps("internvl2-26b", "fp", 2, 4)
    for k, x in pool.items():
        for i in range(2):
            assert torch.equal(bits(replica(x, mesh, i))[:, 1:],
                               bits(ref[k])[:, 1:]), (k, i)
    assert moved == [
        dryrun.serve_collectives(cfg, mesh, 4, chunk=8, table_width=T,
                                 written=written[0], act=4),
        dryrun.serve_collectives(cfg, mesh, 4, chunk=4, table_width=T,
                                 written=written[1], act=4, first=False,
                                 all_logits=True),
        dryrun.serve_collectives(cfg, mesh, 4, table_width=T,
                                 written=written[2], act=4)]


def prefix_read(cfg, params, mesh, gather=True):
    """Lane 0 (data place 0) prefills 8 tokens into blocks 1-2; lane 3
    (data place 1 of 2) then continues from the same two blocks.
    Returns lane 3's logits (row 1 of the continuation); with ``gather``
    False the rows place 0 wrote are not copied to place 1's replica."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 8))
                            .astype(np.int32))
    tbl = torch.tensor([[1, 2, 3, 0], [1, 2, 4, 0]], dtype=torch.int32)
    cache = TM.init_paged_cache(cfg, 5, 4, device="cpu", mesh=mesh)
    keep = tsh.gather_writes
    if not gather:
        tsh.gather_writes = lambda *a: None
    try:
        with tsh.use_axes(mesh):
            TM.prefill_slots(cfg, params, cache, toks[:1], torch.tensor(
                [8], dtype=torch.int32), tbl[:1], mesh=mesh,
                lanes=tsh.Lanes((0,), 4))
            out, _ = TM.prefill_slots(
                cfg, params, cache, toks[:, :2], torch.tensor(
                    [2, 2], dtype=torch.int32), tbl, mesh=mesh,
                start=torch.tensor([8, 8], dtype=torch.int32),
                lanes=tsh.Lanes((1, 3), 4))
    finally:
        tsh.gather_writes = keep
    return out[1]


def test_skipping_the_gather_fails():
    """A lane on data place 1 reading a shared-prefix block place 0 wrote:
    within TOL of meshless with the gather, far outside it without; and
    the engine's tokens change when the gather is skipped."""
    _, _, cfg, params = models("tinyllama-1.1b")
    mesh = mesh_of((2, 1))
    placed = tsh.place_serve(cfg, params, mesh)
    want = prefix_read(cfg, params, None)
    within(prefix_read(cfg, placed, mesh), want, "prefix read")
    bad = prefix_read(cfg, placed, mesh, gather=False)
    err = (bad - want).abs().max().item()
    assert err > 0.05 * (want.max() - want.min()).item()
    keep = tsh.gather_writes
    tsh.gather_writes = lambda *a: None
    try:
        out = engine_run(cfg, params, mesh, engine_reqs(cfg))[0]
    finally:
        tsh.gather_writes = keep
    assert out != jax_run("tinyllama-1.1b", "off")[0]


# ---------------------------------------------------------------------------
# The engine against the JAX package's meshless engine
# ---------------------------------------------------------------------------

def engine_reqs(cfg, images=False):
    """Seven requests over 4 lanes: three behind an 8-token system prefix
    (the first on lane 0; the next admitted on lane 2, data place 1 at
    d = 2, reading its blocks), budgets that free lane 2 first; with
    ``images`` two requests behind one random image."""
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    system = rng.integers(1, V, size=8)
    img = rng.standard_normal((cfg.num_patches, cfg.d_model)) \
        .astype(np.float32) if images else None
    spec = [(True, 3, 8, img), (False, 6, 7, None), (False, 4, 2, None),
            (False, 9, 6, None), (True, 5, 5, img), (True, 2, 4, None),
            (False, 7, 3, None)]
    return [(np.concatenate([system, rng.integers(1, V, size=n)]) if sys_
             else rng.integers(1, V, size=n), b, pe)
            for sys_, n, b, pe in spec]


def engine_run(cfg, params, mesh, reqs, **kw):
    eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE_KW,
                        **kw)
    return run(eng, reqs), stats_of(eng.stats, SCHED)


@functools.lru_cache(maxsize=None)
def jax_run(arch, spec):
    jcfg, jparams, tcfg, _ = models(arch)
    eng = JaxEngine(jcfg, jparams, spec_decode=spec, **ENGINE_KW)
    out = run(eng, engine_reqs(tcfg, images=tcfg.family == "vlm"))
    return out, stats_of(eng.stats, SCHED)


@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b"])
def test_paged_engine_matches_jax(arch, spec):
    """Greedy tokens and the scheduler's counters at (2, 1), (2, 2) and
    (4, 1) equal the JAX engine's meshless run: prefix hits read across
    data places, chunked prefill, one preemption and its recompute, and
    (spec "ngram") verify passes through K2's path with their writes
    gathered."""
    _, _, cfg, params = models(arch)
    want = jax_run(arch, spec)
    assert want[1]["preemptions"] >= 1 and want[1]["cached_prompt_tokens"]
    reqs = engine_reqs(cfg, images=cfg.family == "vlm")
    for shape in MESHES:
        mesh = mesh_of(shape)
        got = engine_run(cfg, params, mesh, reqs, spec_decode=spec)
        assert got == want, shape
        assert mesh.moved_bytes["pool_gather"] > 0, shape


@functools.lru_cache(maxsize=None)
def jax_wave_run(arch):
    """The JAX engine's meshless wave run (its whisper encoder handed the
    zero stub frames in fp32, as tests/test_torch_audio.py does)."""
    jcfg, jparams, tcfg, _ = models(arch)
    encode = JM.encode_audio
    JM.encode_audio = lambda c, p, frames, *a: encode(
        c, p, frames.astype(p["embed"].dtype), *a)
    try:
        eng = JaxEngine(jcfg, jparams, mode="wave", **WAVE_KW)
        out = run(eng, wave_reqs(tcfg))
    finally:
        JM.encode_audio = encode
    return out, stats_of(eng.stats, WAVE_STATS)


def wave_reqs(cfg):
    """Waves of 4 rows (cut at d = 2 and 4), 2 rows (cut at d = 2) and 1
    (whole), budgets that differ inside a wave."""
    rng = np.random.default_rng(3)
    return [(rng.integers(1, cfg.vocab_size, size=n), b, None)
            for n, b in ((5, 4), (9, 6), (5, 2), (5, 5), (9, 3), (5, 4),
                         (12, 2))]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "zamba2-7b", "whisper-base"])
def test_wave_engine_matches_jax(arch):
    """Greedy tokens and wave counters at (2, 1), (2, 2) and (4, 1) equal
    the JAX engine's meshless wave run, the rows cut over data."""
    _, _, cfg, params = models(arch)
    want = jax_wave_run(arch)
    for shape in MESHES:
        mesh = mesh_of(shape)
        eng = ServingEngine(cfg, params, mesh=mesh, mode="wave",
                            device="cpu", **WAVE_KW)
        got = run(eng, wave_reqs(cfg)), stats_of(eng.stats, WAVE_STATS)
        assert got == want, shape
        assert mesh.moved_bytes["scatter"] > 0, shape


# ---------------------------------------------------------------------------
# Uneven lanes and the refusal
# ---------------------------------------------------------------------------

def test_uneven_lanes_hold_every_lane():
    """d = 3 over 8 lanes: every data place runs every lane — the JAX
    engine's tokens and counters, the pool replicas bit for bit the
    meshless pool, nothing scattered or gathered between data places."""
    _, _, cfg, params = models("tinyllama-1.1b")
    mesh = mesh_of((3, 1))
    assert tsh.split_rows(mesh, tsh.Lanes(tuple(range(8)), 8), 8) is None
    kw = dict(ENGINE_KW, max_batch=8, num_blocks=None)
    reqs = engine_reqs(cfg)
    eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **kw)
    got = run(eng, reqs), stats_of(eng.stats, SCHED)
    solo = ServingEngine(cfg, params, device="cpu", **kw)
    assert got == (run(solo, reqs), stats_of(solo.stats, SCHED))
    assert set(mesh.moved_bytes) == {"broadcast"}
    for k, x in eng._cache.items():
        for p in x.parts:
            assert torch.equal(bits(p)[:, 1:], bits(solo._cache[k])[:, 1:])


def test_moe_serve_specs_cut_experts_and_refusals_stand():
    """At (2, 2) ``serve_specs`` cuts the routed experts as the reference's
    serve rule does (E over data, d over model; the router and the shared
    expert whole over data) — spec for spec the JAX package's sanitized
    ``param_specs(mode="serve")``; what stays refused: paged caches for
    ssm.  Cleared: a training batch that does not divide the data axes
    is placed whole on every data place, and experts cut on d_model off
    the manual path (a mask, at (1, 2)) equal JAX's masked layer under
    the mesh's axes, and the meshless port's layer."""
    from repro.configs.base import get_config as jax_config
    from repro.parallel import sharding as jsh
    jcfg = jax_config("qwen2-moe-a2.7b").reduced()
    jparams = jax.eval_shape(lambda: JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    mesh = mesh_of((2, 2))
    specs = tsh.serve_specs(cfg, params, mesh)["blocks"]["moe"]
    with jsh.use_axes(jsh.AxisState((("data", 2), ("model", 2)))):
        jspecs = jsh.sanitize_specs(
            jsh.param_specs(jcfg, jparams, mode="serve"), jparams)
    jmoe = jspecs["blocks"]["moe"]
    for name in ("w_gate", "w_up", "w_down", "router"):
        assert tuple(specs[name]) == tuple(jmoe[name]), name
    for name, spec in specs["shared"].items():
        assert tuple(spec) == tuple(jmoe["shared"][name]), name
    assert tuple(specs["w_gate"]) == (None, "data", "model", None)
    assert tuple(specs["w_down"]) == (None, "data", None, "model")
    with pytest.raises(NotImplementedError, match="paged"):
        TM.init_paged_cache(get_config("mamba2-1.3b").reduced(), 4, 4,
                            device="cpu")
    toks = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    placed = tsh.place_batch(cfg, {"tokens": toks}, mesh_of((2, 2)))
    assert placed["tokens"].rows is None
    assert all(torch.equal(p, toks) for p in placed["tokens"].parts)
    (out, aux), *refs = masked_d_cut_moe(
        "qwen2-moe-a2.7b", params["blocks"]["moe"], mesh_of((1, 2)))
    for ref, aux_ref in refs:  # JAX's layer, then the meshless port's
        for p, a in zip(out.parts, aux.parts):
            assert np.abs(p.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
            assert float(a) == pytest.approx(float(aux_ref), rel=1e-6)
