"""The port's tensor-parallel serving over a ``model`` mesh axis, held to
the reference's contract (``tests/test_sharded_dispatch.py``) on meshes
that name the CPU several times (one device, several shards):

  * spec parity with no devices: ``param_specs`` (both modes),
    ``cache_specs`` (paged and dense), ``batch_specs`` and
    ``sanitize_specs`` equal the JAX package's leaf for leaf, for every
    config at full width under four axis states;
  * kernel level, plain path: sharded (pools placed once) vs solo
    ``decode_attention`` and ``prefill_attention`` bitwise in fp32 —
    outputs and every written-back pool and scale leaf — and within 2e-2
    in bf16; a plain pool the mesh would cut raises;
  * engine level, fp32 weights carried across from the JAX package:
    greedy tokens and the scheduler tuple of 2- and 4-way meshes equal
    the meshless port's (and, for tinyllama, the JAX engine's);
  * bytes between shards: a sharded decode step moves none of the pool,
    copy-on-write keeps every part's placement, and an engine leaks no
    axis state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config, list_archs
from repro.models import model as JM
from repro.parallel import sharding as jsh
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as tsh
from repro_torch.serving.engine import ServingEngine
from repro_torch import tree as tree_lib

from torch_parity import pair

AXIS_STATES = ((1, 2), (1, 4), (2, 4), (16, 16))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(m):
    return mesh_lib.make_mesh((1, m), ("data", "model"), "cpu")


def states(shape):
    sizes = tuple(zip(("data", "model"), shape))
    return jsh.AxisState(sizes), tsh.AxisState(sizes)


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(p.key) for p in path): tuple(leaf)
            for path, leaf in leaves}


def torch_flat(tree):
    return {path: tuple(leaf) for path, leaf in tree_lib.flatten(tree)}


# ---------------------------------------------------------------------------
# Spec parity, no devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jshapes, tshapes = JM.param_specs(jcfg), TM.param_specs(tcfg)
    jleaves = {"/".join(str(p.key) for p in path): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    tleaves = dict(tree_lib.flatten(tshapes))
    assert sorted(jleaves) == sorted(tleaves)
    for path, j in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    for shape in AXIS_STATES:
        jst, tst = states(shape)
        for mode in ("train", "serve"):
            with jsh.use_axes(jst):
                jspec = jsh.param_specs(jcfg, jshapes, mode)
                jsan = jsh.sanitize_specs(jspec, jshapes)
            with tsh.use_axes(tst):
                tspec = tsh.param_specs(tcfg, tshapes, mode)
                tsan = tsh.sanitize_specs(tspec, tshapes)
            assert torch_flat(tspec) == jax_flat(jspec), (shape, mode)
            assert torch_flat(tsan) == jax_flat(jsan), (shape, mode)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_specs_match_the_reference(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    B, S = 8, 64
    dense = (JM.cache_specs(jcfg, B, S), TM.cache_specs(tcfg, B, S))
    assert {p: tuple(x.shape) for p, x in tree_lib.flatten(dense[1])} == {
        "/".join(str(k.key) for k in path): tuple(x.shape) for path, x in
        jax.tree_util.tree_flatten_with_path(dense[0])[0]}
    caches = [(dense, False)]
    if tcfg.family in TM.ATTENTION_FAMILIES:
        for kv in ("int8", "fp8"):
            jc = dataclasses.replace(jcfg, kv_dtype=kv)
            tc = dataclasses.replace(tcfg, kv_dtype=kv)
            caches.append(((jax.eval_shape(
                lambda c=jc: JM.init_paged_cache(c, 4, 8)),
                TM.init_paged_cache(tc, 4, 8, device="meta")), True))
        caches.append(((jax.eval_shape(lambda: JM.init_paged_cache(jcfg, 4,
                                                                   8)),
                        TM.init_paged_cache(tcfg, 4, 8, device="meta")),
                       True))
    batch = {"tokens": (B, S), "labels": (B, S)}
    if tcfg.family == "vlm":
        batch["patch_embeds"] = (B, tcfg.num_patches, tcfg.d_model)
    jbatch = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()}
    tbatch = {k: torch.empty(v, device="meta") for k, v in batch.items()}
    for shape in AXIS_STATES:
        jst, tst = states(shape)
        for batch_size in (B, 1):
            for (jshape, tshape), paged in caches:
                with jsh.use_axes(jst):
                    js = jsh.cache_specs(jcfg, jshape, jsh.data_axes(),
                                         batch_size, paged=paged)
                    jsan = jsh.sanitize_specs(js, jshape)
                with tsh.use_axes(tst):
                    ts = tsh.cache_specs(tcfg, tshape, tsh.data_axes(),
                                         batch_size, paged=paged)
                    tsan = tsh.sanitize_specs(ts, tshape)
                assert torch_flat(ts) == jax_flat(js), (shape, paged)
                assert torch_flat(tsan) == jax_flat(jsan), (shape, paged)
            with jsh.use_axes(jst):
                jb = jsh.batch_specs(jcfg, jbatch, jsh.data_axes(),
                                     batch_size)
            with tsh.use_axes(tst):
                tb = tsh.batch_specs(tcfg, tbatch, tsh.data_axes(),
                                     batch_size)
            assert torch_flat(tb) == jax_flat(jb), shape


def test_attn_shard_size_matches_sanitize_gate():
    mesh = cpu_mesh(2)
    assert tsh.attn_shard_size(None, 4) == 1
    assert tsh.attn_shard_size(mesh, 4) == 2
    assert tsh.attn_shard_size(mesh, 3) == 1
    with tsh.use_axes(mesh):
        spec = tsh.sanitize_specs(tsh.P(None, None, None, "model", None),
                                  torch.empty(2, 8, 8, 3, 16, device="meta"))
    assert spec[3] is None


def test_paged_attn_specs_match_the_reference():
    j, t = jsh.paged_attn_specs(), tsh.paged_attn_specs()
    assert sorted(j) == sorted(t)
    assert all(tuple(j[k]) == tuple(t[k]) for k in j)
    assert t["pool"] == tsh.P(None, None, "model", None)
    assert t["host"] == tsh.P()


def test_meshes():
    m = mesh_lib.make_host_mesh(2, device="cpu")
    assert m.shape == {"data": 1, "model": 2}
    assert tsh.model_devices(m) == [torch.device("cpu")] * 2
    prod = mesh_lib.make_production_mesh(multi_pod=True)
    assert tsh.AxisState.from_mesh(prod).sizes == (
        ("pod", 2), ("data", 16), ("model", 16))
    assert mesh_lib.data_axes(prod) == ("pod", "data")
    assert mesh_lib.data_axes(m) == ("data",)


# ---------------------------------------------------------------------------
# Kernel level, plain path
# ---------------------------------------------------------------------------

def paged_inputs(seed, B, H, Hk, D, N, bs, dtype=torch.float32,
                 quantized=False):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)) \
        .to(dtype)
    scales = None
    if quantized:
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, (N, bs, Hk, D))
                                   .astype(np.int8)) for _ in range(2))
        scales = tuple(torch.from_numpy(
            rng.uniform(0.01, 0.1, (N, bs, Hk)).astype(np.float32))
            for _ in range(2))
    else:
        kc, vc = (torch.from_numpy(rng.standard_normal((N, bs, Hk, D),
                                                       np.float32)).to(dtype)
                  for _ in range(2))
    T = N // B
    tables = torch.arange(B * T, dtype=torch.int32).reshape(B, T)
    lengths = torch.arange(1, B + 1, dtype=torch.int32) * bs - 1
    return q, kc, vc, lengths, tables, scales


def placed(mesh, pool, scales=None):
    """The pool (and its scales) placed once over ``mesh`` as
    ``init_paged_cache(mesh=)`` places it: cut on the KV heads."""
    sp = tsh.paged_attn_specs()
    return (tsh.shard(pool, sp["pool"], mesh),
            None if scales is None
            else tuple(tsh.shard(s, sp["scale"], mesh) for s in scales))


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_decode_matches_single(quantized):
    q, kc, vc, lengths, tables, scales = paged_inputs(
        0, B=2, H=8, Hk=4, D=16, N=8, bs=8, quantized=quantized)
    solo = decode_ops.decode_attention(q, kc, vc, lengths, tables,
                                       kv_scales=scales)
    mesh = cpu_mesh(2)
    (kp, sc), (vp, _) = placed(mesh, kc, scales), placed(mesh, vc)
    assert kp.dim == 2 and len(kp.parts) == 2
    shard = decode_ops.decode_attention(q, kp, vp, lengths, tables,
                                        kv_scales=sc, mesh=mesh)
    assert torch.equal(solo, shard)


def test_sharded_decode_bf16_within_kernel_tolerance():
    q, kc, vc, lengths, tables, _ = paged_inputs(
        1, B=2, H=4, Hk=2, D=16, N=8, bs=8, dtype=torch.bfloat16)
    solo = decode_ops.decode_attention(q, kc, vc, lengths, tables)
    mesh = cpu_mesh(2)
    shard = decode_ops.decode_attention(q, placed(mesh, kc)[0],
                                        placed(mesh, vc)[0], lengths, tables,
                                        mesh=mesh)
    torch.testing.assert_close(shard.float(), solo.float(), atol=2e-2,
                               rtol=2e-2)


def test_plain_pool_under_a_cutting_mesh_raises():
    """A pool the mesh would cut is placed once, never copied per call."""
    q, kc, vc, lengths, tables, _ = paged_inputs(
        0, B=2, H=8, Hk=4, D=16, N=8, bs=8)
    with pytest.raises(TypeError, match="placed first"):
        decode_ops.decode_attention(q, kc, vc, lengths, tables,
                                    mesh=cpu_mesh(2))
    qc = q[:, None].expand(2, 3, 8, 16).contiguous()
    kn = torch.zeros(2, 3, 4, 16)
    with pytest.raises(TypeError, match="placed first"):
        prefill_ops.prefill_attention(qc, kn, kn, kc, vc, lengths, tables,
                                      mesh=cpu_mesh(2))


def test_indivisible_heads_take_the_single_path(monkeypatch):
    """Hk = 3 on 2 ways: the solo dispatch, same numbers."""
    q, kc, vc, lengths, tables, _ = paged_inputs(
        2, B=1, H=3, Hk=3, D=8, N=4, bs=8)
    calls = []
    monkeypatch.setattr(decode_ops, "_sharded_decode",
                        lambda *a: calls.append(a))
    solo = decode_ops.decode_attention(q, kc, vc, lengths, tables)
    shard = decode_ops.decode_attention(q, kc, vc, lengths, tables,
                                        mesh=cpu_mesh(2))
    assert not calls
    assert torch.equal(solo, shard)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("continuation", [False, True])
def test_sharded_prefill_matches_single(quantized, continuation):
    B, S, H, Hk, D, N, bs = 2, 8, 4, 2, 16, 8, 8
    rng = np.random.default_rng(3)
    q, k_new, v_new = (torch.from_numpy(rng.standard_normal(
        (B, S, h, D), np.float32)) for h in (H, Hk, Hk))
    _, kp, vp, _, tables, scales = paged_inputs(
        4, B=B, H=H, Hk=Hk, D=D, N=N, bs=bs, quantized=quantized)
    lengths = torch.tensor([S, S - 3], dtype=torch.int32)
    start = torch.tensor([bs, bs], dtype=torch.int32) if continuation \
        else None
    kv_dtype = "int8" if quantized else None

    def run(mesh):
        (k, sc), (v, _) = ((kp.clone(), tuple(x.clone() for x in scales)
                            if scales else None), (vp.clone(), None))
        if mesh is not None:
            (k, sc), (v, _) = placed(mesh, k, sc), placed(mesh, v)
        out = prefill_ops.prefill_attention(
            q, k_new, v_new, k, v, lengths, tables,
            start=start, kv_scales=sc, kv_dtype=kv_dtype, mesh=mesh)
        assert out[1] is k and out[2] is v  # written in place
        return [tsh.gather(x) for x in out]

    solo, shard = run(None), run(cpu_mesh(2))
    assert len(solo) == len(shard) == (5 if quantized else 3)
    for a, b in zip(solo, shard):
        assert torch.equal(a, b)
    assert not torch.equal(solo[1], kp)  # the scatter wrote


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch=3, max_len=32, mode="continuous", block_size=8,
                 prefill_chunk=8, eos_id=-1, seed=5)


def sched(stats):
    return (stats.preemptions, stats.admissions, stats.cached_prompt_tokens,
            stats.prefill_tokens, stats.generated_tokens,
            stats.prefix_hit_rate)


def matrix_reqs(cfg, arch, n=4):
    rng = np.random.default_rng(17)
    system = rng.integers(1, cfg.vocab_size, size=9)
    pe = None
    if arch == "internvl2-26b":
        pe = rng.normal(size=(cfg.num_patches, cfg.d_model)) \
            .astype(np.float32)
    reqs = []
    for i in range(n):
        tail = rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 8)))
        reqs.append((np.concatenate([system, tail]) if i % 2 == 0 else tail,
                     3, pe))
    return reqs


def engine_run(cfg, params, mesh, reqs, prefix_cache=True, **kw):
    eng = ServingEngine(cfg, params, mesh=mesh, prefix_cache=prefix_cache,
                        device="cpu", **ENGINE_KW, **kw)
    uids = [eng.submit(p, max_new_tokens=m, patch_embeds=pe)
            for p, m, pe in reqs]
    out = eng.run()
    return [out[u] for u in uids], sched(eng.stats)


@functools.lru_cache(maxsize=None)
def models(arch, kv_dtype, **changes):
    kw = dict(changes)
    if kv_dtype != "fp":
        kw["kv_dtype"] = kv_dtype
    return pair(arch, **kw)


@functools.lru_cache(maxsize=None)
def solo_run(arch, kv_dtype, prefix_cache):
    _, _, tcfg, tparams = models(arch, kv_dtype)
    return engine_run(tcfg, tparams, None, matrix_reqs(tcfg, arch),
                      prefix_cache)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "internvl2-26b"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_sharded_matrix_2way(arch, kv_dtype, prefix_cache):
    _, _, tcfg, tparams = models(arch, kv_dtype)
    shard = engine_run(tcfg, tparams, cpu_mesh(2), matrix_reqs(tcfg, arch),
                       prefix_cache)
    assert shard == solo_run(arch, kv_dtype, prefix_cache)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_engine_matches_the_reference_engine(kv_dtype):
    """The JAX engine's meshless run, which the reference's contract
    holds equal to its own sharded run, equals the port's 2-way run."""
    jcfg, jparams, tcfg, tparams = models("tinyllama-1.1b", kv_dtype)
    reqs = matrix_reqs(tcfg, "tinyllama-1.1b")
    eng = JaxEngine(jcfg, jparams, prefix_cache=True, **ENGINE_KW)
    uids = [eng.submit(p, max_new_tokens=m) for p, m, _ in reqs]
    out = eng.run()
    want = ([out[u] for u in uids], sched(eng.stats))
    assert engine_run(tcfg, tparams, cpu_mesh(2), reqs) == want


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_engine_sharded_4way(kv_dtype):
    _, _, tcfg, tparams = models("tinyllama-1.1b", kv_dtype, num_heads=4,
                                 num_kv_heads=4)
    reqs = matrix_reqs(tcfg, "tinyllama-1.1b")
    mesh = cpu_mesh(4)
    eng = ServingEngine(tcfg, tparams, mesh=mesh, device="cpu", **ENGINE_KW)
    assert eng.params["blocks"]["attn"]["wk"].dim == 2
    assert len(eng._cache["k"].parts) == 4
    assert eng._cache["k"].parts[0].shape[3] == 1
    assert engine_run(tcfg, tparams, mesh, reqs) \
        == engine_run(tcfg, tparams, None, reqs)


def test_indivisible_kv_heads_shard_only_the_ffn():
    """Reduced tinyllama (2 kv heads) at 4 ways: attention and the pool
    whole on every shard, the FFN cut, the same tokens."""
    _, _, tcfg, tparams = models("tinyllama-1.1b", "fp")
    reqs = matrix_reqs(tcfg, "tinyllama-1.1b")
    mesh = cpu_mesh(4)
    eng = ServingEngine(tcfg, tparams, mesh=mesh, device="cpu", **ENGINE_KW)
    blocks = eng.params["blocks"]
    assert blocks["attn"]["wq"].dim is None
    assert blocks["mlp"]["w_gate"].dim == 2
    assert blocks["mlp"]["w_down"].dim == 1
    assert eng._cache["k"].dim is None
    assert engine_run(tcfg, tparams, mesh, reqs) \
        == solo_run("tinyllama-1.1b", "fp", True)


@pytest.mark.parametrize("vocab,tied", [(255, False), (256, True),
                                        (255, True)])
def test_vocab_cut_on_d_model_and_tied_embeddings(vocab, tied):
    """A vocab that does not divide the axis cuts the embedding and
    lm_head on d_model (granite-3-8b's 49155 at 2 ways); tied embeddings
    unembed through the cut table."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              attn_kernel="off", vocab_size=vocab,
                              tie_embeddings=tied)
    params = TM.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    mesh = cpu_mesh(2)
    placed = TM.init_params(cfg, 0, device="cpu", dtype=torch.float32,
                            mesh=mesh)
    assert placed["embed"].dim == (1 if vocab % 2 else 0)
    assert torch.equal(tsh.gather(placed["embed"]), params["embed"])
    reqs = matrix_reqs(cfg, "tinyllama-1.1b")
    assert engine_run(cfg, placed, mesh, reqs) \
        == engine_run(cfg, params, None, reqs)


def test_speculation_under_a_mesh():
    _, _, tcfg, tparams = models("tinyllama-1.1b", "fp")
    reqs = [(p, 6, pe) for p, _, pe in matrix_reqs(tcfg, "tinyllama-1.1b")]
    kw = dict(spec_decode="ngram", spec_k=3)
    assert engine_run(tcfg, tparams, cpu_mesh(2), reqs, **kw) \
        == engine_run(tcfg, tparams, None, reqs, **kw)


# ---------------------------------------------------------------------------
# Bytes between shards, placement, axis state
# ---------------------------------------------------------------------------

def decode_bytes(cfg, params, mesh, num_blocks):
    """Bytes a sharded decode step moves, after a first chunk, on a pool
    of ``num_blocks`` blocks."""
    B, T = 2, 4
    cache = TM.init_paged_cache(cfg, num_blocks, 8, mesh=mesh)
    tables = torch.arange(1, 1 + B * T, dtype=torch.int32).reshape(B, T)
    toks = torch.arange(1, 13).reshape(B, 6)
    lens = torch.tensor([6, 4], dtype=torch.int32)
    TM.prefill_slots(cfg, params, cache, toks, lens, tables, mesh=mesh)
    mesh.moved_bytes.clear()
    logits, _ = TM.decode_step(cfg, params, cache, toks[:, :1], lens,
                               block_tables=tables, mesh=mesh)
    assert logits.shape == (B, 1, cfg.vocab_size)
    return dict(mesh.moved_bytes), cache


def test_sharded_decode_moves_no_pool_bytes():
    _, _, tcfg, tparams = models("tinyllama-1.1b", "fp")
    mesh = cpu_mesh(2)
    placed = tsh.place_serve(tcfg, tparams, mesh)
    small, _ = decode_bytes(tcfg, placed, mesh, 9)
    big, cache = decode_bytes(tcfg, placed, mesh, 257)
    assert small == big and small["psum"] > 0
    pool = sum(x.numel() * x.element_size() for x in cache["k"].parts)
    assert sum(big.values()) < pool / 2


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_copy_cache_block_keeps_placement(kv_dtype):
    cfg = get_config("tinyllama-1.1b").reduced()
    if kv_dtype != "fp":
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    mesh = cpu_mesh(2)
    cache = TM.init_paged_cache(cfg, 4, 8, mesh=mesh)
    assert set(cache) == ({"k", "v"} if kv_dtype == "fp"
                          else {"k", "v", "k_scale", "v_scale"})
    for x in cache.values():
        assert x.dim == 3 and len(x.parts) == 2
        for p in x.parts:
            p.copy_(torch.arange(p.numel()).reshape(p.shape).to(p.dtype))
    before = {k: [(p, p.shape, p.device) for p in x.parts]
              for k, x in cache.items()}
    whole = {k: tsh.gather(x).clone() for k, x in cache.items()}
    out = TM.copy_cache_block(cache, 2, 1)
    for k, x in out.items():
        assert x.dim == 3
        assert [(p, p.shape, p.device) for p in x.parts] == before[k]
        got = tsh.gather(x)
        assert torch.equal(got[:, 1], whole[k][:, 2])
        assert torch.equal(got[:, 3], whole[k][:, 3])


def test_engine_leaks_no_axis_state():
    _, _, tcfg, tparams = models("tinyllama-1.1b", "fp")
    before = tsh.axis_state()
    mesh = cpu_mesh(2)
    eng = ServingEngine(tcfg, tparams, mesh=mesh, device="cpu", **ENGINE_KW)
    eng.submit(np.arange(1, 9), max_new_tokens=3)
    eng.run()
    assert eng._axes.sizes == (("data", 1), ("model", 2))
    assert tsh.axis_state() == before


def test_one_way_mesh_equals_no_mesh():
    _, _, tcfg, tparams = models("tinyllama-1.1b", "fp")
    reqs = matrix_reqs(tcfg, "tinyllama-1.1b")
    assert engine_run(tcfg, tparams, cpu_mesh(1), reqs) \
        == solo_run("tinyllama-1.1b", "fp", True)
