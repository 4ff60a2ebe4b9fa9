"""The port's wave path over a ``model`` mesh axis, every family, on the
CPU: meshes of (data=1, model=m) naming the CPU m times.

  * placement: the Mamba-2 leaves cut head-aligned by component
    (``sharding.mamba_spec``), the wave caches by
    ``sharding.wave_cache_specs``; every placed leaf gathers back to the
    whole leaf bit for bit;
  * the Mamba-2 block and decode step at m = 2 and 4 against the JAX
    package's ``apply_mamba_block`` / ``apply_mamba_decode`` and the
    meshless port, within 1e-5 of the largest element (fp32, the same
    arithmetic summed in another order: the gated norm's sum of squares
    and ``out_proj`` are summed over the shards); a per-shard mean in
    the gated norm fails that limit;
  * the dense decode read per shard on placed stripes (the plain route
    here) equal to one read over every head, bit for bit;
  * ``prefill`` and two ``decode_step``s of reduced models with fp32
    weights under a mesh against meshless, within 1e-5 of the logits'
    range;
  * the engine: ``ServingEngine(mode="wave", mesh=...)`` greedy tokens
    and wave counters at m = 2 and 4 equal the meshless port's and the
    JAX engine's meshless wave run, on bf16 and f8 stripes (f8 against
    JAX too: the reduced models' K/V stay far below 464, where the
    casts agree);
  * the bytes a decode step moves between shards equal the analytic
    count of its collectives: no stripe, state or window byte.

Weights come from the JAX ``init_params`` (fp32) through
``params_from_numpy`` (``torch_parity.pair``); inputs from numpy seeds.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (FAMILY_ARCHS, WAVE_STATS, pair,  # noqa: E402
                          run, stats_of, wave_trace)

#: fp32 sharded vs meshless or JAX, a share of the largest element (the
#: block) or of the logits' range (the models): the same arithmetic
#: summed in another order reads ~1e-7-1e-6 here.
TOL = 1e-5
WAYS = (2, 4)


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
    return make_mesh((1, m), ("data", "model"), "cpu")


def within(got, want, what="", of="max"):
    """max |got - want| within TOL of want's largest magnitude
    (``of="max"``) or of its range (``of="range"``)."""
    got, want = (np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                            np.float32) for x in (got, want))
    scale = np.abs(want).max() if of == "max" else np.ptp(want)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _bits(x):
    return kv_quant.raw(x.contiguous())


@functools.lru_cache(maxsize=None)
def models(arch, kv_dtype="fp"):
    """``pair(arch)`` with ``kv_dtype``; zamba2-7b at 5 layers (two groups
    and a tail)."""
    kw = {} if kv_dtype == "fp" else {"kv_dtype": kv_dtype}
    if arch == "zamba2-7b":
        kw["num_layers"] = 5
    return pair(arch, **kw)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b",
                                  "whisper-base"])
@pytest.mark.parametrize("m", WAYS)
def test_placed_params_gather_back_bitwise(arch, m):
    _, _, cfg, params = models(arch)
    mesh = cpu_mesh(m)
    placed = tsh.place_serve(cfg, params, mesh)
    for (path, x), (_, want) in zip(tree_lib.flatten(placed),
                                    tree_lib.flatten(params)):
        assert torch.equal(tsh.gather(x), want), path
        assert torch.equal(tsh.to_whole(x), want), path


@pytest.mark.parametrize("m", WAYS)
def test_component_cut_keeps_each_shards_heads(m):
    """in_proj's part j is [z_j | x_j | B | C | dt_j] and conv_w's [x_j |
    B | C]: shard j's own heads' columns, B and C whole (one group)."""
    _, _, cfg, params = models("mamba2-1.3b")
    d_inner, H, G, N, P, _ = TS.dims(cfg)
    mesh = cpu_mesh(m)
    placed = tsh.place_serve(cfg, params, mesh)
    w = params["blocks"]["mamba"]["in_proj"]
    cw = params["blocks"]["mamba"]["conv_w"]
    di, h = d_inner // m, H // m
    z, x, bc, dt = (w[..., :d_inner], w[..., d_inner:2 * d_inner],
                    w[..., 2 * d_inner:2 * d_inner + 2 * G * N],
                    w[..., -H:])
    for j in range(m):
        part = placed["blocks"]["mamba"]["in_proj"].parts[j]
        heads = slice(j * di, (j + 1) * di)
        want = torch.cat([z[..., heads], x[..., heads], bc,
                          dt[..., j * h:(j + 1) * h]], -1)
        assert torch.equal(part, want)
        cpart = placed["blocks"]["mamba"]["conv_w"].parts[j]
        assert torch.equal(cpart, torch.cat(
            [cw[..., heads], cw[..., d_inner:]], -1))
        for leaf in ("A_log", "D", "dt_bias"):
            assert torch.equal(placed["blocks"]["mamba"][leaf].parts[j],
                               params["blocks"]["mamba"][leaf][
                                   ..., j * h:(j + 1) * h])
    assert placed["blocks"]["mamba"]["out_proj"].dim == 1


def test_indivisible_mamba_heads_stay_whole():
    """8 heads on 3 ways: every Mamba-2 leaf and cache whole on every
    shard."""
    _, _, cfg, params = models("mamba2-1.3b")
    mesh = cpu_mesh(3)
    assert tsh.mamba_shard_size(mesh, cfg) == 1
    placed = tsh.place_serve(cfg, params, mesh)
    for leaf in placed["blocks"]["mamba"].values():
        assert leaf.dim is None
    cache = TM.init_cache(cfg, 2, 8, mesh=mesh)
    assert all(x.dim is None for x in cache.values())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kv_dtype", ["fp", "f8"])
def test_wave_cache_placement_gathers_back_bitwise(arch, kv_dtype):
    """init_cache(mesh=) places every leaf as wave_cache_specs says; a
    random whole cache placed by those specs gathers back bit for bit
    (f8 stripes as bytes)."""
    _, _, cfg, _ = models(arch, kv_dtype)
    mesh = cpu_mesh(2)
    cache = TM.init_cache(cfg, 2, 8, mesh=mesh)
    whole = TM.init_cache(cfg, 2, 8, device="cpu")
    specs = tsh.wave_cache_specs(cfg, whole, mesh)
    gen = torch.Generator().manual_seed(0)
    for (path, x), (_, w), (_, spec) in zip(
            tree_lib.flatten(cache), tree_lib.flatten(whole),
            tree_lib.flatten(specs)):
        assert x.shape == w.shape and x.dtype == w.dtype, path
        name = path.rsplit("/", 1)[-1]
        want_dim = {"state": w.dim() - 3, "conv": w.dim() - 1}.get(
            name, w.dim() - 2)
        assert x.dim == want_dim, path
        assert (x.comps is not None) == (name == "conv"), path
        full = torch.randn(w.shape, generator=gen).to(w.dtype)
        placed = tsh.shard(full, spec, mesh)
        assert [p.shape for p in placed.parts] == \
            [p.shape for p in x.parts], path
        assert torch.equal(_bits(tsh.gather(placed)), _bits(full)), path


# ---------------------------------------------------------------------------
# The Mamba-2 block and decode step
# ---------------------------------------------------------------------------

def _block():
    """The reduced mamba2-1.3b's config and one Mamba-2 block's fp32
    params in both packages."""
    jcfg = jax_config("mamba2-1.3b").reduced()
    tcfg = get_config("mamba2-1.3b").reduced()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.init_mamba_block(jcfg, jax.random.PRNGKey(3)))
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def _placed_block(cfg, p, mesh):
    return {k: tsh.shard(v, tsh.mamba_spec(cfg, mesh, k, v.dim()), mesh)
            for k, v in p.items()}


def _block_steps(cfg, p, x, xs, mesh=None, use_kernel=False):
    """apply_mamba_block on x, then apply_mamba_decode on each of xs:
    [(output, {state, conv})] gathered whole."""
    bc = functools.partial(tsh.broadcast, mesh=mesh)
    y, c = TS.apply_mamba_block(cfg, p, bc(x), use_kernel=use_kernel,
                                mesh=mesh)
    out = [(y, c)]
    for xt in xs:
        y, c = TS.apply_mamba_decode(cfg, p, c, bc(xt), mesh=mesh)
        out.append((y, c))
    if mesh is None:
        return out
    return [(y.parts[0], {k: tsh.gather(v) for k, v in c.items()})
            for y, c in out]


def _jax_steps(jcfg, jp, x, xs):
    """The same steps through the JAX package (S = 24 > the window)."""
    jy, jc = JS.apply_mamba_block(jcfg, jp, jnp.asarray(x.numpy()))
    out = [(jy, jc)]
    for xt in xs:
        jy, jc = JS.apply_mamba_decode(jcfg, jp, jc, jnp.asarray(xt.numpy()))
        out.append((jy, jc))
    return out


def _inputs(cfg, S=24, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32)) for _ in range(2)]
    return x, xs


@pytest.mark.parametrize("m", WAYS)
def test_mamba_block_and_decode_sharded_match_jax(m):
    jcfg, jp, cfg, p = _block()
    mesh = cpu_mesh(m)
    x, xs = _inputs(cfg)
    got = _block_steps(cfg, _placed_block(cfg, p, mesh), x, xs, mesh)
    solo = _block_steps(cfg, p, x, xs)
    want = _jax_steps(jcfg, jp, x, xs)
    for step, ((y, c), (sy, sc), (jy, jc)) in enumerate(zip(got, solo,
                                                            want)):
        within(y, jy, f"step {step} vs JAX")
        within(y, sy, f"step {step} vs meshless")
        for k in ("state", "conv"):
            within(c[k], np.asarray(jc[k]), f"step {step} {k} vs JAX")
            within(c[k], sc[k], f"step {step} {k} vs meshless")


def test_per_shard_mean_in_the_gated_norm_fails(monkeypatch):
    """The gated norm's mean runs over all d_inner columns.  Shard 1's
    heads scaled up (its z and x columns x 8): a per-shard mean (each
    shard's sum of squares over its own columns, times m) leaves the
    outputs far outside the limit the sound norm meets."""
    jcfg, jp, cfg, p = _block()
    d_inner = TS.dims(cfg)[0]
    scale = torch.ones(p["in_proj"].shape[1])
    for lo in (d_inner // 2, d_inner + d_inner // 2):
        scale[lo:lo + d_inner // 2] = 8.0
    p = dict(p, in_proj=p["in_proj"] * scale)
    jp = dict(jp, in_proj=jnp.asarray(p["in_proj"].numpy()))
    m, mesh = 2, cpu_mesh(2)
    x, xs = _inputs(cfg)
    want = _jax_steps(jcfg, jp, x, xs)
    got = _block_steps(cfg, _placed_block(cfg, p, mesh), x, xs, mesh)
    for (y, _), (jy, _) in zip(got, want):
        within(y, jy, "sound norm")
    monkeypatch.setattr(TS, "_sum_squares", lambda g, mesh_: tsh.smap(
        lambda t: t.square().sum(-1, keepdim=True) * m, g, mesh=mesh_))
    bad = _block_steps(cfg, _placed_block(cfg, p, mesh), x, xs, mesh)
    with pytest.raises(AssertionError):
        within(bad[0][0], want[0][0], "per-shard mean")


@pytest.mark.parametrize("m", WAYS)
def test_kernel_route_runs_once_a_shard(m, monkeypatch):
    """The scan through ``ops.ssd`` (its plain recurrence on the CPU),
    one call a shard on its b x H/m folded rows, equal to the plain
    route within the block's limit."""
    _, _, cfg, p = _block()
    mesh = cpu_mesh(m)
    calls = []
    ssd = ssd_ops.ssd

    def counted(x, *a, **kw):
        calls.append(x.shape)
        return ssd(x, *a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd", counted)
    x, _ = _inputs(cfg, S=16)
    placed = _placed_block(cfg, p, mesh)
    y = _block_steps(cfg, placed, x, [], mesh, use_kernel=True)[0]
    H = TS.dims(cfg)[1]
    assert calls == [(2 * H // m, 16, cfg.ssm.head_dim)] * m
    plain = _block_steps(cfg, placed, x, [], mesh)[0]
    within(y[0], plain[0], "kernel route vs plain")
    within(y[1]["state"], plain[1]["state"], "state")


# ---------------------------------------------------------------------------
# The dense decode read per shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("m", WAYS)
def test_sharded_dense_decode_matches_single(dtype, m):
    gen = torch.Generator().manual_seed(m)
    B, S, H, Hk, D = 3, 20, 8, 4, 16
    q = torch.randn(B, H, D, generator=gen)
    kc, vc = (torch.randn(B, S, Hk, D, generator=gen).to(dtype)
              for _ in range(2))
    lens = torch.tensor([1, 7, 20], dtype=torch.int32)
    mesh = cpu_mesh(m)
    spec = tsh.P(None, None, "model", None)
    solo = decode_ops.decode_attention(q, kc, vc, lens)
    shard = decode_ops.decode_attention(
        q, tsh.shard(kc, spec, mesh), tsh.shard(vc, spec, mesh), lens,
        mesh=mesh)
    assert torch.equal(solo, shard)
    with pytest.raises(TypeError, match="placed first"):
        decode_ops.decode_attention(q, kc, vc, lens, mesh=mesh)


# ---------------------------------------------------------------------------
# Model steps
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int64))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return batch


def _steps(cfg, params, batch, mesh=None, steps=2):
    """prefill, then ``steps`` greedy decode_steps: every logit set and
    the final cache."""
    S = batch["tokens"].shape[1]
    with tsh.use_axes(mesh):
        logits, cache = TM.prefill(cfg, params, batch, S + 4, mesh=mesh)
        out = [logits]
        for i in range(steps):
            tok = out[-1].reshape(logits.shape[0], -1).argmax(-1)[:, None]
            d, cache = TM.decode_step(cfg, params, cache, tok, S + i,
                                      mesh=mesh)
            out.append(d[:, 0])
    return out, cache


@functools.lru_cache(maxsize=None)
def _solo(arch):
    _, _, cfg, params = models(arch)
    return _steps(cfg, params, _batch(cfg))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("m", WAYS)
def test_model_steps_sharded_match_meshless(arch, m):
    """Logits within 1e-5 of the range; the caches gathered back within
    the same share of their largest element (the bf16 stripes within a
    bf16 rounding).  At 4 ways the reduced attention configs' 2 KV heads
    do not divide: their attention and stripes stay whole."""
    _, _, cfg, params = models(arch)
    mesh = cpu_mesh(m)
    got, cache = _steps(cfg, tsh.place_serve(cfg, params, mesh),
                        _batch(cfg), mesh)
    want, wcache = _solo(arch)
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.device == y.device and x.shape == y.shape
        within(x, y, f"logits {i}", of="range")
    for (path, x), (_, y) in zip(tree_lib.flatten(cache),
                                 tree_lib.flatten(wcache)):
        got_ = tsh.gather(x).float()
        tol = 1e-2 if y.dtype == torch.bfloat16 else 1e-4
        assert (got_ - y.float()).abs().max() <= tol * y.float().abs() \
            .max(), path
    if cfg.num_kv_heads % m:
        assert all(x.dim is None for p, x in tree_lib.flatten(cache)
                   if p.rsplit("/", 1)[-1] in ("k", "v", "attn_k",
                                               "attn_v"))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "zamba2-7b", "whisper-base"])
def test_wrong_shard_slice_fails(arch):
    """Shard 1 handed shard 0's first-layer q/k/v or in_proj part: the
    logits leave the limit."""
    _, _, cfg, params = models(arch)
    mesh = cpu_mesh(2)
    placed = tsh.place_serve(cfg, params, mesh)
    key = {"mamba2-1.3b": ("blocks", "mamba", "in_proj"),
           "zamba2-7b": ("shared_attn", "attn", "wq"),
           "whisper-base": ("dec_blocks", "self_attn", "wq")}.get(
               arch, ("blocks", "attn", "wq"))
    node = placed
    for k in key[:-1]:
        node = node[k]
    good = node[key[-1]]
    node[key[-1]] = good.with_parts((good.parts[0],) * 2)
    got, _ = _steps(cfg, placed, _batch(cfg), mesh)
    with pytest.raises(AssertionError):
        for i, (x, y) in enumerate(zip(got, _solo(arch)[0])):
            within(x, y, f"logits {i}", of="range")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

KW = dict(max_batch=3, max_len=32, eos_id=-1, seed=5)


def _engine(cfg, params, mesh=None, mode="wave"):
    eng = ServingEngine(cfg, params, mesh=mesh, mode=mode, device="cpu",
                        **KW)
    return run(eng, wave_trace(cfg.vocab_size)), \
        stats_of(eng.stats, WAVE_STATS), eng


@functools.lru_cache(maxsize=None)
def _solo_engine(arch, kv_dtype):
    _, _, cfg, params = models(arch, kv_dtype)
    return _engine(cfg, params)[:2]


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, kv_dtype):
    """The JAX engine's meshless wave run (its whisper encoder handed the
    zero stub frames in fp32, as tests/test_torch_audio.py does)."""
    from repro.serving.engine import ServingEngine as JaxEngine
    jcfg, jparams, tcfg, _ = models(arch, kv_dtype)
    encode = JM.encode_audio
    JM.encode_audio = lambda c, p, frames, *a: encode(
        c, p, frames.astype(p["embed"].dtype), *a)
    try:
        eng = JaxEngine(jcfg, jparams, mode="wave", **KW)
        out = run(eng, wave_trace(tcfg.vocab_size))
    finally:
        JM.encode_audio = encode
    return out, stats_of(eng.stats, WAVE_STATS)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kv_dtype", ["fp", "f8"])
def test_wave_engine_sharded(arch, kv_dtype):
    """Greedy tokens and wave counters at 2 and 4 ways equal the
    meshless port's and the JAX engine's meshless wave run."""
    _, _, cfg, params = models(arch, kv_dtype)
    want = _solo_engine(arch, kv_dtype)
    assert want == _jax_engine(arch, kv_dtype)
    for m in WAYS:
        out, stats, eng = _engine(cfg, params, cpu_mesh(m),
                                  mode="auto" if cfg.family in (
                                      "ssm", "hybrid", "audio") else "wave")
        assert eng.mode == "wave"
        assert (out, stats) == want, m


# ---------------------------------------------------------------------------
# Bytes between shards, axis state
# ---------------------------------------------------------------------------

def wave_decode_bytes(cfg, B, m):
    """The collectives of one wave decode step of B rows on an m-way mesh
    where every cut divides (the reduced configs at 2 ways): the
    embedding's psum; per attention layer the ``wo`` and MLP (or routed
    experts') psums, one more for whisper's cross-attention or an MoE's
    shared expert; per Mamba-2 block the gated
    norm's fp32 sum of squares and ``out_proj``'s psum; the logits'
    all_gather; the broadcast tokens (int64) and positions (int32).  A
    psum moves 2 (m - 1) times its bytes, an all_gather and a broadcast
    m - 1."""
    act = B * cfg.d_model * 4
    if cfg.family in ("ssm", "hybrid"):
        attn, mamba = TM.hybrid_layout(cfg)[0] if cfg.hybrid else 0, \
            cfg.num_layers
    else:
        attn, mamba = cfg.num_layers, 0
    per_attn = 3 if cfg.family == "audio" or (
        cfg.moe is not None and cfg.moe.shared_d_ff) else 2
    psum = act * (1 + per_attn * attn + mamba) + B * 4 * mamba
    return {"psum": 2 * (m - 1) * psum,
            "all_gather": (m - 1) * B * cfg.vocab_size * 4,
            "broadcast": (m - 1) * (B * 8 + B * 4)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_step_moves_only_its_collectives(arch):
    _, _, cfg, params = models(arch)
    mesh = cpu_mesh(2)
    placed = tsh.place_serve(cfg, params, mesh)
    batch = _batch(cfg)
    with tsh.use_axes(mesh):
        _, cache = TM.prefill(cfg, placed, batch, 12, mesh=mesh)
        mesh.moved_bytes.clear()
        TM.decode_step(cfg, placed, cache, batch["tokens"][:, :1], 8,
                       mesh=mesh)
    assert dict(mesh.moved_bytes) == wave_decode_bytes(cfg, 2, 2)


def test_wave_engine_leaks_no_axis_state():
    _, _, cfg, params = models("mamba2-1.3b")
    before = tsh.axis_state()
    eng = ServingEngine(cfg, params, mesh=cpu_mesh(2), device="cpu", **KW)
    eng.submit(np.arange(1, 9), max_new_tokens=3)
    eng.run()
    assert eng.mode == "wave"
    assert eng._axes.sizes == (("data", 1), ("model", 2))
    assert tsh.axis_state() == before


def test_data_axes_and_wave_speculation_still_raise():
    """The moe family now serves waves over data axes above 1 (its
    experts cut on E over data); what stays refused: speculation in
    waves."""
    _, _, moe_cfg, moe_params = models("qwen2-moe-a2.7b")
    eng = ServingEngine(moe_cfg, moe_params, device="cpu", mode="wave",
                        mesh=make_mesh((2, 2), ("data", "model"), "cpu"))
    assert eng.params["blocks"]["moe"]["w_gate"].rows == (("data",), 1)
    _, _, cfg, params = models("mamba2-1.3b")
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(cfg, params, device="cpu",
                      mesh=cpu_mesh(2), spec_decode="ngram")
