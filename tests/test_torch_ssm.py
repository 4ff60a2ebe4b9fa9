"""The port's ssm and hybrid families (mamba2-1.3b, zamba2-7b) against
the JAX package: the SSD scan's torch twin and its route through the SSD
kernel's entry point, the Mamba-2 block's prefill and decode, reduced
models' prefill + decode, the wave engine, and the refusals.

Inputs come from numpy seeds; weights from the JAX ``init_params``
through ``params_from_numpy``.  The JAX side runs ``attn_kernel="off"``
and its jnp references.  Tolerances: the scan and the block in fp32 to
1e-5 (the same arithmetic summed in another order), the block's
outputs and caches to 1e-4 (its projections sum 64-256 products of
magnitude ~1 in another order first); the kernel route
(``ssd_via_kernel`` through ``ops.ssd``'s plain recurrence on the CPU)
to 1e-5 relative in norm; models with fp32 params to 1e-4 of the range
of the logits and of each fp32 cache leaf (measured at most 1.5e-5
after five layers); with bf16 params to 5e-2 of the range, the
reference's own ssm tolerance (``tests/test_system.py``).  Greedy
outputs and engine counters exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from torch_parity import (MAX_LEN, WAVE_STATS, as_np,  # noqa: E402
                          both_engines, pair, stats_of, wave_trace)

ARCHS = ("mamba2-1.3b", "zamba2-7b")
CHUNK = 8
BLOCK_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, S, H, P)).astype(f),
            rng.uniform(0.05, 0.5, (b, S, H)).astype(f),
            -rng.uniform(1.0, 4.0, (H,)).astype(f),
            rng.standard_normal((b, S, G, N)).astype(f),
            rng.standard_normal((b, S, G, N)).astype(f))


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S", [5, CHUNK, 3 * CHUNK])
def test_ssd_chunked_matches_jax(S, init, G):
    """S below, at and at three times the chunk; with and without an
    initial state; one and two groups."""
    b, H, P, N = 2, 4, 8, 8
    x, dt, A, B, C = _scan_inputs(S, b, S, H, P, G, N)
    s0 = np.random.default_rng(9).standard_normal((b, H, P, N)) \
        .astype(np.float32) if init else None
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), CHUNK,
                            None if s0 is None else jnp.asarray(s0))
    ty, ts = TS.ssd_chunked(*_torch(x, dt, A, B, C), CHUNK,
                            None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [5, CHUNK, 3 * CHUNK])
def test_kernel_route_matches_ssd_chunked(S, G):
    """The kernel route's adapter (heads folded into rows, B and C one
    row a group with H / G heads a group, chunk min(chunk, S)) through
    ``ops.ssd`` — on the CPU its plain recurrence — against the twin."""
    b, H, P, N = 2, 4, 8, 8
    args = _torch(*_scan_inputs(S + 10 * G, b, S, H, P, G, N))
    want_y, want_s = TS.ssd_chunked(*args, CHUNK)
    got_y, got_s = TS.ssd_via_kernel(*args, CHUNK)
    assert got_y.shape == want_y.shape and got_s.shape == want_s.shape
    assert _rel(got_y, want_y) <= 1e-5
    assert _rel(got_s, want_s) <= 1e-5
    # A planted fault the limit must see: groups broadcast to the wrong
    # heads (interleaved where the heads are consecutive).
    if G == 2:
        x, dt, A, B, C = args
        swapped = [B.flip(2), C.flip(2)]
        bad_y, _ = TS.ssd_via_kernel(x, dt, A, *swapped, CHUNK)
        assert _rel(bad_y, want_y) > 1e-2


def test_prompt_longer_than_a_chunk_must_fill_chunks():
    b, H, P, G, N = 1, 2, 4, 1, 4
    args = _torch(*_scan_inputs(0, b, CHUNK + 3, H, P, G, N))
    for scan in (TS.ssd_chunked, TS.ssd_via_kernel):
        with pytest.raises(ValueError, match="multiple"):
            scan(*args, CHUNK)
    _, _, tcfg, tparams = pair("mamba2-1.3b")
    bad = tcfg.ssm.chunk_size + 1
    toks = torch.ones(1, bad, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        TM.prefill(tcfg, tparams, {"tokens": toks}, bad + 4)
    eng = ServingEngine(tcfg, tparams, max_len=2 * bad, device="cpu")
    eng.submit(np.ones(bad, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="multiple"):
        eng.run()


def _block(arch):
    """The reduced arch's config and one Mamba-2 block's fp32 params in
    both packages."""
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.init_mamba_block(jcfg, jax.random.PRNGKey(3)))
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [2, 24, 64])
def test_mamba_block_and_decode_match_jax(S):
    """apply_mamba_block's output and cache, then two apply_mamba_decode
    steps' outputs and caches.  S = 2: a prompt shorter than the conv
    window; the port leads its window with the causal conv's zeros where
    the reference keeps only S inputs (and its decode cannot run), so the
    reference's window is padded here the same way."""
    jcfg, jp, tcfg, tp = _block("mamba2-1.3b")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    ty, tc = TS.apply_mamba_block(tcfg, tp, torch.from_numpy(x))
    jy, jc = JS.apply_mamba_block(jcfg, jp, jnp.asarray(x))
    pad = tcfg.ssm.conv_kernel - 1 - jc["conv"].shape[1]
    if pad:
        assert (tc["conv"][:, :pad] == 0).all()
        jc = dict(jc, conv=jnp.pad(jc["conv"], ((0, 0), (pad, 0), (0, 0))))

    def close(got, want, what):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL,
                                   err_msg=what)

    close(ty, jy, "prefill")
    for step in range(3):
        for k in ("state", "conv"):
            close(tc[k], jc[k], f"{k} after step {step}")
        if step == 2:
            break
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = JS.apply_mamba_decode(jcfg, jp, jc, jnp.asarray(xt))
        ty, tc = TS.apply_mamba_decode(tcfg, tp, tc, torch.from_numpy(xt))
        close(ty, jy, f"decode {step}")


def test_kernel_route_in_the_block():
    """apply_mamba_block with the kernel route selected (``use_kernel``:
    on the CPU ``ops.ssd`` runs its plain recurrence) equals the plain
    route, and refuses an initial state rather than falling back."""
    _, _, tcfg, tp = _block("zamba2-7b")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 2 * tcfg.ssm.chunk_size, tcfg.d_model)).astype(np.float32))
    want, wc = TS.apply_mamba_block(tcfg, tp, x)
    got, gc = TS.apply_mamba_block(tcfg, tp, x, use_kernel=True)
    assert _rel(got, want) <= 1e-5 and _rel(gc["state"], wc["state"]) <= 1e-5
    assert torch.equal(gc["conv"], wc["conv"])
    with pytest.raises(ValueError, match="initial_state"):
        TS.apply_mamba_block(tcfg, tp, x, initial_state=wc["state"],
                             use_kernel=True)


def _model_run(jcfg, jparams, tcfg, tparams, S, steps=3):
    """prefill (2 rows of S tokens) then ``steps`` decode steps in both
    packages: [(what, jax logits, port logits)], both caches."""
    rng = np.random.default_rng(S)
    toks = rng.integers(1, tcfg.vocab_size, (2, S + steps)).astype(np.int32)
    max_len = S + steps + 4
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len)
    tl, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len)
    out = [("prefill", as_np(jl), as_np(tl))]
    for i in range(steps):
        t = toks[:, S + i:S + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(t),
                                jnp.int32(S + i))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(t),
                                torch.tensor(S + i))
        out.append((f"decode {i}", as_np(jl), as_np(tl)))
    return out, jc, tc


def _flat(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _check_logits(steps, share):
    for what, want, got in steps:
        span = want.max() - want.min()
        assert np.abs(got - want).max() <= share * span, what


@pytest.mark.parametrize("S", [5, 64])
@pytest.mark.parametrize("arch,tail", [("mamba2-1.3b", False),
                                       ("zamba2-7b", False),
                                       ("zamba2-7b", True)])
def test_model_fp32_matches_jax(arch, tail, S):
    """fp32 params: logits, and every fp32 cache leaf (states, conv
    windows), within 1e-4 of their range; the shared attention's bf16
    stripes within a bf16 rounding (1e-2)."""
    # zamba2-7b reduced is one group of 2 and no tail: 5 layers give 2
    # groups and a tail of 1.
    models = pair(arch, **(dict(num_layers=5) if tail else {}))
    steps, jc, tc = _model_run(*models, S)
    _check_logits(steps, 1e-4)
    jflat, tflat = dict(_flat(jc)), dict(_flat(tc))
    assert set(jflat) == set(tflat)
    for k, v in tflat.items():
        got, want = as_np(v), as_np(jflat[k])
        if v.dtype == torch.float32:
            assert np.abs(got - want).max() <= 1e-4 * np.ptp(want), k
        else:
            np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS + ("whisper-base",))
def test_init_cache_matches_jax(arch):
    """The dense cache's layout, leaf by leaf (shape and dtype), is the
    reference's ``init_cache``; an ssm or hybrid prefill with bf16 params
    fills that same layout."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jflat = dict(_flat(JM.init_cache(jcfg, 2, 16)))
    tflat = dict(_flat(TM.init_cache(tcfg, 2, 16, device="cpu")))
    assert set(jflat) == set(tflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype) == f"torch.{jflat[k].dtype}", k
        assert not v.any(), k
    if tcfg.family == "audio":
        return
    params = TM.init_params(tcfg, seed=0, device="cpu")
    _, cache = TM.prefill(tcfg, params, {"tokens": torch.ones(
        2, 8, dtype=torch.int32)}, 16)
    filled = dict(_flat(cache))
    assert set(filled) == set(tflat)
    for k, v in filled.items():
        assert (v.shape, v.dtype) == (tflat[k].shape, tflat[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bf16_matches_jax(arch):
    """bf16 params (the fp32 Mamba-2 leaves stay fp32 in both): logits
    within the reference's ssm tolerance, 5e-2 of their range."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), attn_kernel="off")
    tcfg = dataclasses.replace(get_config(arch).reduced(), attn_kernel="off")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    A_log = tparams["blocks" if arch == "mamba2-1.3b" else "groups"][
        "mamba"]["A_log"]
    assert A_log.dtype == torch.float32
    steps, _, _ = _model_run(jcfg, jparams, tcfg, tparams, 64)
    _check_logits(steps, 5e-2)


def test_decode_reading_another_rows_state_fails():
    """A control for the limit: the port's decode fed row 1's SSM states
    for row 0 must miss the JAX logits by far more than 1e-4 of their
    range."""
    jcfg, jparams, tcfg, tparams = pair("mamba2-1.3b")
    toks = np.random.default_rng(4).integers(1, 256, (2, 9)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :8])},
                       MAX_LEN)
    _, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :8])}, MAX_LEN)
    tc["state"][:, 0] = tc["state"][:, 1].clone()
    jl, _ = JM.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, 8:]),
                           jnp.int32(8))
    tl, _ = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(toks[:, 8:]),
                           torch.tensor(8))
    want, got = as_np(jl), as_np(tl)
    assert np.abs(got[0] - want[0]).max() > 100 * 1e-4 * np.ptp(want)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4 * np.ptp(want))


def test_init_params_fixes_the_mamba_leaves():
    """Random init draws the weights but keeps the reference's fixed
    values (and fp32) for A_log, D and dt_bias, ones for norm_scale and
    zeros for conv_b; its tree and shapes are the JAX package's."""
    cfg = get_config("zamba2-7b").reduced()
    p = TM.init_params(cfg, 0, device="cpu")
    m = p["groups"]["mamba"]
    H = cfg.ssm.nheads(cfg.d_model)
    assert m["A_log"].dtype == m["D"].dtype == m["dt_bias"].dtype \
        == torch.float32
    want = torch.log(torch.linspace(1.0, 16.0, H))
    assert torch.allclose(m["A_log"][0, 1], want)
    assert (m["D"] == 1).all() and (m["dt_bias"] == 0).all()
    assert (m["norm_scale"] == 1).all() and (m["conv_b"] == 0).all()
    assert m["in_proj"].dtype == torch.bfloat16 and m["in_proj"].std() > 0
    jparams = JM.init_params(jax_config("zamba2-7b").reduced(),
                             jax.random.PRNGKey(0))
    jshapes = {k: tuple(v.shape) for k, v in _flat(
        jax.tree.map(np.asarray, jparams))}
    assert jshapes == {k: tuple(v.shape) for k, v in _flat(p)}
    for arch in ARCHS + ("whisper-base",):
        assert TM.param_count(get_config(arch)) == JM.param_count(
            jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_wave_engine_matches_jax(arch):
    """Greedy outputs and the wave counters of the JAX engine, with mode
    'auto' resolving to 'wave' in both."""
    models = pair(arch)
    (jout, jstats), (tout, tstats) = both_engines(models, wave_trace(),
                                                  mode="auto")
    assert tout == jout
    assert stats_of(tstats, WAVE_STATS) == stats_of(jstats, WAVE_STATS)
    eng = ServingEngine(models[2], models[3], device="cpu")
    assert eng.mode == "wave"


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch):
    """No paged pool for the recurrent families: continuous mode raises
    the reference's ValueError, the paged entry points its
    NotImplementedError; speculation needs continuous mode."""
    _, _, tcfg, tparams = pair(arch)
    with pytest.raises(ValueError, match="block-addressable"):
        ServingEngine(tcfg, tparams, mode="continuous", device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        ServingEngine(tcfg, tparams, spec_decode="ngram", device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        TM.init_paged_cache(tcfg, 5, 4, device="cpu")
    toks = torch.ones(1, 4, dtype=torch.int32)
    lens = torch.full((1,), 4, dtype=torch.int32)
    tbl = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        TM.prefill_slots(tcfg, tparams, {}, toks, lens, tbl)
    with pytest.raises(NotImplementedError, match="paged"):
        TM.decode_step(tcfg, tparams, {}, toks[:, :1], lens, block_tables=tbl)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        TM.prefill(dataclasses.replace(tcfg, attn_kernel="on"), tparams,
                   {"tokens": toks}, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_reduced_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert len(out) == 3 and all(len(t) == 4 for t in out.values())
    assert "wave engine" in capsys.readouterr().out


@pytest.mark.parametrize("groups,m", [(1, None), (2, None), (1, 2), (2, 2)])
def test_kernel_route_by_group_in_the_block(groups, m, monkeypatch):
    """The block's kernel route hands ``ops.ssd`` b and c one row a group,
    (rows x G, S, N) with H / G heads a group (never repeated a head), and
    equals the plain route within the fp32 limit: the reduced mamba2-1.3b
    and the same with two groups, meshless and at a ``model`` shard of 2
    (one group: each shard's H / 2 heads share it; two groups: the block
    stays whole, every shard runs every head)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as tsh
    jcfg = jax_config("mamba2-1.3b").reduced()
    tcfg = get_config("mamba2-1.3b").reduced()
    if groups != 1:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, ngroups=groups))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, ngroups=groups))
    jp = JS.init_mamba_block(jcfg, jax.random.PRNGKey(3))
    tp = {k: tensor_from_numpy(np.asarray(v, np.float32))
          for k, v in jp.items()}
    S = 2 * tcfg.ssm.chunk_size
    x = torch.from_numpy(np.random.default_rng(groups).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32))
    seen = []
    ssd = TS.ssd_ops.ssd

    def spy(x_, dt, A, b, c, **kw):
        seen.append((tuple(x_.shape), tuple(b.shape), tuple(c.shape), kw))
        return ssd(x_, dt, A, b, c, **kw)

    monkeypatch.setattr(TS.ssd_ops, "ssd", spy)
    mesh = None if m is None else make_mesh((1, m), ("data", "model"), "cpu")
    want, wc = TS.apply_mamba_block(tcfg, tp, x)
    if mesh is None:
        got, gc = TS.apply_mamba_block(tcfg, tp, x, use_kernel=True)
        state, places = gc["state"], 1
    else:
        placed = {k: tsh.shard(v, tsh.mamba_spec(tcfg, mesh, k, v.dim()),
                               mesh) for k, v in tp.items()}
        got, gc = TS.apply_mamba_block(tcfg, placed, tsh.broadcast(x, mesh),
                                       use_kernel=True, mesh=mesh)
        got, state, places = got.parts[0], tsh.gather(gc["state"]), m
    _, H, G, N, P, _ = TS.dims(tcfg)
    Hs = H // tsh.mamba_shard_size(mesh, tcfg)
    assert seen == [((2 * Hs, S, P), (2 * G, S, N), (2 * G, S, N),
                     {"chunk": tcfg.ssm.chunk_size,
                      "heads_per_group": Hs // G})] * places
    assert _rel(got, want) <= 1e-5 and _rel(state, wc["state"]) <= 1e-5
