"""Training on a batch that does not divide the data axes, on meshes that
name the CPU several times: a 3-row batch of reduced fp32 configs.

  * placement: ``place_batch`` at (2, 1), (2, 2), (4, 2) and the (2, 2,
    2) pod mesh keeps every leaf (tokens, labels, vlm patch embeddings,
    audio frames) whole and equal on every place, by the specs of JAX's
    ``batch_specs`` + ``sanitize_specs``;
  * two AdamW steps of ``make_train_step(mesh=)`` for every family at
    those four meshes against JAX's ``make_train_step``: meshless for
    dense, vlm, ssm, hybrid and audio; for moe on T = 3 x 15 tokens
    (odd: no manual path) under ``use_axes`` with each mesh's axes,
    where JAX takes its auto path in one group (the port's grouped path
    on experts cut on E over data and on d over ``model``).  Tolerances
    are ``tests/test_torch_train.py``'s: loss and grad norm within 1e-4
    relative, each leaf within 5e-3 of its largest update; the bytes of
    each first step, by kind, equal to ``dryrun.train_collectives``;
  * the manual MoE path on a batch whole over data (3 x 8: token slices
    of 1.5 rows) at (2, 2), (2, 4) and (2, 2, 2) against JAX's
    ``apply_moe_manual``
    within 1e-5 of the output's largest element, and two steps at (2, 2)
    against JAX's step under the mesh, both run in one subprocess on 8
    forced host devices (``sharding.mesh_context``, as
    ``tests/test_moe_manual.py`` runs it);
  * controls that must fail: the data places' losses summed instead of
    counting the batch once; the manual path's token slice transposed to
    a ``psum`` over data instead of a local pad;
  * bytes: one MoE layer on both branches equal to
    ``dryrun.moe_layer_collectives``; ``dryrun.device_bytes`` counts the
    whole batch on every place.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM, moe as JMOE  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as TM, moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

from test_torch_train_sharding import (OPT, _close, _port_steps,  # noqa
                                       cpu_mesh)
from torch_parity import FAMILY_ARCHS, batches  # noqa: E402

#: Meshes none of whose data axes divide 3 rows: (data, model) and the
#: (pod, data, model) mesh.
MESHES = ((2, 1), (2, 2), (4, 2), (2, 2, 2))
B = 3
#: Positions a row: S = 15 for moe (T = 45, odd: the grouped path).
S = 16
MOE_S = 15
#: The manual path's batch: T = 24 tokens, slices of 12 (1.5 rows) at
#: data 2.
MANUAL = (3, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    about tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def axes_of(mesh):
    return jsh.AxisState(tuple(zip(mesh.axis_names, mesh.devices.shape)))


def jax_params(cfg):
    """The JAX package's fp32 parameters of ``cfg``, drawn under
    ``jax.jit`` (several times faster than op by op here; the subprocess
    draws them alike)."""
    return jax.jit(lambda: jax.tree.map(lambda v: v.astype(jnp.float32),
                                        JM.init_params(
                                            cfg, jax.random.PRNGKey(0))))()


@functools.lru_cache(maxsize=None)
def models(arch):
    """(jax cfg, jax fp32 params, port cfg, port params) of the reduced
    ``arch`` at ``attn_kernel="off"`` (zamba2-7b at 5 layers: two groups
    and a tail), the parameters carried across through numpy."""
    changes = {"num_layers": 5} if arch == "zamba2-7b" else {}
    cfg = dataclasses.replace(jax_config(arch).reduced(), attn_kernel="off",
                              **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               attn_kernel="off", **changes)
    jparams = jax_params(cfg)
    return cfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def jax_steps(jcfg, jparams, jb, axes=None):
    """Two steps of JAX's ``make_train_step`` (under ``jax.jit``, traced
    under ``use_axes(axes)``): (metrics a step, final leaves by path)."""
    step = jax.jit(JS.make_train_step(jcfg, JO.AdamWConfig(**OPT)))
    p, o, metrics = jparams, JO.init(jparams), []
    with jsh.use_axes(axes):
        for _ in range(2):
            p, o, m = step(p, o, jb)
            metrics.append({k: float(v) for k, v in m.items()})
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    return metrics, {"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in flat}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_place_batch_keeps_an_uneven_batch_whole(shape):
    mesh = cpu_mesh(shape)
    for arch in ("tinyllama-1.1b", "internvl2-26b", "whisper-base"):
        jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
        jb, tb = batches(tcfg, B=B, S=S)
        with jsh.use_axes(axes_of(mesh)):
            want = jsh.sanitize_specs(jsh.batch_specs(
                jcfg, jb, jsh.data_axes(), B), jb)
        with tsh.use_axes(mesh):
            specs = tsh.sanitize_specs(tsh.batch_specs(
                tcfg, tb, tsh.data_axes(), B), tb)
        placed = tsh.place_batch(tcfg, tb, mesh)
        assert sorted(placed) == sorted(tb)
        for k, x in placed.items():
            assert tuple(specs[k]) == tuple(want[k]), (arch, k)
            assert all(a is None for a in specs[k]), (arch, k)
            assert x.rows is None and x.dim is None
            assert all(torch.equal(p, tb[k]) for p in x.parts), (arch, k)
    assert tsh.train_rows(mesh, B).split is None
    # A batch the data axes divide is cut as before: contiguous rows.
    R = tsh.data_size(mesh)
    split = tsh.train_rows(mesh, 2 * R).split
    assert split.rows == tuple((2 * i, 2 * i + 1) for i in range(R))
    cut = tsh.place_batch(tcfg, batches(tcfg, B=2 * R, S=S)[1], mesh)
    assert cut["tokens"].rows[1] == 0


# ---------------------------------------------------------------------------
# Two AdamW steps, every family, against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_two_steps_match_jax(arch):
    """moe: JAX's step under each mesh's axes, one run for each distinct
    pair of the reference's dispatch decisions (its groups, its manual
    path), which are all it reads of the axes: here (1, False) at every
    mesh."""
    jcfg, jparams, tcfg, tparams = models(arch)
    moe = tcfg.moe is not None
    jb, tb = batches(tcfg, B=B, S=MOE_S if moe else S)
    refs = {}
    for shape in MESHES:
        mesh = cpu_mesh(shape)
        key = None
        if moe:
            with jsh.use_axes(axes_of(mesh)):
                key = (JMOE._num_groups(B, MOE_S),
                       JMOE.manual_path_available(jcfg, B * MOE_S))
            assert key == (1, False)
            assert not TMOE.expert_parallel(tcfg, mesh, (B, MOE_S))
        if key not in refs:
            refs[key] = jax_steps(jcfg, jparams, jb, axes=key and axes_of(
                mesh))
        _close(_port_steps(tcfg, tparams, tb, mesh), refs[key], tparams)


# ---------------------------------------------------------------------------
# The manual MoE path on a batch whole over data, against JAX's, on forced
# host devices
# ---------------------------------------------------------------------------

JAX_MANUAL = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config
    from repro.launch import steps as JS
    from repro.models import model as JM, moe as JMOE
    from repro.parallel import sharding as sh
    from repro.training import optimizer as JO

    out, opt = sys.argv[1], json.loads(sys.argv[2])
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              attn_kernel="off")
    params = jax.jit(lambda: jax.tree.map(  # as ``jax_params`` draws them
        lambda v: v.astype(jnp.float32),
        JM.init_params(cfg, jax.random.PRNGKey(0))))()
    data = dict(np.load(out + ".in.npz"))
    layer = jax.tree.map(lambda v: v[0], params["blocks"]["moe"])
    res = {}

    def mesh_of(shape):
        # Auto axes: the reference reshapes its (T, d) output, cut on T,
        # back to (B, S, d), which explicit axes refuse for B = 3.
        devs = np.array(jax.devices()[:int(np.prod(shape))])
        return jax.sharding.Mesh(devs.reshape(shape),
                                 ("pod", "data", "model")[-len(shape):])

    for shape in ((2, 2), (2, 4), (2, 2, 2)):
        mesh = mesh_of(shape)
        sh.set_mesh_axis_sizes(mesh)
        T = data["x"].shape[0] * data["x"].shape[1]
        assert JMOE.manual_path_available(cfg, T)
        with sh.mesh_context(mesh):
            y, aux = jax.jit(lambda p_, x_: JMOE.apply_moe_manual(
                cfg, p_, x_))(layer, jnp.asarray(data["x"]))
        res[f"out{shape}"], res[f"aux{shape}"] = y, aux
    mesh = mesh_of((2, 2))
    sh.set_mesh_axis_sizes(mesh)
    batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
    step = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig(**opt)))
    p, o = params, JO.init(params)
    with sh.mesh_context(mesh):
        for i in range(2):
            p, o, m = step(p, o, batch)
            for k, v in m.items():
                res[f"step{i}/{k}"] = v
    for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        res["p/" + "/".join(str(k.key) for k in path)] = v
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
""")


@pytest.fixture(scope="module")
def manual(tmp_path_factory):
    """(port config, port params, x, batch, the JAX results): the
    reduced qwen2-moe-a2.7b (fp32, shared expert), a seeded 3 x 8 x d
    input of its layer 0 and a 3 x 8 training batch; JAX's results by
    key (``out(d, m)``, ``aux(d, m)``, ``step{i}/{metric}``, ``p/{path}``)
    from the subprocess."""
    _, _, tcfg, tparams = models("qwen2-moe-a2.7b")
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(MANUAL + (tcfg.d_model,)) * 0.5).astype(
        np.float32)
    jb, tb = batches(tcfg, B=MANUAL[0], S=MANUAL[1], seed=2)
    path = str(tmp_path_factory.mktemp("manual") / "jax")
    np.savez(path + ".in.npz", x=x, **{k: np.asarray(v)
                                      for k, v in jb.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", JAX_MANUAL, path, json.dumps(OPT)],
        capture_output=True, text=True, cwd=root, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    return tcfg, tparams, torch.from_numpy(x), tb, dict(np.load(
        path + ".npz"))


def placed_layer(tcfg, tparams, mesh):
    """Layer 0's MoE leaves placed by the train rule, the router and the
    shared expert gathered over data (the experts kept cut)."""
    placed = tsh.place_train(tcfg, {"blocks": {"moe": tparams["blocks"][
        "moe"]}}, mesh)["blocks"]["moe"]
    layer = tree_lib.map_leaves(lambda v: v[0], placed)
    return TM.gather_data(layer, keep=lambda path: path[-1] in (
        "w_gate", "w_up", "w_down") and "shared" not in path)


def _whole_out(out, mesh):
    """Model shard 0's output of every data place: each the whole."""
    return [out.parts[g[0]] for g in tsh.groups(mesh, "model")]


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (2, 2, 2)])
def test_manual_path_on_a_whole_batch_matches_jax(shape, manual):
    """At the pod mesh the reference cuts the tokens over pod x data (4
    slices of 6 tokens); the port slices alike and exchanges among each
    pod's data places."""
    tcfg, tparams, x, _, ref = manual
    mesh = cpu_mesh(shape)
    layer = placed_layer(tcfg, tparams, mesh)
    assert TMOE.expert_cuts(layer["w_gate"]) == (True, True)
    xs = tsh.place_batch(tcfg, {"x": x}, mesh)["x"]
    assert xs.rows is None and TMOE.expert_parallel(tcfg, mesh, xs)
    mesh.moved_bytes.clear()
    out, aux = TMOE.apply_moe(tcfg, layer, xs, mesh=mesh)
    assert mesh.moved_bytes == {k: int(round(v)) for k, v in
                                dryrun.moe_layer_collectives(
                                    tcfg, MANUAL[0], MANUAL[1], mesh,
                                    dtype_bytes=4).items() if v}
    assert mesh.moved_bytes["all_gather"] > 0
    want = ref[f"out{shape}"]
    for got in _whole_out(out, mesh):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    for a in aux.parts:
        assert float(a) == pytest.approx(float(ref[f"aux{shape}"]),
                                         abs=1e-6)


def _jax_reference(ref):
    return ([{k: float(ref[f"step{i}/{k}"]) for k in ("loss", "grad_norm",
                                                       "lr")}
             for i in range(2)],
            {k[2:]: v for k, v in ref.items() if k.startswith("p/")})


def test_manual_steps_on_a_whole_batch_match_jax(manual):
    tcfg, tparams, _, tb, ref = manual
    mesh = cpu_mesh((2, 2))
    assert TMOE.expert_parallel(tcfg, mesh, MANUAL)
    _close(_port_steps(tcfg, tparams, tb, mesh), _jax_reference(ref),
           tparams)


# ---------------------------------------------------------------------------
# Controls
# ---------------------------------------------------------------------------

class _PsumBack(torch.autograd.Function):
    """Identity forward over a grid's parts; the backward sums each
    group's cotangents and hands the sum to every member (a ``psum``)."""

    @staticmethod
    def forward(ctx, grps, *parts):
        ctx.grps = grps
        return tuple(p.clone() for p in parts)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for g in ctx.grps:
            acc = sum(gs[k] for k in g)
            for k in g:
                out[k] = acc
        return (None,) + tuple(out)


def test_controls_fail(manual, monkeypatch):
    """Each control's step leaves the limits of its sound twin: the R
    data places' losses summed (the loss and gradient R-fold), and the
    manual path's token slice transposed to a ``psum`` over data (its
    gradient counted R times)."""
    _, _, tcfg, tparams = models("tinyllama-1.1b")
    _, tb = batches(tcfg, B=B, S=S)
    sound = _port_steps(tcfg, tparams, tb, cpu_mesh((2, 1)))
    _close(sound, _port_steps(tcfg, tparams, tb), tparams)
    mean = TM.loss_fn
    monkeypatch.setattr(TM, "loss_fn", lambda cfg, p, b, mesh=None: mean(
        cfg, p, b, mesh=mesh) * tsh.data_size(mesh))
    summed = _port_steps(tcfg, tparams, tb, cpu_mesh((2, 1)))
    assert summed[0][0]["loss"] == pytest.approx(2 * sound[0][0]["loss"])
    with pytest.raises(AssertionError):
        _close(summed, sound, tparams)
    monkeypatch.setattr(TM, "loss_fn", mean)

    tcfg, tparams, _, tb, ref = manual
    mesh = cpu_mesh((2, 2))
    local = TMOE._token_slices

    def psum_back(x, mesh, whole):
        grps = tsh.groups(mesh, TMOE.data_shard_axes(mesh))
        return local(x.with_parts(_PsumBack.apply(grps, *x.parts)), mesh,
                     whole)
    monkeypatch.setattr(TMOE, "_token_slices", psum_back)
    with pytest.raises(AssertionError):
        _close(_port_steps(tcfg, tparams, tb, mesh), _jax_reference(ref),
               tparams)


# ---------------------------------------------------------------------------
# Bytes
# ---------------------------------------------------------------------------

def test_grouped_layer_and_device_bytes(monkeypatch):
    """One MoE layer on the grouped path (T = 3 x 15, odd) at (2, 2) and
    the pod mesh: its bytes equal ``dryrun.moe_layer_collectives`` and
    its output JAX's ``apply_moe`` under ``use_axes`` with the mesh's
    axes (one group, no manual path) within 1e-5 of the largest element,
    and the meshless port's alike; ``dryrun.device_bytes`` counts a
    3-row batch whole on every place (two rows more a place than a 2-row
    batch's cut)."""
    _, jparams, tcfg, tparams = models("qwen2-moe-a2.7b")
    jcfg = jax_config("qwen2-moe-a2.7b").reduced()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, MOE_S, tcfg.d_model)) * 0.5).astype(
        np.float32)
    jlayer = jax.tree.map(lambda v: v[0], jparams["blocks"]["moe"])
    whole = tree_lib.map_leaves(lambda v: v[0], tparams["blocks"]["moe"])
    port = TMOE.apply_moe(tcfg, whole, torch.from_numpy(x))
    for shape in ((2, 2), (2, 2, 2)):
        mesh = cpu_mesh(shape)
        with jsh.use_axes(axes_of(mesh)):
            assert JMOE._num_groups(B, MOE_S) == 1
            assert not JMOE.manual_path_available(jcfg, B * MOE_S)
            ref = JMOE.apply_moe(jcfg, jlayer, jnp.asarray(x))
        layer = placed_layer(tcfg, tparams, mesh)
        xs = tsh.place_batch(tcfg, {"x": torch.from_numpy(x)}, mesh)["x"]
        assert not TMOE.expert_parallel(tcfg, mesh, xs)
        mesh.moved_bytes.clear()
        out, aux = TMOE.apply_moe(tcfg, layer, xs, mesh=mesh)
        assert mesh.moved_bytes == {k: int(round(v)) for k, v in
                                    dryrun.moe_layer_collectives(
                                        tcfg, B, MOE_S, mesh,
                                        dtype_bytes=4).items() if v}
        for want, aux_want in (ref, port):  # JAX's, the meshless port's
            want = np.asarray(want)
            for got in _whole_out(out, mesh):
                assert np.abs(got.numpy() - want).max() <= \
                    1e-5 * np.abs(want).max()
            for a in aux.parts:
                assert float(a) == pytest.approx(float(aux_want), rel=1e-6)
    cfg = get_config("tinyllama-1.1b")
    mesh = cpu_mesh((2, 2))
    got = {}
    for rows in (B, 2):
        monkeypatch.setitem(SHAPES, "train_4k", dataclasses.replace(
            SHAPES["train_4k"], global_batch=rows))
        got[rows] = dryrun.device_bytes(cfg, "train_4k", mesh)
    seq = SHAPES["train_4k"].seq_len
    # Tokens and labels, int32: 3 rows a place against 1 of 2.
    assert got[B]["argument_size_in_bytes"] - got[2][
        "argument_size_in_bytes"] == 2 * seq * 2 * 4
