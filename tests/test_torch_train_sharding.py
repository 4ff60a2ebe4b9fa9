"""The port's training over a (data, model) mesh, held to the reference
on meshes that name the CPU several times (one device, several places):

  * spec parity with no devices: ``steps.shardings_for``'s in/out specs,
    ``optimizer.state_specs`` and every ``specs.input_specs`` leaf's
    shape and dtype equal the JAX package's, for all ten configs at full
    width, on all four shapes, on the single and multi production meshes
    (the reference's against an abstract mesh, ``SpecMesh``);
  * the collectives' transposes against the plain arithmetic they stand
    for, bytes counted forward and backward;
  * two AdamW steps of ``make_train_step(mesh=)`` on reduced fp32
    configs at (data, model) = (2, 1), (1, 2), (2, 2), (4, 2) and on a
    (pod, data, model) = (2, 2, 2) mesh: dense and vlm against the
    meshless port and JAX's ``make_train_step``; moe at
    (2, 1) against JAX's step under ``use_axes`` with data = 2 (two
    dispatch groups), at (1, 2) against the meshless port; the manual
    MoE path at (2, 2) and (2, 4) against JAX's ``apply_moe`` by the
    reference's own criterion (``tests/test_moe_manual.py``); ssm,
    hybrid and audio at (2, 1) and (1, 2) against the meshless port.
    Tolerances are ``tests/test_torch_train.py``'s: loss and grad norm
    within 1e-4 relative, each leaf within 5e-3 of its largest update;
  * replicated parts forced to be distinct objects: the explicit sum of
    their gradients holds the step, and without it the step is wrong;
  * bytes: at every mesh (the pod mesh and (2, 4) too) the bytes the
    step counts, by kind, equal the dry run's analytic count exactly
    (``dryrun.train_collectives``), checked on every sharded step here;
  * elastic restore: a checkpoint of a (4, 2) placement restores onto
    (2, 4), and a JAX checkpoint onto a port mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES, get_config as jax_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.launch import specs as JSP, steps as JS  # noqa: E402
from repro.models import model as JM, moe as JMOE  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.launch import specs as TSP, steps as TS  # noqa: E402
from repro_torch.models import model as TM, moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

from torch_parity import batches, models_of  # noqa: E402

MESHES = ((2, 1), (1, 2), (2, 2), (4, 2))
#: A multi-pod mesh (pod, data, model): the batch over pod x data, FSDP
#: over data, replicas over pod.
POD = (2, 2, 2)
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
B = 4  # divides every data axis above


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    about tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return mesh_lib.make_mesh(shape, axes, "cpu")


# ---------------------------------------------------------------------------
# Spec parity, no devices
# ---------------------------------------------------------------------------

class SpecMesh(jax.sharding.AbstractMesh):
    """An abstract mesh with the ``devices`` array ``AxisState.from_mesh``
    reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, object)


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, (jax.sharding.NamedSharding, jax.ShapeDtypeStruct)))[0]:
        keys = []
        for p in path:
            if hasattr(p, "name"):
                keys.append("." + p.name)
            elif hasattr(p, "key"):
                keys.append(str(p.key))
            else:
                keys.append(str(p.idx))
        out["/".join(keys)] = leaf
    return out


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_port_flat(getattr(tree, k), path + ("." + k,)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, tsh.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def _meshes(multi):
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return SpecMesh(shape, axes), mesh_lib.make_production_mesh(
        multi_pod=multi)


@pytest.mark.parametrize("arch", list_archs())
def test_shardings_for_match_the_reference(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for multi in (False, True):
        jmesh, tmesh = _meshes(multi)
        for shape in SHAPES:
            jsh_, tsh_ = (JS.shardings_for(jcfg, shape, jmesh),
                          TS.shardings_for(tcfg, shape, tmesh))
            j, t = _jax_flat(jsh_), _port_flat(tsh_)
            assert sorted(j) == sorted(t), (shape, multi)
            for path, ns in j.items():
                assert t[path].mesh is tmesh
                assert tuple(t[path].spec) == tuple(ns.spec), \
                    (shape, multi, path)
            if SHAPES[shape].kind == "train":
                pspec = {k: v.spec for k, v in
                         _port_flat(tsh_[0][0]).items()}
                with jsh.use_axes(jmesh):
                    jstate = JO.state_specs(jax.tree.map(
                        lambda s: s.spec, jsh_[0][0],
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.NamedSharding)))
                tstate = TO.state_specs(tsh_[0][0])
                assert tuple(tstate.step) == tuple(jstate.step)
                for name in ("m", "v"):
                    jf = _jax_flat(getattr(jstate, name))
                    tf = _port_flat(getattr(tstate, name))
                    assert {k: tuple(v.spec) for k, v in tf.items()} == {
                        k: tuple(v) for k, v in jf.items()}
                    assert {k: tuple(v.spec) for k, v in tf.items()} == {
                        k: tuple(v) for k, v in pspec.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_the_reference(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for shape in SHAPES:
        j = _jax_flat(JSP.input_specs(jcfg, shape))
        t = _port_flat(TSP.input_specs(tcfg, shape))
        assert sorted(j) == sorted(t), shape
        for path, leaf in j.items():
            assert tuple(t[path].shape) == tuple(leaf.shape), (shape, path)
            assert t[path].device.type == "meta"
            assert str(t[path].dtype).split(".")[-1] == str(leaf.dtype), \
                (shape, path)


# ---------------------------------------------------------------------------
# The collectives' transposes
# ---------------------------------------------------------------------------

def _parts(mesh, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64)
            for _ in range(mesh.devices.size)]


def _plain(kind, xs):
    """The plain arithmetic of a two-member collective."""
    a, b = xs
    if kind == "psum":
        return [a + b, a + b]
    if kind == "all_gather":
        return [torch.cat([a, b]), torch.cat([a, b])]
    if kind == "all_to_all":
        return [torch.cat([x.chunk(2, 0)[s] for x in xs], 1)
                for s in range(2)]
    return [b, a]  # ppermute, a swap


@pytest.mark.parametrize("kind", ["psum", "all_gather", "all_to_all",
                                  "ppermute"])
def test_collective_transposes(kind):
    """Each collective over ``data`` of a (2, 2) mesh, then a different
    weighting a place, differentiated: outputs and gradients equal the
    plain arithmetic's, and the backward's bytes (the transpose's) are
    counted under ``kind/bwd``."""
    mesh = cpu_mesh((2, 2))
    xs = [x.requires_grad_(True) for x in _parts(mesh, (4, 6), 0)]
    ws = _parts(mesh, {"all_gather": (8, 6), "all_to_all": (2, 12)}.get(
        kind, (4, 6)), 1)
    s = tsh.Sharded(tuple(xs), None, mesh, (("data",), 0))
    out = {"psum": lambda: tsh.psum(s, "data"),
           "all_gather": lambda: tsh.all_gather(s, axis="data"),
           "all_to_all": lambda: tsh.all_to_all(s, "data", 0, 1),
           "ppermute": lambda: tsh.ppermute(s, "data", [(0, 1), (1, 0)])
           }[kind]()
    grads = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip(out.parts, ws)), xs)
    assert tsh.groups(mesh, "data") == ((0, 2), (1, 3))
    for g in tsh.groups(mesh, "data"):
        ref_x = [xs[k].detach().clone().requires_grad_(True) for k in g]
        ref = _plain(kind, ref_x)
        ref_g = torch.autograd.grad(
            sum((o * ws[k]).sum() for o, k in zip(ref, g)), ref_x)
        for i, k in enumerate(g):
            assert torch.equal(out.parts[k], ref[i]), (kind, k)
            assert torch.allclose(grads[k], ref_g[i]), (kind, k)
    assert mesh.moved_bytes[kind] > 0
    assert mesh.moved_bytes[kind + "/bwd"] == mesh.moved_bytes[kind]


# ---------------------------------------------------------------------------
# Sharded train steps
# ---------------------------------------------------------------------------

def _port_steps(tcfg, tparams, tb, mesh=None, n=2, prepare=None,
                count=True):
    """n AdamW steps; -> (metrics a step, whole final leaves by path).
    With ``count`` the first step's bytes between places, by kind, must
    equal the dry run's analytic count exactly."""
    step = TS.make_train_step(tcfg, TO.AdamWConfig(**OPT), mesh=mesh)
    p, b = tparams, tb
    if mesh is not None:
        p = tsh.place_train(tcfg, tparams, mesh)
        b = tsh.place_batch(tcfg, tb, mesh)
        if prepare is not None:
            p = prepare(p)
    o = TO.init(p)
    metrics = []
    for i in range(n):
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and count and mesh is not None:
            want = {k: int(round(v)) for k, v in dryrun.train_collectives(
                tcfg, tb["tokens"].shape[0], tb["tokens"].shape[1], mesh,
                tparams).items() if v}
            assert mesh.moved_bytes == want, mesh.shape
    return metrics, {k: tsh.to_whole(v) for k, v in tree_lib.flatten(p)}


def _jax_steps(jcfg, jparams, jb, n=2, axes=None):
    step = JS.make_train_step(jcfg, JO.AdamWConfig(**OPT))
    p, o = jparams, JO.init(jparams)
    metrics = []
    for _ in range(n):
        with jsh.use_axes(axes):
            p, o, m = step(p, o, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    return metrics, {"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in flat}


def _close(got, want, start):
    """test_torch_train.py's tolerances: metrics within 1e-4 relative,
    each leaf within 5e-3 of its largest update."""
    (gm, gl), (wm, wl) = got, want
    for a, b in zip(gm, wm):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-4), k
    for path, p0 in tree_lib.flatten(start):
        w = np.asarray(wl[path], np.float32)
        moved = float(np.abs(w - p0.float().numpy()).max())
        err = float(np.abs(gl[path].float().numpy() - w).max())
        assert err <= 5e-3 * moved, f"{path}: {err:.3g} of {moved:.3g}"


#: The configs whose steps are held against JAX's: their weights come from
#: the JAX package (``torch_parity.models_of``); the others' from the
#: port's own init (they are held against the meshless port).
JAX_HELD = ("tinyllama-1.1b", "internvl2-26b")


@pytest.fixture(scope="module")
def family():
    """(jax cfg, jax params, port cfg, port params), batches and the
    meshless port's two steps, per arch (jax entries None off
    ``JAX_HELD``)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            if arch in JAX_HELD:
                models = models_of(arch)
            else:
                tcfg = dataclasses.replace(
                    get_config(arch).reduced(), attn_kernel="off",
                    **({"num_layers": 5} if arch == "zamba2-7b" else {}))
                models = (None, None, tcfg, TM.init_params(
                    tcfg, 0, device="cpu", dtype=torch.float32))
            jb, tb = batches(models[2], B=B)
            cache[arch] = (models, jb, tb, _port_steps(models[2], models[3],
                                                       tb))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b"])
def test_dense_and_vlm_steps_match(arch, family):
    (jcfg, jparams, tcfg, tparams), jb, tb, meshless = family(arch)
    ref = _jax_steps(jcfg, jparams, jb)
    _close(meshless, ref, tparams)
    for shape in MESHES + (POD,):
        got = _port_steps(tcfg, tparams, tb, cpu_mesh(shape))
        _close(got, meshless, tparams)
        _close(got, ref, tparams)


def test_moe_steps_match():
    """At capacity factor 0.5, where the dispatch groups decide which
    tokens drop: (2, 1) equals JAX's step under ``use_axes`` with data =
    2 (two groups; the anchors are no-ops without a mesh) and differs
    from the meshless port's one group; (1, 2) equals the meshless
    port."""
    rj = jax_config("qwen2-moe-a2.7b").reduced()
    rt = get_config("qwen2-moe-a2.7b").reduced()
    jcfg = dataclasses.replace(rj, attn_kernel="off", moe=dataclasses.replace(
        rj.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(rt, attn_kernel="off", moe=dataclasses.replace(
        rt.moe, capacity_factor=0.5))
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jb, tb = batches(tcfg, B=B)
    axes = jsh.AxisState((("data", 2), ("model", 1)))
    with tsh.use_axes(tsh.AxisState(axes.sizes)):
        assert TMOE._num_groups(B, tb["tokens"].shape[1]) == 2
    grouped = _port_steps(tcfg, tparams, tb, cpu_mesh((2, 1)))
    _close(grouped, _jax_steps(jcfg, jparams, jb, axes=axes), tparams)
    meshless = _port_steps(tcfg, tparams, tb)
    assert abs(grouped[0][0]["loss"] - meshless[0][0]["loss"]) > 1e-5
    _close(_port_steps(tcfg, tparams, tb, cpu_mesh((1, 2))), meshless,
           tparams)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_moe_manual_path_matches_auto(shape):
    """The reference's criterion (tests/test_moe_manual.py): at least 99%
    of tokens within 2% of the output's scale, aux within 0.05."""
    jcfg = jax_config("qwen3-moe-235b-a22b").reduced()
    tcfg = get_config("qwen3-moe-235b-a22b").reduced()
    p = JMOE.init_moe(jcfg, jax.random.PRNGKey(0))
    x = (jax.random.normal(jax.random.PRNGKey(1), (4, 32, jcfg.d_model),
                           jnp.float32) * 0.5).astype(jnp.bfloat16)
    with jsh.use_axes(jsh.AxisState()):
        ref, aux_ref = JMOE.apply_moe(jcfg, p, x)
    ref = np.asarray(ref, np.float32)
    mesh = cpu_mesh(shape)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in p.items()}
    placed = tsh.place_train(tcfg, {"blocks": {"moe": {
        k: v[None] for k, v in tp.items()}}}, mesh)["blocks"]["moe"]
    placed = {k: v[0] for k, v in placed.items()}
    placed["router"] = tsh.all_gather(placed["router"], axis="data")
    xs = tsh.place_batch(tcfg, {"x": torch.from_numpy(
        np.array(x.astype(jnp.float32))).bfloat16()}, mesh)["x"]
    assert TMOE.expert_parallel(tcfg, mesh, xs)
    assert placed["w_gate"].rows == (("data",), 0)
    assert placed["w_gate"].dim == 1
    mesh.moved_bytes.clear()
    out, aux = TMOE.apply_moe(tcfg, placed, xs, mesh=mesh)
    assert mesh.moved_bytes == {k: int(round(v)) for k, v in
                                dryrun.moe_layer_collectives(
                                    tcfg, 4, 32, mesh).items()}
    assert set(mesh.moved_bytes) >= {"all_to_all", "psum", "all_gather"}
    got = torch.cat([out.parts[g[0]] for g in tsh.groups(mesh, "model")])
    tok_err = np.abs(got.float().numpy() - ref).max(axis=-1) / (
        np.abs(ref).max() + 1e-9)
    assert (tok_err < 0.02).mean() >= 0.99
    for a in aux.parts:
        assert abs(float(a) - float(aux_ref)) < 0.05


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b",
                                  "whisper-base"])
def test_recurrent_and_audio_steps_match_meshless(arch, family):
    """(2, 1) and (1, 2); the other meshes and the JAX step are
    ``tests/test_torch_recurrent_train_sharding.py``'s."""
    (_, _, tcfg, tparams), _, tb, meshless = family(arch)
    for shape in ((2, 1), (1, 2)):
        _close(_port_steps(tcfg, tparams, tb, cpu_mesh(shape)), meshless,
               tparams)


def _distinct(tree):
    """Every replicated part its own object (a clone a place), as on
    distinct devices."""
    return tree_lib.map_leaves(
        lambda s: s.with_parts([p.clone() for p in s.parts]), tree)


def test_replicated_parts_forced_distinct(family, monkeypatch):
    """Parts that are distinct objects still give the meshless step (the
    replicated leaves' gradients are summed explicitly); without that sum
    the step is wrong."""
    (_, _, tcfg, tparams), _, tb, meshless = family("tinyllama-1.1b")
    mesh = cpu_mesh((2, 2))
    _close(_port_steps(tcfg, tparams, tb, mesh, prepare=_distinct),
           meshless, tparams)
    monkeypatch.setattr(tsh, "sum_replicas", lambda s: s)
    with pytest.raises(AssertionError):
        _close(_port_steps(tcfg, tparams, tb, cpu_mesh((2, 2)),
                           prepare=_distinct, count=False), meshless,
               tparams)


#: The meshes the step tests above do not run, by arch (each step there
#: already holds its bytes to the count).
BYTE_MESHES = {
    "tinyllama-1.1b": ((2, 4),), "internvl2-26b": ((2, 4),),
    "qwen2-moe-a2.7b": ((2, 2), (4, 2), (2, 4), POD),
    "qwen3-moe-235b-a22b": MESHES + ((2, 4), POD),
    "mamba2-1.3b": ((4, 1), (2, 2, 1)), "zamba2-7b": ((4, 1), (2, 2, 1)),
    "whisper-base": ((4, 1), (2, 2, 1))}


@pytest.mark.parametrize("arch", list(BYTE_MESHES))
def test_bytes_equal_the_dry_run_count(arch, family):
    """One step at each remaining mesh: the bytes counted forward and
    backward equal ``dryrun.train_collectives`` exactly."""
    (_, _, tcfg, tparams), _, tb, _ = family(arch)
    for shape in BYTE_MESHES[arch]:
        mesh = cpu_mesh(shape)
        _port_steps(tcfg, tparams, tb, mesh, n=1)
        if shape[-1] > 1:
            assert mesh.moved_bytes["psum/bwd"] > 0
        if shape[-2] > 1:
            assert mesh.moved_bytes["all_gather/bwd"] > 0


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

def test_restore_onto_a_different_mesh(tmp_path):
    """Twin of tests/test_elastic_restore.py: saved from a (4, 2)
    placement, restored onto (2, 4) within 1e-6, placed with model 4."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    mesh_a = cpu_mesh((4, 2))
    ckpt.save(str(tmp_path), 1, {"params": tsh.place_train(cfg, params,
                                                           mesh_a)})
    mesh_b = cpu_mesh((2, 4))
    like = tsh.place_train(cfg, tree_lib.map_leaves(torch.zeros_like,
                                                    params), mesh_b)
    got = ckpt.restore(str(tmp_path), 1, {"params": like})["params"]
    for (path, a), b in zip(tree_lib.flatten(params), tree_lib.leaves(got)):
        assert b.mesh is mesh_b and b.mesh.shape["model"] == 4
        np.testing.assert_allclose(tsh.to_whole(b).float().numpy(),
                                   a.float().numpy(), atol=1e-6)
    wq = got["blocks"]["attn"]["wq"]
    assert wq.dim == 2 and wq.rows == (("data",), 1)
    assert wq.parts[0].shape == (cfg.num_layers, cfg.d_model // 2,
                                 cfg.num_heads * cfg.head_dim // 4)


def test_jax_checkpoint_restores_onto_a_port_mesh(tmp_path):
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path), 2, {"params": jparams})
    mesh = cpu_mesh((2, 2))
    like = tsh.place_train(tcfg, TM.init_params(tcfg, 1, device="cpu"), mesh)
    got = ckpt.restore(str(tmp_path), 2, {"params": like})["params"]
    want = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    for (path, a), b in zip(tree_lib.flatten(got), tree_lib.leaves(want)):
        assert a.mesh is mesh
        assert torch.equal(tsh.to_whole(a), b), path


@pytest.mark.parametrize("shape", [(4, 2)])
def test_moe_rows_none_reads_the_global_batch(shape):
    """``apply_moe(mesh=, rows=None)`` on an ``smap``-made x (each data
    place's part one place's rows) made with ``rows=True`` reads the
    global batch from the result's cut: the collectives' bytes equal the
    dry run's count for the whole batch, and the output equals the call
    on the placed batch.  The same ``smap`` without ``rows=True`` makes
    the call raise."""
    tcfg = get_config("qwen3-moe-235b-a22b").reduced()
    jcfg = jax_config("qwen3-moe-235b-a22b").reduced()
    p = JMOE.init_moe(jcfg, jax.random.PRNGKey(0))
    mesh = cpu_mesh(shape)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in p.items()}
    placed = tsh.place_train(tcfg, {"blocks": {"moe": {
        k: v[None] for k, v in tp.items()}}}, mesh)["blocks"]["moe"]
    placed = {k: v[0] for k, v in placed.items()}
    placed["router"] = tsh.all_gather(placed["router"], axis="data")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, tcfg.d_model)).astype(np.float32) * 0.5).bfloat16()
    xs = tsh.place_batch(tcfg, {"x": x}, mesh)["x"]
    assert xs.rows is not None and xs.parts[0].shape[0] == 1
    made = tsh.smap(lambda t: t * 1.0, xs, mesh=mesh, rows=True)
    assert made.rows == xs.rows and made.parts[0].shape[0] == 1 \
        and made.shape == xs.shape
    want = {k: int(round(v)) for k, v in
            dryrun.moe_layer_collectives(tcfg, 4, 32, mesh).items()}
    mesh.moved_bytes.clear()
    ref, _ = TMOE.apply_moe(tcfg, placed, xs, mesh=mesh)
    assert mesh.moved_bytes == want
    mesh.moved_bytes.clear()
    out, _ = TMOE.apply_moe(tcfg, placed, made, mesh=mesh)
    assert mesh.moved_bytes == want and mesh.moved_bytes["all_to_all"] > 0
    for a, b in zip(out.parts, ref.parts):
        assert torch.equal(a, b)
    blind = tsh.smap(lambda t: t * 1.0, xs, mesh=mesh)
    assert blind.rows is None and blind.shape[0] == 1
    with pytest.raises(ValueError, match="global batch"):
        TMOE.apply_moe(tcfg, placed, blind, mesh=mesh)
