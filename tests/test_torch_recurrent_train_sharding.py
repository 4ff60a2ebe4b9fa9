"""Training the recurrent families over a (data, model) mesh: reduced
fp32 mamba2-1.3b (ssm), zamba2-7b (hybrid, 5 layers: two groups of two
and a tail of one) and whisper-base (audio) through
``make_train_step(mesh=)`` on meshes that name the CPU several times.

  * two AdamW steps at (data, model) = (1, 2), (2, 2) and (2, 4) against
    the meshless port, with ``tests/test_torch_train.py``'s limits (loss
    and grad norm within 1e-4 relative, each leaf within 5e-3 of its
    largest update), the bytes each first step counts, by kind, equal to
    ``dryrun.train_collectives`` exactly.  The same placed steps are
    held against JAX's ``make_train_step`` in ``tests/test_torch_train.py``
    (``test_two_train_steps_match_jax``), which compiles JAX's step for
    each family already;
  * whisper-base with an odd vocab (255), whose embedding and head are
    cut on d_model over ``data`` and whole over ``model``, at (1, 2) and
    (2, 2);
  * controls that must fail the limits: the gated RMSNorm's mean taken
    per shard (its ``psum`` skipped) with one shard's heads scaled x 8,
    and the B / C gradient partials left unsummed over ``model``;
  * the placement: a (2, 2) checkpoint of the component-cut leaves
    restores onto (1, 4) and (4, 1); the refusals this slice cleared
    no longer raise, and those that stay do;
  * the dry run at the production meshes: the Mamba-2 leaves cut by
    component (64 / 16 and 112 / 16 heads), whisper-base's 8 heads
    gathered whole; ``device_bytes`` equal to the placed ``meta`` pieces
    (B and C whole on every shard); ``run_cell`` records with collective
    bytes for ``train_4k`` at ``single`` and ``multi``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402

from test_torch_train_sharding import (_close, _port_steps,  # noqa: E402
                                       cpu_mesh)
from torch_parity import batches, masked_d_cut_moe  # noqa: E402

ARCHS = ("mamba2-1.3b", "zamba2-7b", "whisper-base")
MESHES = ((1, 2), (2, 2), (2, 4))
B = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors (the suite runs
    several workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(arch, **changes):
    """The reduced fp32 config (zamba2-7b at 5 layers), attention and
    scan on their plain routes."""
    if arch == "zamba2-7b":
        changes.setdefault("num_layers", 5)
    return dataclasses.replace(get_config(arch).reduced(), attn_kernel="off",
                               **changes)


@pytest.fixture(scope="module")
def family():
    """(cfg, fp32 params, batch, the meshless port's two steps) by arch,
    and the odd-vocab whisper-base under "whisper-base/255"."""
    cache = {}

    def get(arch):
        if arch not in cache:
            name, _, vocab = arch.partition("/")
            cfg = reduced(name, **({"vocab_size": int(vocab)} if vocab
                                   else {}))
            params = TM.init_params(cfg, 0, device="cpu",
                                    dtype=torch.float32)
            tb = batches(cfg, B=B)[1]
            cache[arch] = (cfg, params, tb, _port_steps(cfg, params, tb))
        return cache[arch]
    return get


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_steps_match_meshless(arch, shape, family):
    cfg, params, tb, meshless = family(arch)
    mesh = cpu_mesh(shape)
    _close(_port_steps(cfg, params, tb, mesh), meshless, params)
    assert mesh.moved_bytes["psum/bwd"] > 0
    if shape[0] > 1:
        assert mesh.moved_bytes["all_gather/bwd"] > 0
    if cfg.ssm is not None:
        in_proj = tsh.place_train(cfg, params, mesh)
        in_proj = (in_proj["blocks"] if "blocks" in in_proj
                   else in_proj["groups"])["mamba"]["in_proj"]
        assert in_proj.comps == tsh.mamba_components(cfg, "in_proj")
        assert in_proj.rows == ((("data",), in_proj.parts[0].dim() - 2)
                                if shape[0] > 1 else None)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_odd_vocab_embedding_cut_on_d_model(shape, family):
    """A vocab that does not divide ``model`` (whisper-base's 51865 at
    full width; 255 here): the table and the head are cut on d_model
    over ``data`` only, gathered whole before use."""
    cfg, params, tb, meshless = family("whisper-base/255")
    mesh = cpu_mesh(shape)
    placed = tsh.place_train(cfg, params, mesh)
    assert cfg.vocab_size % shape[1]

    def rows(dim):
        return (("data",), dim) if shape[0] > 1 else None
    assert (placed["embed"].dim, placed["embed"].rows) == (None, rows(1))
    assert (placed["lm_head"].dim, placed["lm_head"].rows) == \
        (None, rows(0))
    _close(_port_steps(cfg, params, tb, mesh), meshless, params)


def _scaled_heads(cfg, params):
    """mamba2's in_proj with shard 1 of 2's z and x columns x 8."""
    d_inner = TSSM.dims(cfg)[0]
    scale = torch.ones(params["blocks"]["mamba"]["in_proj"].shape[-1])
    for lo in (d_inner // 2, d_inner + d_inner // 2):
        scale[lo:lo + d_inner // 2] = 8.0
    blocks = dict(params["blocks"], mamba=dict(
        params["blocks"]["mamba"],
        in_proj=params["blocks"]["mamba"]["in_proj"] * scale))
    return dict(params, blocks=blocks)


def test_per_shard_mean_in_the_gated_norm_fails(monkeypatch):
    """The gated norm's mean runs over all d_inner columns: with shard
    1's heads scaled up, the sound step meets the limits and a per-shard
    mean (each shard's sum of squares over its own columns, times m)
    does not."""
    cfg = reduced("mamba2-1.3b")
    params = _scaled_heads(cfg, TM.init_params(cfg, 0, device="cpu",
                                               dtype=torch.float32))
    tb = batches(cfg, B=B)[1]
    meshless = _port_steps(cfg, params, tb)
    _close(_port_steps(cfg, params, tb, cpu_mesh((1, 2))), meshless, params)
    monkeypatch.setattr(TSSM, "_sum_squares", lambda g, mesh_: tsh.smap(
        lambda t: t.square().sum(-1, keepdim=True) * 2, g, mesh=mesh_))
    with pytest.raises(AssertionError):
        _close(_port_steps(cfg, params, tb, cpu_mesh((1, 2)), count=False),
               meshless, params)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_unsummed_bc_gradients_fail(arch, family, monkeypatch):
    """B and C are whole on every model shard, each shard's heads giving
    them a partial gradient: left unsummed over ``model`` the step
    fails the limits."""
    cfg, params, tb, meshless = family(arch)
    monkeypatch.setattr(tsh, "sum_components", lambda s: s)
    with pytest.raises(AssertionError):
        _close(_port_steps(cfg, params, tb, cpu_mesh((2, 2)), count=False),
               meshless, params)


def test_component_cut_restores_onto_other_meshes(tmp_path, family):
    """A (2, 2) checkpoint restores onto (1, 4) and (4, 1) bit for bit,
    each leaf placed as the new mesh places it."""
    cfg, params, _, _ = family("mamba2-1.3b")
    placed = tsh.place_train(cfg, params, cpu_mesh((2, 2)))
    assert placed["blocks"]["mamba"]["conv_w"].comps is not None
    ckpt.save(str(tmp_path), 1, {"params": placed})
    for shape in ((1, 4), (4, 1)):
        mesh = cpu_mesh(shape)
        like = tsh.place_train(cfg, tree_lib.map_leaves(torch.zeros_like,
                                                        params), mesh)
        got = ckpt.restore(str(tmp_path), 1, {"params": like})["params"]
        for (path, a), b in zip(tree_lib.flatten(params),
                                tree_lib.leaves(got)):
            assert b.mesh is mesh
            assert torch.equal(tsh.to_whole(b), a), (shape, path)
        in_proj = got["blocks"]["mamba"]["in_proj"]
        if shape[1] > 1:
            assert in_proj.comps is not None and in_proj.rows is None
            assert in_proj.parts[0].shape[-1] == sum(tsh._local_lengths(
                in_proj.comps, 4))
        else:
            assert in_proj.comps is None
            assert in_proj.rows == (("data",), 1)


def test_cleared_refusals_and_the_ones_that_stay():
    cfg = reduced("mamba2-1.3b")
    mesh = cpu_mesh((2, 2))
    params = tsh.place_train(cfg, TM.init_params(cfg, 0, device="cpu",
                                                 dtype=torch.float32), mesh)
    # A component cut beside a data cut places, gathers over data (the
    # components stay cut) and reads back whole.
    in_proj = params["blocks"]["mamba"]["in_proj"]
    gathered = tsh.all_gather(in_proj, axis="data")
    assert gathered.comps == in_proj.comps and gathered.rows is None
    assert gathered.shape == in_proj.shape
    assert torch.equal(tsh.to_whole(gathered), tsh.to_whole(in_proj))
    with pytest.raises(NotImplementedError):
        tsh.all_gather(in_proj)  # over model: read it with gather
    for arch in ARCHS:
        c = reduced(arch)
        assert dryrun.train_collectives(c, B, 64, mesh)["psum"] > 0
    # Cleared: a batch that does not divide the data axes is placed whole
    # on every data place.
    tb = batches(cfg, B=3)[1]
    placed = tsh.place_batch(cfg, tb, mesh)
    for k, x in placed.items():
        assert x.rows is None and all(torch.equal(p, tb[k]) for p in x.parts)
    # The refusal that stays.
    with pytest.raises(NotImplementedError):
        TM.check_paged(cfg, "prefill_slots")
    moe_cfg = get_config("qwen2-moe-a2.7b").reduced()
    moe_params = TM.init_params(moe_cfg, 0, device="cpu")
    # Cleared: the moe family served over data axes above 1.
    eng = ServingEngine(moe_cfg, moe_params, mesh=mesh, device="cpu",
                        mode="wave")
    assert eng.params["blocks"]["moe"]["w_down"].rows == (("data",), 1)
    # Cleared: experts cut on d_model off the manual path (a mask), held
    # against JAX's masked layer under the mesh's axes.
    (out, aux), *refs = masked_d_cut_moe(
        "qwen2-moe-a2.7b", moe_params["blocks"]["moe"], cpu_mesh((1, 2)))
    for ref, aux_ref in refs:  # JAX's layer, then the meshless port's
        for p, a in zip(out.parts, aux.parts):
            assert np.abs(p.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
            assert float(a) == pytest.approx(float(aux_ref), rel=1e-6)


@pytest.mark.parametrize("multi", [False, True])
def test_device_bytes_count_the_placed_pieces(multi):
    """At the production meshes: mamba2-1.3b's and zamba2-7b's Mamba-2
    leaves cut by component (64 / 16 and 112 / 16 heads), B and C whole
    on every shard; whisper-base's 8 heads gathered whole.  Per device,
    ``device_bytes`` equals place 0's parts of the ``meta`` tensors placed
    as the port places them (train_4k; decode_32k's caches too)."""
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    for arch, shape in (("mamba2-1.3b", "train_4k"),
                        ("zamba2-7b", "train_4k"),
                        ("whisper-base", "train_4k"),
                        ("mamba2-1.3b", "decode_32k")):
        cfg = get_config(arch)
        args, specs, _, _ = dryrun.port_specs(cfg, shape, mesh)
        held = 0
        for (path, leaf), (_, spec) in zip(
                tree_lib.flatten(dict(enumerate(args))),
                tree_lib.flatten(dict(enumerate(specs)))):
            part = tsh.shard(leaf, spec, mesh).parts[0]
            held += part.numel() * part.element_size()
            if path.endswith("mamba/in_proj"):
                s = cfg.ssm
                H = s.nheads(cfg.d_model)
                assert part.shape[-1] == (2 * s.d_inner(cfg.d_model) + H) \
                    // 16 + 2 * s.ngroups * s.state_size, path
        assert dryrun.device_bytes(cfg, shape, mesh)[
            "argument_size_in_bytes"] == held, arch
    whisper = get_config("whisper-base")
    assert tsh.attn_shard_size(mesh, whisper.num_kv_heads) == 1
    assert tsh.mamba_shard_size(mesh, get_config("zamba2-7b")) == 16


def test_run_cell_counts_every_family(tmp_path):
    """train_4k at single and multi (reduced widths, the production
    meshes): collective bytes by kind, and the step fits one card."""
    for arch in ARCHS:
        for mesh_name in ("single", "multi"):
            rec = dryrun.run_cell(arch, "train_4k", mesh_name, tmp_path,
                                  reduced=True)
            assert rec["status"] == "ok", rec.get("error")
            assert rec["wire_bytes_global"] > 0 and rec["fits_one_card"]
            kinds = set(rec["collectives"])
            assert {"all_gather", "all_gather/bwd", "psum", "psum/bwd",
                    "grad_sum"} <= kinds, (arch, kinds)
            assert rec["wire_bytes_global"] == pytest.approx(math.fsum(
                c["wire_bytes_global"] for c in rec["collectives"].values()))
            assert rec["flops_hlo_global"] > 0
