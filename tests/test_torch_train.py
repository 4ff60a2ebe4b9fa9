"""The port's training substrate against the JAX package: the data
stream, AdamW, checkpoints (across packages in both directions), the
train step, restart, the elastic policies, the launcher and the
examples' shared pieces, plus ``core.workloads.from_model_config``.

Tolerances: the token stream and host shards bitwise; AdamW updates on
the same gradients within one bf16 ulp for bf16 leaves and 1e-6
relative for fp32 ones (fp32 arithmetic in the same order, scalars
rounded alike); the schedule to 1e-7 relative.  Two train steps of the
reduced families (fp32 params through ``torch_parity.pair``) against
JAX's ``make_train_step``: loss and grad norm within 1e-4 relative, each
parameter leaf within 5e-3 of its largest update (measured at most
1.2e-3, zamba2-7b); the ssm, hybrid and audio families' placed step
(``make_train_step(mesh=)``) at (data, model) = (1, 2), (2, 2) and (2, 4)
on meshes that name the CPU several times, against the same JAX steps
by the same limits.  Those steps use ``eps=1e-3``: at AdamW's first step
an element moves by sign(g) * lr, so an element whose gradient is at
fp32 summation-noise level can flip sign between frameworks and move 2
lr apart at the default eps (measured 7.5e-2 of the update, zamba2-7b);
with a larger eps the step is continuous in g.  Checkpoint round trips
are exact (bf16 via fp32).
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, steps as TS  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import data as data_lib  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.elastic import (ElasticPlan,  # noqa: E402
                                          StragglerMonitor)
from repro_torch.training.train_loop import TrainConfig, train  # noqa: E402

from torch_parity import FAMILY_ARCHS, batches, models_of  # noqa: E402


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,index", [(0, 0), (7, 3), (123, 41),
                                        (10_000, 100)])
def test_token_stream_is_jax_bitwise(seed, index):
    kw = dict(vocab_size=977, seq_len=16, global_batch=4, seed=seed)
    got = data_lib.TokenStream(data_lib.DataConfig(**kw)).batch(index)
    want = jdata.TokenStream(jdata.DataConfig(**kw)).batch(index)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])
    full = np.concatenate([got["tokens"], got["labels"][:, -1:]], 1)
    assert np.array_equal(full[:, 1:], got["labels"])


def test_host_shards_partition_the_batch_as_jax():
    cfg = data_lib.DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    b = data_lib.TokenStream(cfg).batch(0)
    parts = [data_lib.shard_for_host(b, i, 4) for i in range(4)]
    assert np.array_equal(np.concatenate([p["tokens"] for p in parts]),
                          b["tokens"])
    for i, p in enumerate(parts):
        want = jdata.shard_for_host(b, i, 4)
        assert all(np.array_equal(p[k], want[k]) for k in b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _mixed_tree(rng, scale=1.0):
    """bf16 and fp32 leaves of ndim 1, 2 and 3, one nested."""
    def leaf(shape, dt):
        return (scale * rng.standard_normal(shape)).astype(np.float32), dt
    return {"norm": leaf((8,), "bf16"), "bias": leaf((5,), "f32"),
            "w": leaf((6, 4), "bf16"),
            "blocks": {"stack": leaf((3, 4, 5), "f32"),
                       "scale": leaf((3, 8), "bf16")}}


def _to_jax(t):
    return {k: _to_jax(v) if isinstance(v, dict) else
            jnp.asarray(v[0]).astype(jnp.bfloat16 if v[1] == "bf16"
                                     else jnp.float32)
            for k, v in t.items()}


def _to_torch(t):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.from_numpy(v[0]).to(torch.bfloat16 if v[1] == "bf16"
                                      else torch.float32)
            for k, v in t.items()}


def test_adamw_three_updates_match_jax():
    """Three updates on the same gradients (the first clipped) give the
    same parameters (bf16 within one ulp), moments and metrics; the
    stacked (3, 8) scales, ndim 2 as stored, take weight decay as in the
    reference."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    spec = _mixed_tree(rng)
    jp, tp = _to_jax(spec), _to_torch(spec)
    js, ts = JO.init(jp), TO.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    for i in range(3):
        g = _mixed_tree(rng, scale=3.0 if i == 0 else 0.1)
        jp, js, jm = JO.update(JO.AdamWConfig(**cfg), _to_jax(g), js, jp)
        tp, ts, tm = TO.update(TO.AdamWConfig(**cfg), _to_torch(g), ts, tp)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for (path, a), b in zip(tree.flatten(tp), jax.tree.leaves(jp)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32), path
        want = np.asarray(b, np.float32)
        got = a.float().numpy()
        if a.dtype == torch.bfloat16:
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
            assert (np.abs(got - want) <= ulp).all(), path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
    for mom in ("m", "v"):
        for a, b in zip(tree.leaves(getattr(ts, mom)),
                        jax.tree.leaves(getattr(js, mom))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-9)


def test_adamw_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = TO._schedule(TO.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
        want = JO._schedule(JO.AdamWConfig(**cfg), jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-7), step


def test_adamw_clipping_and_convergence():
    """Twins of tests/test_training.py: the grad norm is reported before
    clipping, and AdamW drives a quadratic to 0."""
    params = {"w": torch.zeros(3)}
    _, _, metrics = TO.update(TO.AdamWConfig(clip_norm=1.0),
                              {"w": torch.full((3,), 1e6)},
                              TO.init(params), params)
    assert float(metrics["grad_norm"]) > 1e5
    params = {"w": torch.tensor([5.0, -3.0])}
    state = TO.init(params)
    cfg = TO.AdamWConfig(lr=0.3, warmup_steps=1, total_steps=200,
                         weight_decay=0.0)
    for _ in range(150):
        params, state, _ = TO.update(cfg, {"w": 2 * params["w"]}, state,
                                     params)
    assert float(params["w"].abs().max()) < 0.1


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": {"c": torch.randn(4).bfloat16()},
         "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 5, t)
    like = tree.map_leaves(torch.zeros_like, t)
    out = ckpt.restore(str(tmp_path), 5, like)
    for (path, a), b in zip(tree.flatten(out), tree.leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_retention_latest_and_async(tmp_path):
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t, keep=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    saver = ckpt.AsyncCheckpointer()
    x = torch.ones(3)
    saver.save(str(tmp_path), 5, {"x": x})
    x.add_(1)  # the snapshot was taken before the thread started
    saver.wait()
    assert torch.equal(ckpt.restore(str(tmp_path), 5, {"x": x})["x"],
                       torch.ones(3))


@pytest.fixture(scope="module")
def tiny_pair():
    """Reduced tinyllama in both packages with the same bf16 weights."""
    jparams = JM.init_params(jax_config("tinyllama-1.1b").reduced(),
                             jax.random.PRNGKey(0))
    tparams = params_from_numpy(get_config("tinyllama-1.1b").reduced(),
                                jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jparams, tparams


def test_checkpoints_read_across_packages(tmp_path, tiny_pair):
    """A {"params", "opt"} state saved by JAX restores into the port, and
    the port's restores into JAX's ``restore``, leaf for leaf."""
    jparams, tparams = tiny_pair
    jstate = {"params": jparams, "opt": JO.init(jparams)}
    jckpt.save(str(tmp_path / "jax"), 3, jstate)
    like = {"params": tree.map_leaves(torch.zeros_like, tparams),
            "opt": TO.init(tparams)}
    got = ckpt.restore(str(tmp_path / "jax"), 3, like)
    for (path, a), b in zip(tree.flatten(got), jax.tree.leaves(jstate)):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32)), \
            path
    assert got["opt"].step.dtype == torch.int32

    bumped = tree.map_leaves(lambda p: p + 1, tparams)
    ckpt.save(str(tmp_path / "port"), 4, {"params": bumped})
    back = jckpt.restore(str(tmp_path / "port"), 4, {"params": jparams})
    for (path, a), b in zip(tree.flatten(bumped),
                            jax.tree.leaves(back["params"])):
        assert b.dtype == jnp.bfloat16
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32)), \
            path


# ---------------------------------------------------------------------------
# Train steps, restart, launcher
# ---------------------------------------------------------------------------

#: The placed step's (data, model) meshes held to JAX's steps for the
#: recurrent families (``tests/test_torch_recurrent_train_sharding.py``
#: holds the rest of it against the meshless port).
RECURRENT_MESHES = ((1, 2), (2, 2), (2, 4))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_two_train_steps_match_jax(arch):
    jcfg, jparams, tcfg, tparams = models_of(arch)
    jb, tb = batches(tcfg)
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    jstep = JS.make_train_step(jcfg, JO.AdamWConfig(**oc))
    jp, jo, jms = jparams, JO.init(jparams), []
    for _ in range(2):
        jp, jo, jm = jstep(jp, jo, jb)
        jms.append(jm)
    meshes = [None]
    if tcfg.family in ("ssm", "hybrid", "audio"):
        meshes += [mesh_lib.make_mesh(s, ("data", "model"), "cpu")
                   for s in RECURRENT_MESHES]
    threads = torch.get_num_threads()
    try:
        for mesh in meshes:
            # The placed steps' many small per-shard ops on one intra-op
            # thread: the suite's workers share a few cores, where
            # spinning thread pools slow each other severalfold.
            torch.set_num_threads(threads if mesh is None else 1)
            _steps_match(tcfg, tparams, tb, oc, mesh, jms, jp)
    finally:
        torch.set_num_threads(threads)


def _steps_match(tcfg, tparams, tb, oc, mesh, jms, jp):
    """The port's two steps (over ``mesh`` when given) against JAX's
    metrics ``jms`` and final parameters ``jp``."""
    tstep = TS.make_train_step(tcfg, TO.AdamWConfig(**oc), mesh=mesh)
    tp, batch = tparams, tb
    if mesh is not None:
        tp = sharding.place_train(tcfg, tparams, mesh)
        batch = sharding.place_batch(tcfg, tb, mesh)
    to = TO.init(tp)
    for jm in jms:
        tp, to, tm = tstep(tp, to, batch)
        assert set(tm) == {"loss", "grad_norm", "lr"}
        for k in tm:
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=1e-4), (mesh, k)
    assert int(to.step) == 2
    for (path, a), b, p0 in zip(tree.flatten(tp), jax.tree.leaves(jp),
                                tree.leaves(tparams)):
        b = np.asarray(b)
        moved = float(np.abs(b - p0.numpy()).max())
        assert moved > 0, path
        err = float(np.abs(sharding.to_whole(a).numpy() - b).max())
        assert err <= 5e-3 * moved, \
            f"{mesh} {path}: {err:.3g} of {moved:.3g}"


def test_loss_decreases_tinyllama():
    """Twin of tests/test_system.py: 12 steps on one batch, lr 1e-2."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    opt_state = TO.init(params)
    step = TS.make_train_step(cfg, TO.AdamWConfig(lr=1e-2, warmup_steps=1,
                                                  total_steps=30))
    _, batch = batches(cfg, S=32, B=4)
    losses = []
    for _ in range(12):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    assert losses[-1] < losses[0] - 0.5, losses


def _final(state):
    return tree.leaves(state.params)


def test_train_restart_resumes(tmp_path):
    """Kill-and-restart: the same parameters as an uninterrupted run
    (twin of tests/test_training.py)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    kw = dict(seq_len=16, global_batch=2, ckpt_every=3, log_every=0)
    final = train(cfg, TrainConfig(steps=6, ckpt_dir=str(tmp_path / "a"),
                                   **kw), device="cpu")
    train(cfg, TrainConfig(steps=3, ckpt_dir=str(tmp_path / "b"), **kw),
          device="cpu")
    resumed = train(cfg, TrainConfig(steps=6, ckpt_dir=str(tmp_path / "b"),
                                     **kw), device="cpu")
    assert resumed.step == 6 and int(resumed.opt_state.step) == 6
    for a, b in zip(_final(final), _final(resumed)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-base"])
def test_train_loop_feeds_the_stub_inputs(arch):
    """vlm and audio train on zero bf16 patch embeddings / frames."""
    cfg = get_config(arch).reduced()
    seen = []
    train(cfg, TrainConfig(steps=1, seq_len=8, global_batch=2, log_every=0),
          hooks=[lambda i, m: seen.append(m)], device="cpu")
    assert len(seen) == 1 and np.isfinite(seen[0]["loss"])
    assert seen[0]["grad_norm"] > 0


def test_launcher_trains_reduced_on_cpu(tmp_path, capsys):
    state = train_cli.main(["--arch", "tinyllama-1.1b", "--reduced",
                            "--device", "cpu", "--steps", "3", "--batch",
                            "2", "--seq", "16", "--ckpt",
                            str(tmp_path), "--ckpt-every", "3"])
    assert state.step == 3 and int(state.opt_state.step) == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = capsys.readouterr().out
    assert "finished at step 3" in out and "devices=" in out


# ---------------------------------------------------------------------------
# Elastic policies, workloads
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=2.0)
    for _ in range(10):
        mon.step_start()
        time.sleep(0.001)
        mon.step_end()
    mon.step_start()
    time.sleep(0.05)
    assert mon.step_end() is not None


def test_elastic_plan_shapes():
    plan = ElasticPlan(pods_total=2)
    assert plan.mesh_shape(2)[0] == (2, 16, 16)
    assert plan.mesh_shape(1)[0] == (16, 16)
    assert plan.global_batch_scale(1) == 0.5


@pytest.mark.parametrize("arch", list_archs())
def test_workload_from_model_config_matches_jax(arch):
    got = dataclasses.asdict(TW.from_model_config(get_config(arch)))
    want = dataclasses.asdict(JW.from_model_config(jax_config(arch)))
    assert got == want
    assert TM.param_count_active(get_config(arch)) <= TM.param_count(
        get_config(arch))
