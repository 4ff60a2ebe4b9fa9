"""The port's GPipe schedule (``parallel.pipeline``) against the
sequential stack, on a ``stage`` mesh that names the CPU several times.

Twin of ``tests/test_pipeline.py``, without its forced-device
subprocess: the weights and inputs are JAX's (``jax.random``, carried
across through numpy) and the reference's criterion holds — the
pipelined output within 1e-5 of applying the stages in turn.  Also: the
activations' ``ppermute`` bytes are ticks x stages x one microbatch's
bytes, and a reduced tinyllama's blocks as two stages of one layer each
equal the model's own layer loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel.pipeline import (pipeline_apply,  # noqa: E402
                                           split_microbatches)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors (the suite runs
    several workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def stage_fn(wi, h):
    return torch.tanh(h @ wi)


@pytest.mark.parametrize("n_stages,n_mb", [(4, 8), (2, 3)])
def test_pipeline_matches_sequential(n_stages, n_mb):
    mb, d = 2, 16
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    w = torch.from_numpy(np.array(
        jax.random.normal(ks[0], (n_stages, d, d)) * 0.3))
    x = torch.from_numpy(np.array(jax.random.normal(ks[1], (n_mb * mb, d))))
    mesh = make_mesh((n_stages,), ("stage",), "cpu")
    out = pipeline_apply(stage_fn, w, split_microbatches(x, n_mb), mesh)
    out = out.reshape(n_mb * mb, d)
    ref = x
    for i in range(n_stages):
        ref = stage_fn(w[i], ref)
    assert float((out - ref).abs().max()) < 1e-5
    ticks = n_mb + n_stages - 1
    act = mb * d * 4
    assert mesh.moved_bytes["ppermute"] == ticks * n_stages * act
    assert mesh.moved_bytes["psum"] == 2 * (n_stages - 1) * n_mb * act


def test_split_microbatches():
    x = torch.arange(24).reshape(6, 4)
    assert split_microbatches(x, 3).shape == (3, 2, 4)
    assert torch.equal(split_microbatches(x, 3).reshape(6, 4), x)
    with pytest.raises(AssertionError):
        split_microbatches(x, 4)


def test_model_blocks_as_stages():
    """A reduced tinyllama's two layers as two pipeline stages (each a
    one-layer stack), four microbatches, equal to the layer loop."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = TM.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    h = torch.randn(8, 16, cfg.d_model, generator=g)
    pos = torch.arange(16)

    def run(blocks, x):
        return TM.backbone(cfg, {"blocks": blocks}, x, pos)[0]

    staged = TM._tree_map(lambda v: v[:, None], params["blocks"])
    mesh = make_mesh((2,), ("stage",), "cpu")
    with torch.no_grad():
        out = pipeline_apply(run, staged, split_microbatches(h, 4), mesh)
        ref = run(params["blocks"], h)
    assert float((out.reshape(h.shape) - ref).abs().max()) < 1e-5
