"""The port's dense model against ``repro.models.model`` at
``attn_kernel="off"`` on a reduced tinyllama, with the JAX package's
``init_params`` carried across through numpy (``params_from_numpy``).

Logits and pools are compared after a first ``prefill_slots`` chunk, a
continuation chunk with ``all_logits``, and a ``decode_step``.
Tolerances: fp32 params 1e-4 on logits of magnitude ~4 (the same
arithmetic summed in another order) with pools bitwise; bf16 params 5e-2
(about two bf16 ulps at that magnitude: the frameworks round bf16 matmul
and activation results at different places) on logits and pools.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def configs():
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               attn_kernel="off")
    return jcfg, tcfg, JM.init_params(jcfg, jax.random.PRNGKey(0))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(configs, dtype):
    jcfg, tcfg, jparams = configs
    if dtype == "float32":
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tol = TOL[dtype]

    def check(a, b, mask=None):
        a, b = _np(a), _np(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)

    def check_pools(jc, tc):
        for leaf in ("k", "v"):
            if dtype == "float32":
                assert np.array_equal(_bits(jc[leaf]), _bits(tc[leaf]))
            else:
                check(jc[leaf], tc[leaf])

    rng = np.random.default_rng(1)
    B, bs, T = 3, 4, 8
    N = 1 + B * T
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, T)
    jc = JM.init_paged_cache(jcfg, N, bs)
    tc = TM.init_paged_cache(tcfg, N, bs, device="cpu")

    # First chunk: rows left-padded to P = 8.
    P, lens = 8, np.array([8, 5, 3], np.int32)
    toks = rng.integers(1, jcfg.vocab_size, (B, P)).astype(np.int32)
    toks[np.arange(P)[None] < (P - lens)[:, None]] = 0
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(tbl))
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(tbl))
    assert tl.shape == (B, jcfg.vocab_size) and tl.dtype == tparams[
        "embed"].dtype
    check(jl, tl)
    check_pools(jc, tc)

    # Continuation with every position's logits (real rows only).
    start, P2, l2 = lens.copy(), 4, np.array([4, 2, 1], np.int32)
    t2 = rng.integers(1, jcfg.vocab_size, (B, P2)).astype(np.int32)
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(t2),
                              jnp.asarray(l2), jnp.asarray(tbl),
                              start=jnp.asarray(start), all_logits=True)
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(t2),
                              torch.from_numpy(l2), torch.from_numpy(tbl),
                              start=torch.from_numpy(start),
                              all_logits=True)
    assert tl.shape == (B, P2, jcfg.vocab_size)
    check(jl, tl, np.arange(P2)[None] >= (P2 - l2)[:, None])
    check_pools(jc, tc)

    # One decode step; lane 2 is dead (all-trash table).
    pos = (start + l2).astype(np.int32)
    dtbl = tbl.copy()
    dtbl[2] = 0
    tk = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tk),
                            jnp.asarray(pos), block_tables=jnp.asarray(dtbl))
    tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(tk),
                            torch.from_numpy(pos),
                            block_tables=torch.from_numpy(dtbl))
    assert tl.shape == (B, 1, jcfg.vocab_size)
    check(_np(jl)[:2], _np(tl)[:2])
    check_pools(jc, tc)


def test_params_layout_and_count_match_jax(configs):
    """The port's parameter tree has the reference's keys and shapes, so
    weights carry across; ``init_params`` draws the reference's
    distributions (checked by their moments, not their bits)."""
    jcfg, tcfg, jparams = configs
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    assert jshapes == TM.param_shapes(tcfg)
    full = get_config("tinyllama-1.1b")
    assert full.param_count() == TM.param_count(full)
    assert tcfg.param_count() == jcfg.param_count()
    p = TM.init_params(tcfg, seed=3, device="cpu")
    again = TM.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(p["blocks"]["mlp"]["w_up"],
                       again["blocks"]["mlp"]["w_up"])
    w = p["blocks"]["attn"]["wq"].float()
    assert abs(w.std().item() * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    assert abs(p["embed"].float().std().item() - 0.02) < 0.002
    assert torch.all(p["final_norm"]["scale"] == 1)
    assert p["embed"].dtype == torch.bfloat16
