"""The port's full-sequence forward, loss and gradients against the JAX
package, for all six families (reduced configs; zamba2-7b at 5 layers,
so that it has two groups and a tail).

Weights come from the JAX ``init_params`` cast to fp32 and carried across
(``torch_parity.pair``: ``attn_kernel="off"``); tokens, labels, patch
embeddings and frames from numpy seeds (fp32 frames: the JAX whisper
encoder does not trace with fp32 params and bf16 frames).  The JAX side
is ``repro.models.model.forward`` and ``jax.value_and_grad(loss_fn)``;
the port's gradients come from plain torch autograd.

Tolerances (fp32, the same arithmetic summed in another order): logits
within 1e-4 of their range; the loss within 1e-5 relative; each leaf's
gradient within 1e-4 as max|Δ| / max|g_ref| (measured at most 1.5e-5,
zamba2-7b; 4e-6 or less for the other families).  Within the port,
``remat`` on and off give the same loss and gradients bit for bit, and
``decode_step`` after ``prefill`` equals ``forward`` at the next
position within 1e-2 of the range, the reference's own limit there
(``tests/test_system.py``): the wave caches hold K/V in bf16 whatever
the parameters' dtype.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from torch_parity import (FAMILY_ARCHS, B, S, as_np, batches,  # noqa: E402
                          models_of, pair)

ARCHS = FAMILY_ARCHS
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DECODE_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on a few cores, where spinning thread pools slow each other
    severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_loss_and_grads(cfg, params, batch, remat=True):
    """loss_fn (or the forward with ``remat`` as given) and every leaf's
    gradient by autograd, in ``tree.flatten`` order."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    p = tree.unflatten(params, leaves)
    if remat:
        loss = TM.loss_fn(cfg, p, batch)
    else:
        logits, aux = TM.forward(cfg, p, batch, remat=False)
        logits = logits.float()
        gold = torch.gather(logits, -1,
                            batch["labels"].long()[..., None])[..., 0]
        loss = (torch.logsumexp(logits, -1) - gold).mean() \
            + TM.MOE_AUX_COEF * aux
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """Both packages' forward, loss and gradients on one batch."""
    jcfg, jparams, tcfg, tparams = models_of(request.param)
    jb, tb = batches(tcfg)
    jl, ja = JM.forward(jcfg, jparams, jb)
    with torch.no_grad():
        tl, ta = TM.forward(tcfg, tparams, tb)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb))(jparams)
    tloss, tgrads = port_loss_and_grads(tcfg, tparams, tb)
    return dict(arch=request.param, tcfg=tcfg, tparams=tparams, tb=tb,
                logits=(as_np(jl), as_np(tl)), aux=(float(ja), float(ta)),
                loss=(float(jloss), float(tloss)),
                grads=(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                       tgrads))


def within_range(got, want, tol, what):
    span = float(want.max() - want.min())
    err = float(np.abs(got - want).max())
    print(f"{what}: {err / span:.3g} of the range")
    assert err <= tol * span, f"{what}: max|Δ| {err:.3g} > {tol} x {span:.3g}"


def test_forward_matches_jax(family):
    jl, tl = family["logits"]
    cfg = family["tcfg"]
    assert tl.shape == jl.shape == (B, S, cfg.vocab_size)
    within_range(tl, jl, LOGIT_TOL, f"{family['arch']} logits")
    ja, ta = family["aux"]
    assert ta == pytest.approx(ja, rel=1e-5, abs=1e-7)
    if cfg.family == "moe":
        assert ja > 0  # the load-balancing loss reaches the sum


def test_loss_and_every_gradient_match_jax(family):
    jloss, tloss = family["loss"]
    assert tloss == pytest.approx(jloss, rel=LOSS_RTOL)
    jflat, tgrads = family["grads"]
    paths = [p for p, _ in tree.flatten(family["tparams"])]
    assert len(jflat) == len(tgrads) == len(paths)
    for (jpath, jg), path, tg in zip(jflat, paths, tgrads):
        jg = np.asarray(jg)
        assert tg.shape == jg.shape, path
        assert np.isfinite(tg.numpy()).all(), path
        scale = float(np.abs(jg).max())
        assert scale > 0, f"{path}: the reference's gradient is zero"
        err = float(np.abs(tg.numpy() - jg).max())
        assert err <= GRAD_TOL * scale, \
            f"{path}: max|Δg| {err:.3g} > {GRAD_TOL} x {scale:.3g}"


def test_remat_on_and_off_agree(family):
    cfg, params, tb = family["tcfg"], family["tparams"], family["tb"]
    l_on, g_on = port_loss_and_grads(cfg, params, tb, remat=True)
    l_off, g_off = port_loss_and_grads(cfg, params, tb, remat=False)
    assert torch.equal(l_on, l_off)
    for path, a, b in zip(tree.flatten(params), g_on, g_off):
        assert torch.equal(a, b), path[0]


def test_decode_after_prefill_matches_forward(family):
    """Twin of tests/test_system.py's oracle: prefill S tokens, decode the
    next one; its logits equal the full-sequence forward's at position
    S.  S = 16 as there: the forward's S + 1 positions fit in one SSD
    chunk."""
    cfg, params = family["tcfg"], family["tparams"]
    n = 16
    _, tb = batches(cfg, seed=1, S=n + 1)
    full = {k: v for k, v in tb.items() if k != "labels"}
    prompt = dict(full, tokens=full["tokens"][:, :n])
    with torch.no_grad():
        want, _ = TM.forward(cfg, params, full)
        _, cache = TM.prefill(cfg, params, prompt, max_len=n + 8)
        got, _ = TM.decode_step(cfg, params, cache,
                                full["tokens"][:, n:n + 1], n)
    within_range(got[:, 0].numpy(), want[:, n].numpy(), DECODE_TOL,
                 f"{family['arch']} decode vs forward")


def test_long_forward_pads_into_the_chunked_path():
    """S = 2048 + 64: the forward pads to a multiple of Q_CHUNK (2560)
    and attends blockwise, as the reference does; logits match JAX."""
    jcfg, jparams, tcfg, tparams = pair("tinyllama-1.1b")
    S_long = TL.CHUNKED_ATTN_THRESHOLD + 64
    jb, tb = batches(tcfg, seed=2, S=S_long, B=1)
    padded, n = TM._pad_to_multiple(torch.zeros(1, S_long, 4), TL.Q_CHUNK)
    assert n == S_long and padded.shape[1] == 2560
    jl, _ = JM.forward(jcfg, jparams, {"tokens": jb["tokens"]})
    with torch.no_grad():
        tl, _ = TM.forward(tcfg, tparams, {"tokens": tb["tokens"]})
    within_range(as_np(tl), as_np(jl), LOGIT_TOL, "S = 2112 logits")


def test_kernel_route_only_without_grad():
    """The forward's kernels run only with grad disabled; "on" with grad
    enabled raises rather than hand autograd a detached result."""
    cpu = torch.device("cpu")
    cfg = get_config("tinyllama-1.1b").reduced()
    on = dataclasses.replace(cfg, attn_kernel="on")
    assert not TM.kernel_route(cfg, cpu)
    with pytest.raises(ValueError, match="grad enabled"):
        TM.kernel_route(on, cpu)
    with pytest.raises(ValueError, match="grad enabled"):
        TM.forward(on, TM.init_params(on, 0, device="cpu"),
                   {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    with torch.no_grad():
        assert not TM.kernel_route(cfg, cpu)  # "auto" on CPU tensors
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            TM.kernel_route(on, cpu)


def test_flash_attention_route_shapes_and_layout():
    """K5's shape rules (whisper-base's 1500 frames and zamba2-7b's head
    dim 112 fall back to the plain attention), and the route's layout:
    through ``ops.attention`` (its plain version on CPU tensors) the
    output equals the plain ``self_attend``'s within 1e-5."""
    def qk(S, H, D):
        return torch.zeros(1, S, H, D), torch.zeros(1, S, 1, D)
    assert TL.fits_flash_attention(*qk(2048, 32, 64))
    assert TL.fits_flash_attention(*qk(128, 8, 128))
    assert not TL.fits_flash_attention(*qk(1500, 8, 64))
    assert not TL.fits_flash_attention(*qk(2048, 32, 112))
    assert not TL.fits_flash_attention(torch.zeros(1, 128, 8, 64),
                                       torch.zeros(1, 256, 1, 64))
    cfg = get_config("tinyllama-1.1b").reduced()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    for causal in (True, False):
        got = TL.self_attend(cfg, q, k, v, causal, use_kernel=True)
        want = TL.self_attend(cfg, q, k, v, causal)
        assert got.shape == want.shape == (2, 256, 256)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
