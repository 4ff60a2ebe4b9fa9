"""Helpers of the port's family parity tests (``test_torch_moe.py``,
``test_torch_vlm.py``, ``test_torch_configs.py``): a reduced config with
the JAX package's parameters cast to fp32 and carried across, the model
steps of both packages on the same inputs, and the same trace through
both engines.

fp32 is the greedy recipe: bf16 reduction-order noise can flip greedy
near-ties between frameworks; fp32 does not at these sizes.  Logits are
held to ``TOL`` (1e-4 on logits of magnitude ~4: the same arithmetic
summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM, moe as TMOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import sharding as tsh
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4
MAX_LEN = 32
STATS = ("preemptions", "cached_prompt_tokens", "prefix_hit_rate",
         "decode_steps", "prefill_chunks", "generated_tokens",
         "prefill_tokens", "admissions")
WAVE_STATS = ("decode_steps", "generated_tokens", "prefill_tokens",
              "admissions", "occupied_slot_steps", "slot_steps")


def pair(arch, **changes):
    """(jax cfg, jax fp32 params, port cfg, port params) of the reduced
    ``arch`` at ``attn_kernel="off"``, with ``changes`` to the config."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), attn_kernel="off",
                               **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), attn_kernel="off",
                               **changes)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def model_steps(models, patch_embeds=None, decode_shift=0):
    """A first chunk (rows left-padded to 8; ``patch_embeds`` (3,
    num_patches, d) fp32 on a vlm config), a continuation with every
    position's logits and a decode step with one dead lane, through both
    models on the same inputs.  ``decode_shift`` moves the port's decode
    position (a planted fault).  Returns [(step, jax logits, port logits)]
    over the real rows, and both final pools."""
    jcfg, jparams, tcfg, tparams = models
    prefix = tcfg.num_patches if tcfg.family == "vlm" else 0
    rng = np.random.default_rng(1)
    B, bs, T = 3, 4, 8
    N = 1 + B * T
    tbl = np.arange(1, N, dtype=np.int32).reshape(B, T)
    jc = JM.init_paged_cache(jcfg, N, bs)
    tc = TM.init_paged_cache(tcfg, N, bs, device="cpu")
    jx, tx = {}, {}
    if patch_embeds is not None:
        jx["patch_embeds"] = jnp.asarray(patch_embeds).astype(jnp.bfloat16)
        tx["patch_embeds"] = torch.from_numpy(patch_embeds).bfloat16()
    out = []

    P, lens = 8, np.array([8, 5, 3], np.int32)
    toks = rng.integers(1, jcfg.vocab_size, (B, P)).astype(np.int32)
    toks[np.arange(P)[None] < (P - lens)[:, None]] = 0
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(tbl), **jx)
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(tbl),
                              **tx)
    out.append(("first chunk", as_np(jl), as_np(tl)))

    start = prefix + lens
    P2, l2 = 4, np.array([4, 2, 1], np.int32)
    t2 = rng.integers(1, jcfg.vocab_size, (B, P2)).astype(np.int32)
    jl, jc = JM.prefill_slots(jcfg, jparams, jc, jnp.asarray(t2),
                              jnp.asarray(l2), jnp.asarray(tbl),
                              start=jnp.asarray(start), all_logits=True)
    tl, tc = TM.prefill_slots(tcfg, tparams, tc, torch.from_numpy(t2),
                              torch.from_numpy(l2), torch.from_numpy(tbl),
                              start=torch.from_numpy(start),
                              all_logits=True)
    real = np.arange(P2)[None] >= (P2 - l2)[:, None]
    out.append(("continuation", as_np(jl)[real], as_np(tl)[real]))

    pos = (lens + l2).astype(np.int32)  # tokens so far, the prefix excluded
    active = np.array([True, True, False])
    dtbl = np.where(active[:, None], tbl, 0).astype(np.int32)
    tk = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tk),
                            jnp.asarray(pos), active=jnp.asarray(active),
                            block_tables=jnp.asarray(dtbl))
    tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(tk),
                            torch.from_numpy(pos + decode_shift),
                            active=torch.from_numpy(active),
                            block_tables=torch.from_numpy(dtbl))
    out.append(("decode", as_np(jl)[active], as_np(tl)[active]))
    return out, jc, tc


def run(engine, reqs):
    """Submit (prompt, budget, patch embeddings or None) requests and
    drain the engine; the outputs in submission order."""
    uids = [engine.submit(p, max_new_tokens=m, patch_embeds=pe)
            for p, m, pe in reqs]
    out = engine.run()
    return [out[u] for u in uids]


def both_engines(models, reqs, **kw):
    """The trace through the JAX engine and the port's with the same
    knobs: [(outputs, stats)] for JAX, then the port."""
    jcfg, jparams, tcfg, tparams = models
    runs = []
    for eng in (JaxEngine(jcfg, jparams, max_len=MAX_LEN, eos_id=-1, **kw),
                ServingEngine(tcfg, tparams, max_len=MAX_LEN, eos_id=-1,
                              device="cpu", **kw)):
        runs.append((run(eng, reqs), eng.stats))
    return runs


def stats_of(stats, names):
    return {s: getattr(stats, s) for s in names}


def mixed_trace(vocab=256):
    """Mixed prompt lengths and budgets, a shared 8-token prefix on two
    requests (prefix-cache hits at block size 4)."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, vocab, size=8)
    reqs = []
    for i, (n, m) in enumerate(((5, 4), (9, 6), (13, 3), (3, 5), (11, 2))):
        p = rng.integers(1, vocab, size=n)
        if i in (1, 4):
            p = np.concatenate([system, p])[:MAX_LEN - 8]
        reqs.append((p, m, None))
    return reqs


MIXED_KW = dict(max_batch=3, block_size=4, prefill_chunk=8)


def wave_trace(vocab=256):
    """Repeated prompt lengths (waves of several requests) and budgets
    that differ inside a wave."""
    rng = np.random.default_rng(3)
    return [(rng.integers(1, vocab, size=n), m, None)
            for n, m in ((5, 4), (9, 6), (5, 2), (5, 5), (9, 3), (12, 4))]


#: One config of each family, for the forward / loss / train-step parity
#: tests (``test_torch_grads.py``, ``test_torch_train.py``).
FAMILY_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "internvl2-26b",
                "mamba2-1.3b", "zamba2-7b", "whisper-base")
B, S = 2, 64  # two SSD chunks of the reduced configs' 32


def models_of(arch):
    """``pair(arch)``; zamba2-7b at 5 layers: two groups and a tail."""
    return pair(arch, num_layers=5) if arch == "zamba2-7b" else pair(arch)


def batches(cfg, seed=0, S=S, B=B):
    """One numpy-seeded training batch for both packages: (jax batch,
    torch batch) with ``tokens``, ``labels`` and fp32 ``patch_embeds``
    (vlm) or ``frames`` (audio: the JAX whisper encoder does not trace
    with fp32 params and bf16 frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    nb = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        nb["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        nb["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def masked_d_cut_moe(arch, moe_params, mesh):
    """One MoE layer of the reduced ``arch`` (layer 0 of the port's
    ``moe_params``, the shared expert left out, fp32) in training with a
    mask over ``mesh``'s ``model`` axis, the experts cut on d_model as the
    manual path cuts them (``w_gate`` / ``w_up`` (E, d, f) on d,
    ``w_down`` (E, f, d) on d), the router whole; x a seeded (1, 4, d)
    batch with one token masked.  Returns (out, aux) of the layer over
    the mesh (``Sharded``), of JAX's ``apply_moe(valid=)`` under
    ``use_axes`` with the mesh's axes and of the meshless port's layer
    (numpy)."""
    from repro.models import moe as JMOE
    from repro.parallel import sharding as jsh
    cfg = get_config(arch).reduced()
    whole = {k: v[0].float() for k, v in moe_params.items()
             if k != "shared"}
    dims = {"w_gate": 1, "w_up": 1, "w_down": 2}
    layer = {k: tsh.shard(v, tsh.P(*(("model" if i == dims.get(k) else None)
                                     for i in range(v.dim()))), mesh)
             for k, v in whole.items()}
    x = np.random.default_rng(0).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32)
    valid = np.array([[True, True, False, True]])
    got = TMOE.apply_moe(cfg, layer, tsh.broadcast(torch.from_numpy(x), mesh),
                         valid=tsh.broadcast(torch.from_numpy(valid), mesh),
                         mesh=mesh)
    with jsh.use_axes(jsh.AxisState(tuple(zip(mesh.axis_names,
                                              mesh.devices.shape)))):
        ref = JMOE.apply_moe(jax_config(arch).reduced(),
                             {k: jnp.asarray(v.numpy())
                              for k, v in whole.items()},
                             jnp.asarray(x), valid=jnp.asarray(valid))
    port = TMOE.apply_moe(cfg, whole, torch.from_numpy(x),
                          valid=torch.from_numpy(valid))
    return got, tuple(map(as_np, ref)), tuple(map(as_np, port))
