"""Dry run: what one step of every (arch x shape x mesh) cell costs a
device, counted on ``meta`` tensors.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for 512 forced host devices and reads XLA's cost and memory
analyses; the port has no compiler, so each record term maps as follows
(every record's ``basis`` says so):

  * FLOPs (``flops_hlo_global``): ``torch.utils.flop_counter`` over the
    meshless step of ``steps.step_and_args`` on ``meta`` tensors at full
    depth.  The reference lowers depth variants and adds the blockwise
    attention's FLOPs analytically because XLA counts a ``while`` body
    once; the port's layers and attention blocks run in Python loops, so
    every op is dispatched and counted: no extrapolation, no attention
    correction (``attention_correction`` is 0).
  * Bytes (``bytes_hlo_global``): the bytes each dispatched op reads and
    writes (its tensor arguments and results; views and allocations
    excluded), summed by a ``TorchDispatchMode`` over the same run —
    unfused op traffic, not XLA's fused ``bytes accessed``.
  * Per-device argument and output bytes (``memory_analysis``): exact,
    each placed piece counted where it lives (``port_specs``: the port's
    placement — the Mamba-2 leaves and conv windows by component, their
    B and C columns whole on every model shard); ``fits_one_card`` holds
    them to one H100's 80 GB.  No temporaries: there is no compiled buffer
    plan (the card's peak is measured by ``chip_smoke.py``).
  * Collective wire bytes (train shapes): ``train_collectives``, an
    analytic count of the port's sharded step (``make_train_step(mesh=)``)
    over the cell's layout — FSDP gathers (forward, and again in the
    rematerialized backward), their reduce-scatters, TP psums, the MoE
    all-to-alls, the replicated leaves' gradient sums — scaled by the
    copied ring factors (``core.roofline._wire_factor``).  The tests hold
    it equal, kind by kind, to the bytes the port's own step counts on
    small meshes (``Mesh.moved_bytes``), which is what makes it
    trustworthy at 256 devices, where one controller would take ~256
    times a meshless step.  Serving shapes: null; ``serve_collectives``
    counts one paged ``decode_step`` or ``prefill_slots`` chunk over a
    (data, model) mesh, row j serving lane j (lanes over data, the
    pool's written rows gathered), which the tests hold equal to the
    bytes those calls count.

Results are written as JSON under ``experiments/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
import traceback
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.core import roofline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib, steps as steps_lib
from repro_torch.models import layers, model as M, moe as moe_lib
from repro_torch.parallel import sharding

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

#: One H100's device memory (80 GB HBM3).
CARD_BYTES = 80e9


# ---------------------------------------------------------------------------
# FLOPs and op bytes on meta tensors
# ---------------------------------------------------------------------------

class OpBytes(TorchDispatchMode):
    """Sums the bytes every dispatched op reads and writes: its tensor
    arguments and results, each once per op.  Views and allocations move
    nothing and are skipped."""

    SKIP = ("empty", "empty_like", "empty_strided", "detach", "alias",
            "lift_fresh")

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (getattr(func, "is_view", False)
                or func.overloadpacket.__name__ in self.SKIP):
            flat = tree_flatten((args, kwargs or {}))[0] + \
                tree_flatten(out)[0]
            self.bytes += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


@functools.lru_cache(maxsize=4)
def measure(cfg, shape_name: str) -> Dict[str, float]:
    """Global FLOPs and op bytes of one meshless step of the cell on
    ``meta`` tensors.  They do not depend on the mesh: a cell's single-
    and multi-pod records share one count (``--mesh both``)."""
    step, args = steps_lib.step_and_args(cfg, shape_name)
    flops = FlopCounterMode(display=False)
    nbytes = OpBytes()
    with flops, nbytes:
        step(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes)}


# ---------------------------------------------------------------------------
# Per-device argument and output bytes of the port's placement
# ---------------------------------------------------------------------------

def _specs_of(trees):
    """A tuple of trees of ``NamedSharding`` as trees of their specs."""
    return tuple(tree_lib.map_leaves(lambda ns: ns.spec, t) for t in trees)


def _no_model(spec):
    """``spec`` with its ``model`` entries dropped (whole over it)."""
    return sharding.P(*(None if sharding.TP_AXIS in sharding._axes_tuple(a)
                        else a for a in spec))


def _cache_placement(cfg, cache, ref, mesh):
    """A serving cache as the port places it: ``wave_cache_specs``' cut
    over ``model`` (stripes on their KV heads, Mamba-2 states on their
    heads, conv windows by components, B and C whole on every shard)
    beside the reference's cut of the batch over the data axes (one
    controller a data shard)."""
    port = sharding.wave_cache_specs(cfg, cache, mesh)

    def merge(path, p, r):
        data = list(_no_model(r)) + [None] * (len(p) - len(r))
        if isinstance(p, sharding.Components):
            rows = [(a, i) for i, a in enumerate(data) if a is not None]
            dim = tuple(p).index(sharding.TP_AXIS)
            return sharding.Components(len(p), dim, p.comps,
                                       rows[0] if rows else None)
        return sharding.P(*(a if a is not None else b
                            for a, b in zip(p, data)))

    return sharding._map_with_path(merge, port, ref)


def port_specs(cfg, shape_name: str, mesh):
    """(argument trees, their specs, output trees, their specs) of one
    step of the cell as the port places them on ``mesh``: a train step's
    parameters and moments by ``sharding.train_placement`` (the Mamba-2
    leaves by component, B and C whole on every model shard), a serving
    step's parameters by ``sharding.serve_specs`` and caches by
    ``_cache_placement``; batches, tokens and metrics as
    ``steps.shardings_for`` places them, the serving logits whole over
    ``model`` (the port gathers them)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.training import optimizer as opt_lib
    shape = SHAPES[shape_name]
    ins = specs_lib.input_specs(cfg, shape_name)
    in_sh, out_sh = steps_lib.shardings_for(cfg, shape_name, mesh)
    in_sp, out_sp = _specs_of(in_sh), _specs_of(out_sh)
    if shape.kind == "train":
        pspec = sharding.train_placement(cfg, ins["params"], mesh)
        ospec = opt_lib.AdamWState(step=sharding.P(), m=pspec, v=pspec)
        metrics = {k: specs_lib.sds((), torch.float32)
                   for k in ("grad_norm", "lr", "loss")}
        return ((ins["params"], ins["opt_state"], ins["batch"]),
                (pspec, ospec, in_sp[2]),
                (ins["params"], ins["opt_state"], metrics),
                (pspec, ospec, out_sp[2]))
    pspec = sharding.serve_specs(cfg, ins["params"], mesh)
    if shape.kind == "prefill":
        cache = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
        logits = specs_lib.sds((shape.global_batch, cfg.vocab_size),
                               torch.bfloat16)
        cspec = _cache_placement(cfg, cache, out_sp[1], mesh)
        return ((ins["params"], ins["batch"]), (pspec, in_sp[1]),
                (logits, cache), (_no_model(out_sp[0]), cspec))
    cache = ins["cache"]
    logits = specs_lib.sds((shape.global_batch, 1, cfg.vocab_size),
                           torch.bfloat16)
    cspec = _cache_placement(cfg, cache, in_sp[1], mesh)
    return ((ins["params"], cache, ins["tokens"], ins["position"]),
            (pspec, cspec, in_sp[2], in_sp[3]),
            (logits, cache), (_no_model(out_sp[0]), cspec))


def placed_bytes(trees, specs, mesh) -> float:
    """Bytes one place holds of ``trees`` placed by ``specs``: each
    leaf's part (``sharding.local_shape``), component cuts included."""
    total = 0.0
    for tree, spec_tree in zip(trees, specs):
        for (_, leaf), (_, spec) in zip(tree_lib.flatten({"x": tree}),
                                        tree_lib.flatten({"x": spec_tree})):
            total += math.prod(sharding.local_shape(leaf.shape, spec,
                                                    mesh)) \
                * leaf.element_size()
    return total


def device_bytes(cfg, shape_name: str, mesh) -> Dict[str, float]:
    """Argument and output bytes one device holds (``port_specs``), and
    a serving step's cache bytes."""
    args, in_specs, outs, out_specs = port_specs(cfg, shape_name, mesh)
    out = {"argument_size_in_bytes": placed_bytes(args, in_specs, mesh),
           "output_size_in_bytes": placed_bytes(outs, out_specs, mesh)}
    if SHAPES[shape_name].kind != "train":  # the cache the step holds
        out["cache_size_in_bytes"] = placed_bytes(outs[1:], out_specs[1:],
                                                  mesh)
    return out


# ---------------------------------------------------------------------------
# Collective wire bytes of the sharded train step, analytically
# ---------------------------------------------------------------------------

_OP = {"psum": "all-reduce", "grad_sum": "all-reduce",
       "all_gather": "all-gather", "all_to_all": "all-to-all"}


class _Wire:
    """Global wire bytes by the port's collective kinds:
    ``add(kind, g, result_bytes, fwd, bwd)`` counts a collective over
    groups of g places whose result (per place) is ``result_bytes``,
    ``fwd`` times forward and ``bwd`` times its transpose (``kind +
    "/bwd"``; an all-gather's is a reduce-scatter, whose result is the
    scattered piece)."""

    def __init__(self, n: int):
        self.n = n
        self.by_kind: Dict[str, float] = defaultdict(float)

    def add(self, kind: str, g: int, result: float, fwd: int = 1,
            bwd: int = 1) -> None:
        if g <= 1:
            return
        op = _OP[kind]
        self.by_kind[kind] += fwd * self.n * roofline._wire_factor(op, g) \
            * result
        if bwd and kind != "grad_sum":
            b_op, b_res = (("reduce-scatter", result / g)
                           if op == "all-gather" else (op, result))
            self.by_kind[kind + "/bwd"] += bwd * self.n * \
                roofline._wire_factor(b_op, g) * b_res


def _nb(x: torch.Tensor) -> float:
    return float(x.numel() * x.element_size())


def moe_collectives(w: "_Wire", cfg, mesh, batch: int, S: int, e: int,
                    specs, kept: bool, fwd: int, bwd: int) -> None:
    """Add one MoE layer's collectives (``moe.apply_moe(mesh=)`` in
    training on a batch of ``batch`` rows of S tokens placed as
    ``sharding.place_batch`` places it, in a dtype of ``e`` bytes) to
    ``w``, ``fwd`` and ``bwd`` times.  The experts are laid out by
    ``specs`` where ``kept`` (cut over the data axes as they lie), else
    whole over the data axes (gathered beforehand, not counted)."""
    st = sharding.AxisState.from_mesh(mesh)
    Mn = st.size(sharding.TP_AXIS)
    R = math.prod(st.size(a) for a in st.dp if st.size(a) > 1)
    whole = batch % R != 0  # every data place holds every row
    T = (batch if whole else batch // R) * S  # a place's tokens
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    act = T * d * e
    if moe_lib.expert_parallel(cfg, mesh, (batch, S)):
        # The manual path: all-to-alls over ``data``, the experts' axis;
        # a whole batch's token slices gathered over the data axes.
        T_loc = T // R if whole else T
        C = moe_lib.capacity(cfg, T_loc)
        D = st.size("data")
        d_loc, E_loc = d // Mn, E // D
        w.add("psum", Mn, T_loc * E * 4, fwd, bwd)  # router logits, fp32
        w.add("all_to_all", D, E * C * d_loc * e, 2 * fwd, 2 * bwd)
        w.add("psum", Mn, 2 * E_loc * C * D * f * e, fwd, bwd)
        if whole:
            w.add("all_gather", R, T * d_loc * e, fwd, bwd)
        w.add("all_gather", Mn, act, fwd, bwd)
        w.add("psum", R * Mn, 4, fwd, bwd)  # aux, a 0-d fp32
    else:
        d_cut = moe_lib.expert_cuts(specs["w_gate"], mesh)[0]
        rows = sharding._cuts(specs["w_gate"], mesh)[1]
        if kept:  # ``_grouped``: a group a data place, or one in all
            ep_n = math.prod(st.size(a) for a in rows[0]) if rows else 1
            d_c, E_loc = (d // Mn if d_cut else d), E // ep_n
            C = moe_lib.capacity(cfg, T)
            if not whole:  # to the experts' owners and back
                w.add("all_to_all", ep_n, E * C * d_c * e, 2 * fwd, 2 * bwd)
            if d_cut:  # the up projections at hidden volume
                w.add("psum", Mn, 2 * E_loc * C * (1 if whole else ep_n)
                      * f * e, fwd, bwd)
            if whole:  # every expert's outputs on every place
                w.add("all_gather", ep_n, E * C * d_c * e, fwd, bwd)
        if d_cut:
            w.add("all_gather", Mn, act, fwd, bwd)
        elif sharding._cuts(specs["w_down"], mesh)[0] is not None:
            w.add("psum", Mn, act, fwd, bwd)
        if not whole:
            # The router statistics' mean over the data places: mean
            # probabilities (differentiable) and top-1 fractions (not: no
            # transpose).
            w.add("psum", R, E * 4, fwd, bwd)
            w.add("psum", R, E * 4, fwd, 0)
    if "shared" in specs and sharding._cuts(specs["shared"]["w_down"],
                                            mesh)[0] is not None:
        w.add("psum", Mn, act, fwd, bwd)


def moe_layer_collectives(cfg, batch: int, seq: int, mesh,
                          dtype_bytes: int = 2) -> Dict[str, float]:
    """Global wire bytes, by kind, of one forward of ``moe.apply_moe``
    over ``mesh`` on a training batch of ``batch`` rows of ``seq``
    tokens placed by ``sharding.place_batch``, the layer placed by
    ``sharding.train_specs``: its router and shared expert gathered over
    the data axes beforehand (not counted), its experts as placed.  The
    layer meets them as placed, not gathered as ``train_collectives``'
    steps gather them where they are not cut on d_model, so experts cut
    either way (``moe.expert_cuts``) stay cut here."""
    specs = sharding.train_specs(cfg, M.param_specs(cfg), mesh)
    moe = specs["blocks"]["moe"]
    w = _Wire(mesh.devices.size)
    moe_collectives(w, cfg, mesh, batch, seq, dtype_bytes, moe,
                    any(moe_lib.expert_cuts(moe["w_gate"], mesh)), 1, 0)
    return dict(w.by_kind)


def train_collectives(cfg, batch: int, seq: int, mesh, params=None
                      ) -> Dict[str, float]:
    """Global wire bytes, by kind, of one ``make_train_step(mesh=)`` step
    of ``batch`` x ``seq`` tokens on ``params`` (default: the config's
    bf16 ``model.param_specs``) placed by ``sharding.train_placement`` on
    a mesh of ``mesh``'s axes (its devices are not used: a meta mesh of
    the production shape will do).  Kinds as ``Mesh.moved_bytes`` counts
    them.  Each rematerialized block's gathers and psums run twice
    forward (the forward and the recompute) and their transposes once;
    a Mamba-2 block inside a rematerialized hybrid group three times
    (the group's recompute runs it again before its own).  A batch that
    does not divide the data axes is whole on every data place
    (``sharding.place_batch``): each place's activations are the whole
    batch's, and the MoE takes its token slices or its grouped path
    (``moe_collectives``)."""
    params = M.param_specs(cfg) if params is None else params
    sizes = mesh.shape
    st = sharding.AxisState.from_mesh(mesh)
    n = mesh.devices.size
    Mn = st.size(sharding.TP_AXIS)
    dp = tuple(a for a in st.dp if st.size(a) > 1)
    R = math.prod(st.size(a) for a in dp)
    B = batch // R if batch % R == 0 else batch  # a place's rows
    specs = sharding.train_placement(cfg, params, mesh)
    w = _Wire(n)
    e = params["embed"].element_size()  # the activations' dtype
    d = cfg.d_model
    fam = cfg.family

    def cuts(spec):
        """(model dim, rows, the axes the leaf is cut over)."""
        dim, rows = sharding._cuts(spec, mesh)
        axes = set(rows[0] if rows else ()) | ({sharding.TP_AXIS}
                                                if dim is not None else set())
        return dim, rows, axes

    def part(leaf, spec) -> float:
        """Bytes of one place's part."""
        return float(math.prod(sharding.local_shape(leaf.shape, spec, mesh))
                     * leaf.element_size())

    # Gradient sums of pieces several places hold, and of the components
    # every model shard holds whole.
    for (path, leaf), (_, spec) in zip(tree_lib.flatten(params),
                                       tree_lib.flatten(specs)):
        dim, _, axes = cuts(spec)
        w.add("grad_sum", math.prod(s for a, s in sizes.items()
                                    if a not in axes), part(leaf, spec))
        comps = getattr(spec, "comps", None) if dim is not None else None
        if comps is not None:
            local = sharding._local_lengths(comps, Mn)
            held = sum(k for k, (_, c) in zip(local, comps) if not c)
            w.add("grad_sum", Mn, part(leaf, spec) * held / sum(local))

    def gather_data(leaf, spec, fwd, bwd, lead=1):
        _, rows, _ = cuts(spec)
        if rows is not None:
            g = math.prod(sizes[a] for a in rows[0])
            w.add("all_gather", g, part(leaf, spec) / lead * g, fwd, bwd)

    heads_cut = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1

    def layer(tree, spec_tree, lead, fwd, bwd, keep=lambda keys: False):
        """``_gather_layer``'s gathers of a block whose leaves ``tree``
        stacks ``lead`` of (1: unstacked), ``fwd`` times forward and
        ``bwd`` times backward in all."""
        for (path, leaf), (_, spec) in zip(tree_lib.flatten(tree),
                                           tree_lib.flatten(spec_tree)):
            keys = path.split("/")
            if not keep(keys):
                gather_data(leaf, spec, fwd, bwd, lead)
            if keys[0] in M.ATTN_KEYS and not heads_cut and \
                    cuts(spec)[0] is not None:
                w.add("all_gather", Mn, _nb(leaf) / lead, fwd, bwd)

    def cut(spec):
        return cuts(spec)[0] is not None

    def psum(nbytes, fwd, bwd, spec=None):
        """A psum over ``model`` of ``nbytes`` a place, where ``spec``
        (row-parallel weight) is cut over it."""
        if spec is None or cut(spec):
            w.add("psum", Mn, nbytes, fwd, bwd)

    def mamba(spec_tree, fwd, bwd):
        """A Mamba-2 block's psums, where its heads are cut: the gated
        norm's fp32 sum of squares and ``out_proj``'s partials."""
        if isinstance(spec_tree["mamba"]["in_proj"], sharding.Components):
            psum(B * S_pad * 4, fwd, bwd)
            psum(act, fwd, bwd)

    prefix = cfg.num_patches if fam == "vlm" else 0
    total = prefix + seq
    mult = layers.Q_CHUNK if total >= layers.CHUNKED_ATTN_THRESHOLD else 1
    S_pad = -(-total // mult) * mult
    act = B * S_pad * d * e
    # Embedding (once), its vocab-parallel lookup's psum.
    gather_data(params["embed"], specs["embed"], 1, 1)
    if cuts(specs["embed"])[0] == 0:
        w.add("psum", Mn, B * seq * d * e)
    if fam == "vlm":
        gather_data(params["patch_proj"], specs["patch_proj"], 1, 1)
        if cut(specs["patch_proj"]):
            w.add("all_gather", Mn, B * prefix * d * e)

    def attn_psums(blk, fwd, bwd, rows=B * S_pad):
        """An attention block's psums: ``wo``'s where the heads are cut,
        the MLP's down projection's."""
        if heads_cut:
            psum(rows * d * e, fwd, bwd, blk["attn"]["wo"])
        if "mlp" in blk:
            psum(rows * d * e, fwd, bwd, blk["mlp"]["w_down"])

    # The layers: each gather and psum forward, again in the remat, and
    # its transpose once.
    if fam in M.ATTENTION_FAMILIES:
        L = cfg.num_layers
        blocks = specs["blocks"]
        kept = cfg.moe is not None and moe_lib.expert_cuts(
            blocks["moe"]["w_gate"], mesh)[0]
        layer(params["blocks"], blocks, L, 2 * L, L, keep=lambda keys: (
            kept and keys[0] == "moe" and "shared" not in keys
            and keys[-1] in ("w_gate", "w_up", "w_down")))
        attn_psums(blocks, 2 * L, L)
        if cfg.moe is not None:
            moe_collectives(w, cfg, mesh, batch, S_pad, e, blocks["moe"],
                            kept, 2 * L, L)
    elif fam == "ssm":
        L = cfg.num_layers
        layer(params["blocks"], specs["blocks"], L, 2 * L, L)
        mamba(specs["blocks"], 2 * L, L)
    elif fam == "hybrid":
        groups, per, tail = M.hybrid_layout(cfg)
        n_in = groups * per
        layer(params["groups"], specs["groups"], n_in, 3 * n_in, n_in)
        mamba(specs["groups"], 3 * n_in, n_in)
        layer(params["shared_attn"], specs["shared_attn"], 1, 2 * groups,
              groups)
        attn_psums(specs["shared_attn"], 2 * groups, groups)
        if tail:
            layer(params["tail"], specs["tail"], tail, 2 * tail, tail)
            mamba(specs["tail"], 2 * tail, tail)
    elif fam == "audio":
        E, L = cfg.encdec.num_encoder_layers, cfg.num_layers
        F = cfg.encdec.encoder_seq_len
        enc, dec = specs["enc_blocks"], specs["dec_blocks"]
        layer(params["enc_blocks"], enc, E, 2 * E, E)
        attn_psums(enc, 2 * E, E, rows=B * F)
        layer(params["dec_blocks"], dec, L, 2 * L, L)
        if heads_cut:
            psum(act, 2 * L, L, dec["self_attn"]["wo"])
            psum(act, 2 * L, L, dec["cross_attn"]["wo"])
        psum(act, 2 * L, L, dec["mlp"]["w_down"])
    else:
        raise ValueError(fam)
    # Unembedding: the head's gather (a tied table was gathered above),
    # the vocab-parallel logits' all_gather.
    head = "embed" if cfg.tie_embeddings else "lm_head"
    if not cfg.tie_embeddings:
        gather_data(params["lm_head"], specs["lm_head"], 1, 1)
    if cuts(specs[head])[0] == (0 if cfg.tie_embeddings else 1):
        w.add("all_gather", Mn, B * seq * cfg.vocab_size * e)
    return dict(w.by_kind)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

BASIS = {
    "flops_hlo_global": "torch.utils.flop_counter over the meshless step "
                        "on meta tensors, full depth (no depth variants: "
                        "the port's layer loop is Python)",
    "bytes_hlo_global": "bytes read + written per dispatched op on meta "
                        "tensors (unfused op traffic), not XLA's bytes "
                        "accessed",
    "wire_bytes_global": "analytic count of make_train_step(mesh=)'s "
                         "collectives with the ring factors "
                         "(train_collectives); null for serving shapes: "
                         "the port serves over model alone",
    "attention_correction": "0: the blockwise attention's loops are "
                            "Python, every block counted",
    "compile_s": "null: no compiler",
    "memory_analysis": "argument/output bytes per device (and a serving "
                       "step's cache bytes) of the port's placement "
                       "(port_specs); temp null: no buffer plan",
    "roofline": "core.roofline with the H100's constants (989 TFLOP/s "
                "bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a direction)",
}


def serve_collectives(cfg, mesh, rows: int, *, chunk: Optional[int] = None,
                      table_width: int, written: int, act: int = 2,
                      token_bytes: int = 4, first: bool = True,
                      all_logits: bool = False, active: bool = True,
                      lanes: Optional[sharding.Lanes] = None
                      ) -> Dict[str, int]:
    """Bytes, by kind as ``Mesh.moved_bytes`` counts them, that one paged
    call of an attention family moves between the places of ``mesh`` (a
    (data, model) mesh; every cut the sanitized rules keep divides): a
    ``decode_step`` of ``rows`` rows (``chunk`` None) or a
    ``prefill_slots`` chunk of ``rows`` rows of ``chunk`` tokens, row j
    serving lane j of ``rows`` or, for a chunk, ``lanes``
    (``sharding.Lanes``).

      * the scheduler inputs, each data index's rows to each of its
        places ("scatter", place 0's own not counted), or, where the
        lanes' width does not divide the data axes, every row to every
        place ("broadcast"): decode — tokens (``token_bytes``), positions
        (int32), ``table_width`` int32 table entries and, with
        ``active``, the live-lane mask (bool); a chunk — tokens, lengths
        and (unless ``first``) starts (int32), table entries, the
        positions (int64) and real-key mask (bool) of its prefix + chunk
        columns, and a vlm first chunk's patch embeddings (bf16);
      * over ``model``, in ``act``-byte activations: the embedding (a
        psum of the masked lookups where the vocab divides the axis, else
        an all_gather of d_model columns), a vlm first chunk's patch
        projection (all_gather), per layer the psums of ``wo`` (heads
        cut) and of the MLP's down projection (hidden dim cut), the
        logits (all_gather of the vocab, or a psum where it does not
        divide) — a psum 2 (m - 1) times its bytes a data index, an
        all_gather m - 1 times;
      * a moe layer's collectives instead of the MLP's
        (``moe_serve_collectives``);
      * the logits of every data index but place 0's to place 0
        ("row_gather");
      * the ``written`` live pool rows (trash block excluded), every
        layer's K and V (and SCLAD scales) of each model shard's heads,
        to the m places of each other data index ("pool_gather").
    """
    st = sharding.AxisState.from_mesh(mesh)
    m = st.size(sharding.TP_AXIS)
    d = sharding.data_size(mesh)
    split = sharding.split_rows(mesh, lanes if chunk is not None else None,
                                rows)
    cut = split is not None
    held = len(split.rows[0]) if cut else rows  # data index 0's rows
    R = rows if cut else d * rows  # rows summed over the data indices
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    vlm_first = cfg.family == "vlm" and chunk is not None and first
    prefix = cfg.num_patches if vlm_first else 0
    toks = 1 if chunk is None else chunk
    S = prefix + toks
    if chunk is None:
        row_in = token_bytes + 4 + 4 * table_width + (1 if active else 0)
    else:
        row_in = (toks * token_bytes + 4 + (0 if first else 4)
                  + 4 * table_width + S * (8 + 1) + prefix * D * 2)
    out: Dict[str, int] = defaultdict(int)
    if cut:
        out["scatter"] = (m * rows - held) * row_in
    else:
        out["broadcast"] = (d * m - 1) * rows * row_in
    a = sharding.attn_shard_size(mesh, cfg.num_kv_heads)
    if m > 1:
        emb = R * toks * D * act
        if V % m == 0:
            out["psum"] += 2 * (m - 1) * emb
        else:
            out["all_gather"] += (m - 1) * emb
        if prefix and D % m == 0:
            out["all_gather"] += (m - 1) * R * prefix * D * act
        per_layer = (a > 1) + (cfg.moe is None and cfg.d_ff % m == 0)
        out["psum"] += 2 * (m - 1) * L * per_layer * R * S * D * act
        logit_rows = R * (toks if all_logits else 1)
        if V % m == 0:
            out["all_gather"] += (m - 1) * logit_rows * V * act
        else:
            out["psum"] += 2 * (m - 1) * logit_rows * V * act
    if cfg.moe is not None:
        call = sharding.call_rows(lanes if chunk is not None else None, rows,
                                  split)
        for kind, n in moe_serve_collectives(cfg, mesh, call, S,
                                             act).items():
            out[kind] += L * n
    if cut:
        out["row_gather"] = (rows - held) * (
            toks if all_logits else 1) * V * act
        hk = cfg.num_kv_heads // a
        quant = cfg.kv_dtype in ("int8", "fp8")
        elem = 1 if quant or cfg.kv_dtype == "f8" else 2
        row = 2 * hk * cfg.head_dim * elem + (2 * hk * 4 if quant else 0)
        out["pool_gather"] = (d - 1) * m * written * L * row
    return {k: v for k, v in out.items() if v or k in (
        "scatter", "broadcast", "row_gather", "pool_gather")}


def moe_serve_collectives(cfg, mesh, call: sharding.CallRows, S: int,
                          act: int = 2) -> Dict[str, int]:
    """Bytes, by kind, that one moe layer of a serving call moves between
    the places of a (data=d, model=m) mesh (``moe.apply_moe(rows=)``):
    ``call``'s rows of S tokens, ``act``-byte activations, groups of
    ``sharding.dispatch_groups`` at capacity C of their tokens.

      * the routing choices' all_gather over data, where a group's rows
        lie on other data places: (n, S, k) int32, d - 1 times a model
        shard;
      * experts cut on E over data (E divides d): both all_to_alls of
        the (G, E, C, d') dispatch buffers (d' = D / m where D divides
        m), or, where the groups are not the places, the forward one and
        an all_gather of the outputs — an all_gather alone where every
        place holds every row; the psums of the gate and up projections'
        partials over ``model`` at hidden volume (D cut); the output's
        all_gather of d over ``model``;
      * experts whole over data: the psum of the down projection's
        partial outputs over ``model`` (the hidden dim cut);
      * the shared expert's psum over ``model``.

    A psum moves 2 (m - 1) times its bytes a group, an all_gather g - 1
    times the gathered bytes."""
    m_ = cfg.moe
    st = sharding.AxisState.from_mesh(mesh)
    m = st.size(sharding.TP_AXIS)
    d = sharding.data_size(mesh)
    E, k, D, f = m_.num_experts, m_.num_experts_per_tok, cfg.d_model, \
        cfg.d_ff
    grp = sharding.dispatch_groups(call, d)
    G, C = grp.count, moe_lib.capacity(cfg, grp.per * S)
    split = call.split
    tokens = (call.n if split is not None else d * call.n) * S
    local = sharding.groups_on_places(call, grp)
    ep = d > 1 and E % d == 0
    dcut = ep and m > 1 and D % m == 0
    d_c = D // m if dcut else D
    buf = G * E * C * d_c * act  # every group's (E, C, d') slots
    out: Dict[str, int] = defaultdict(int)
    if split is not None and not local:
        out["all_gather"] += m * (d - 1) * call.n * S * k * 4
    if ep:
        if local:
            out["all_to_all"] += 2 * m * (d - 1) * buf // d
        else:
            if split is not None:
                out["all_to_all"] += m * (d - 1) * buf
            out["all_gather"] += m * (d - 1) * buf
        if dcut:  # a place's E / d experts' slots of every group
            hid = G * (E // d) * C * f * act
            out["psum"] += d * 2 * 2 * (m - 1) * hid
            out["all_gather"] += (m - 1) * tokens * D * act
    elif m > 1 and f % m == 0:
        out["psum"] += 2 * (m - 1) * tokens * D * act
    if m_.shared_d_ff and m > 1 and m_.shared_d_ff % m == 0:
        out["psum"] += 2 * (m - 1) * tokens * D * act
    return dict(out)


def _cfg_for(arch: str, reduced: bool, kv_dtype: str):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if kv_dtype != "bf16":
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    return cfg


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path,
             force: bool = False, kv_dtype: str = "bf16",
             reduced: bool = False) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = ("" if kv_dtype == "bf16" else f"__kv{kv_dtype}") + \
        ("__reduced" if reduced else "")
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = _cfg_for(arch, reduced, kv_dtype)
    shape = SHAPES[shape_name]
    ok, why = cfg.shape_supported(shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    if reduced:
        rec["reduced"] = True
    if not ok:
        rec.update(status="skipped", reason=why)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_name == "multi"))
    n_dev = mesh.devices.size
    t0 = time.time()
    try:
        cost = dict(measure(cfg, shape_name))
        mem = device_bytes(cfg, shape_name, mesh)
        mem.update(temp_size_in_bytes=None, alias_size_in_bytes=None,
                   generated_code_size_in_bytes=None)
        coll_d, wire_g = None, None
        if shape.kind == "train":
            coll = train_collectives(cfg, shape.global_batch,
                                     shape.seq_len, mesh)
            coll_d = {k: {"wire_bytes_global": v}
                      for k, v in sorted(coll.items())}
            wire_g = sum(coll.values())
        n_params = M.param_count(cfg)
        n_active = M.param_count_active(cfg)
        tokens = shape.global_batch * (1 if shape.is_decode
                                       else shape.seq_len)
        mf = roofline.model_flops(n_active, tokens,
                                  train=(shape.kind == "train"))
        terms = roofline.RooflineTerms(
            flops=cost["flops"], bytes_hbm=cost["bytes"],
            wire_bytes=wire_g or 0.0, chips=n_dev)
        rec.update(
            status="ok",
            devices=n_dev,
            compile_s=None,
            total_s=round(time.time() - t0, 1),
            params=n_params,
            params_active=n_active,
            tokens=tokens,
            model_flops=mf,
            flops_hlo_global=cost["flops"],
            bytes_hlo_global=cost["bytes"],
            wire_bytes_global=wire_g,
            attention_correction={"flops": 0.0, "bytes": 0.0},
            useful_flops_ratio=(mf / cost["flops"]) if cost["flops"]
            else None,
            memory_analysis=mem,
            fits_one_card=mem["argument_size_in_bytes"] <= CARD_BYTES,
            collectives=coll_d,
            roofline=terms.as_dict(),
            basis=BASIS,
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def run_serving_smoke(out_dir: Path, model_parallel: int = 2,
                      requests: int = 4, max_new: int = 8,
                      device=None) -> dict:
    """Sharded-engine vs solo-engine parity on a small mesh.

    A reduced tinyllama (4 over 4 heads) with the paged pool cut over
    ``model`` (``ServingEngine(mesh=)``; the mesh names ``device`` — the
    card unless the caller says ``"cpu"`` — ``model_parallel`` times)
    must emit greedy tokens identical to the
    meshless engine's — fp32 parameters, so the psum's reduction order
    cannot flip an argmax — with identical scheduler stats.  Writes
    serving_smoke__mp<m>.json."""
    import numpy as np

    from repro_torch.serving.engine import ServingEngine

    device = resolve_device(device)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              num_heads=4, num_kv_heads=4)
    params = M.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(4, 14, size=requests)]

    def run(mesh):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=48,
                            mode="continuous", mesh=mesh, block_size=8,
                            prefill_chunk=8, seed=7, device=device)
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        t0 = time.time()
        out = eng.run()
        return out, time.time() - t0, eng.stats

    solo, solo_s, s0 = run(None)
    mesh = mesh_lib.make_mesh((1, model_parallel), ("data", "model"),
                              device)
    shard, shard_s, s1 = run(mesh)
    rec = {
        "status": "ok" if solo == shard else "error",
        "devices": model_parallel,
        "model_parallel": model_parallel,
        "requests": requests,
        "greedy_identical": solo == shard,
        "stats_identical": (s0.preemptions, s0.admissions,
                            s0.cached_prompt_tokens)
        == (s1.preemptions, s1.admissions, s1.cached_prompt_tokens),
        "solo_wall_s": round(solo_s, 3),
        "sharded_wall_s": round(shard_s, 3),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"serving_smoke__mp{model_parallel}.json"
    path.write_text(json.dumps(rec, indent=2))
    return rec


def cells(mesh_sel: str):
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[mesh_sel]
    for arch in list_archs():
        for shape_name in SHAPES:
            for m in meshes:
                yield arch, shape_name, m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "f8"])
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--serving-smoke", action="store_true",
                    help="run the serving parity smoke (a sharded reduced "
                         "engine vs the meshless one) instead of the sweep")
    ap.add_argument("--model-parallel", type=int, default=2,
                    help="[--serving-smoke] model-axis width of the "
                         "mesh the sharded engine runs on")
    ap.add_argument("--device", default=None,
                    help="[--serving-smoke] the device the mesh names: "
                         "the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.serving_smoke:
        rec = run_serving_smoke(out_dir, model_parallel=args.model_parallel,
                                device=args.device)
        print(json.dumps(rec, indent=2))
        return 0 if rec["status"] == "ok" else 1

    if args.all:
        todo = list(cells(args.mesh))
    else:
        assert args.arch and args.shape
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        todo = [(args.arch, args.shape, m) for m in meshes]

    n_ok = n_skip = n_err = 0
    for arch, shape_name, mesh_name in todo:
        rec = run_cell(arch, shape_name, mesh_name, out_dir,
                       force=args.force, kv_dtype=args.kv_dtype)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
        extra = ""
        if st == "ok":
            r = rec["roofline"]
            extra = (f"total={rec['total_s']}s bottleneck={r['bottleneck']} "
                     f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                     f"{r['t_collective_s']:.2e})s "
                     f"useful={rec['useful_flops_ratio']:.2f}"
                     if rec.get("useful_flops_ratio") else "")
        elif st == "error":
            extra = rec["error"][:160]
        print(f"[{st:7s}] {arch:24s} {shape_name:12s} {mesh_name:6s} {extra}",
              flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
