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
    from ``steps.shardings_for``'s specs; ``fits_one_card`` holds them
    to one H100's 80 GB.  No temporaries: there is no compiled buffer
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
    times a meshless step.  Serving shapes: null (the port serves over
    ``model`` alone; the production mesh has ``data`` 16).

Results are written as JSON under ``experiments/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import dataclasses
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


def measure(cfg, shape_name: str) -> Dict[str, float]:
    """Global FLOPs and op bytes of one meshless step of the cell on
    ``meta`` tensors."""
    step, args = steps_lib.step_and_args(cfg, shape_name)
    flops = FlopCounterMode(display=False)
    nbytes = OpBytes()
    with flops, nbytes:
        step(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes)}


# ---------------------------------------------------------------------------
# Per-device argument and output bytes from the shardings
# ---------------------------------------------------------------------------

def _spec_bytes(tree, specs, sizes) -> float:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    total = 0.0
    for (path, leaf), (_, ns) in zip(tree_lib.flatten(tree),
                                     tree_lib.flatten(specs)):
        cut = 1
        for axes in ns.spec:
            for a in sharding._axes_tuple(axes):
                cut *= sizes.get(a, 1)
        total += leaf.numel() * leaf.element_size() / cut
    return total


def device_bytes(cfg, shape_name: str, mesh) -> Dict[str, float]:
    from repro_torch.launch import specs as specs_lib
    shape = SHAPES[shape_name]
    ins = specs_lib.input_specs(cfg, shape_name)
    in_sh, out_sh = steps_lib.shardings_for(cfg, shape_name, mesh)
    sizes = mesh.shape
    if shape.kind == "train":
        args = (ins["params"], ins["opt_state"], ins["batch"])
        metrics = {k: specs_lib.sds((), torch.float32)
                   for k in ("grad_norm", "lr", "loss")}
        outs = (ins["params"], ins["opt_state"], metrics)
    elif shape.kind == "prefill":
        args = (ins["params"], ins["batch"])
        outs = (specs_lib.sds((shape.global_batch, cfg.vocab_size),
                              torch.bfloat16),
                M.cache_specs(cfg, shape.global_batch, shape.seq_len))
    else:
        args = (ins["params"], ins["cache"], ins["tokens"], ins["position"])
        outs = (specs_lib.sds((shape.global_batch, 1, cfg.vocab_size),
                              torch.bfloat16), ins["cache"])

    def tot(trees, shs):
        return sum(_spec_bytes({"x": t}, {"x": s}, sizes)
                   for t, s in zip(trees, shs))
    out = {"argument_size_in_bytes": tot(args, in_sh),
           "output_size_in_bytes": tot(outs, out_sh)}
    if shape.kind != "train":  # the KV/state cache the step holds
        out["cache_size_in_bytes"] = tot(outs[1:], out_sh[1:])
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


def moe_collectives(w: "_Wire", cfg, mesh, B: int, S: int, e: int, specs,
                    manual: bool, fwd: int, bwd: int) -> None:
    """Add one MoE layer's collectives (``moe.apply_moe(mesh=)`` on each
    data shard's B x S tokens in a dtype of ``e`` bytes, the experts laid
    out by ``specs``) to ``w``, ``fwd`` and ``bwd`` times."""
    st = sharding.AxisState.from_mesh(mesh)
    Mn = st.size(sharding.TP_AXIS)
    R = math.prod(st.size(a) for a in st.dp if st.size(a) > 1)
    E, d = cfg.moe.num_experts, cfg.d_model
    act = B * S * d * e

    def cut(spec):
        return sharding._cuts(spec, mesh)[0] is not None

    if manual:  # all-to-alls over ``data``, the experts' axis
        T = B * S
        C = moe_lib.capacity(cfg, T)
        ep = st.size("data")
        d_loc, E_loc = d // Mn, E // ep
        w.add("psum", Mn, T * E * 4, fwd, bwd)  # router logits, fp32
        w.add("all_to_all", ep, E_loc * C * ep * d_loc * e, 2 * fwd,
              2 * bwd)
        w.add("psum", Mn, 2 * E_loc * C * ep * cfg.d_ff * e, fwd, bwd)
        w.add("all_gather", Mn, act, fwd, bwd)
        w.add("psum", R * Mn, 4, fwd, bwd)  # aux, a 0-d fp32
    else:
        # The router statistics: mean probabilities (differentiable) and
        # top-1 fractions (not: no transpose).
        w.add("psum", R, E * 4, fwd, bwd)
        w.add("psum", R, E * 4, fwd, 0)
        if cut(specs["w_down"]):
            w.add("psum", Mn, act, fwd, bwd)
    if "shared" in specs and cut(specs["shared"]["w_down"]):
        w.add("psum", Mn, act, fwd, bwd)


def moe_layer_collectives(cfg, batch: int, seq: int, mesh,
                          dtype_bytes: int = 2) -> Dict[str, float]:
    """Global wire bytes, by kind, of one forward of ``moe.apply_moe``
    over ``mesh`` on each data shard's ``batch`` x ``seq`` tokens, the
    layer placed by ``sharding.train_specs`` (its router and shared
    expert gathered over the data axes beforehand, not counted)."""
    specs = sharding.train_specs(cfg, M.param_specs(cfg), mesh)
    w = _Wire(mesh.devices.size)
    moe_collectives(w, cfg, mesh, batch, seq, dtype_bytes,
                    specs["blocks"]["moe"],
                    moe_lib.expert_parallel(cfg, mesh, (batch, seq)), 1, 0)
    return dict(w.by_kind)


def train_collectives(cfg, batch: int, seq: int, mesh, params=None
                      ) -> Dict[str, float]:
    """Global wire bytes, by kind, of one ``make_train_step(mesh=)`` step
    of ``batch`` x ``seq`` tokens on ``params`` (default: the config's
    bf16 ``model.param_specs``) placed by ``sharding.train_specs`` on a
    mesh of ``mesh``'s axes (its devices are not used: a meta mesh of
    the production shape will do).  Kinds as ``Mesh.moved_bytes``
    counts them."""
    params = M.param_specs(cfg) if params is None else params
    sizes = mesh.shape
    st = sharding.AxisState.from_mesh(mesh)
    n = mesh.devices.size
    Mn = st.size(sharding.TP_AXIS)
    dp = tuple(a for a in st.dp if st.size(a) > 1)
    R = math.prod(st.size(a) for a in dp)
    if batch % R:
        raise NotImplementedError(f"batch {batch} does not divide {dp}")
    B = batch // R
    specs = sharding.train_specs(cfg, params, mesh)
    w = _Wire(n)
    e = params["embed"].element_size()  # the activations' dtype
    d = cfg.d_model

    def cuts(spec):
        """(model dim, rows, the axes the leaf is cut over)."""
        dim, rows = sharding._cuts(spec, mesh)
        axes = set(rows[0] if rows else ()) | ({sharding.TP_AXIS}
                                                if dim is not None else set())
        return dim, rows, axes

    # Gradient sums of pieces several places hold.
    for (path, leaf), (_, spec) in zip(tree_lib.flatten(params),
                                       tree_lib.flatten(specs)):
        axes = cuts(spec)[2]
        w.add("grad_sum", math.prod(s for a, s in sizes.items()
                                    if a not in axes),
              _nb(leaf) / math.prod(sizes[a] for a in axes))

    def gather_data(leaf, spec, fwd, bwd):
        dim, rows, _ = cuts(spec)
        if rows is not None:
            g = math.prod(sizes[a] for a in rows[0])
            w.add("all_gather", g, _nb(leaf) / (Mn if dim is not None
                                                 else 1), fwd, bwd)

    if cfg.family not in M.ATTENTION_FAMILIES:
        if Mn > 1:
            raise NotImplementedError("model > 1 covers the attention "
                                      "families")
        for (_, leaf), (_, spec) in zip(tree_lib.flatten(params),
                                        tree_lib.flatten(specs)):
            gather_data(leaf, spec, 1, 1)
        return dict(w.by_kind)

    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    total = prefix + seq
    mult = layers.Q_CHUNK if total >= layers.CHUNKED_ATTN_THRESHOLD else 1
    S_pad = -(-total // mult) * mult
    act = B * S_pad * d * e
    # Embedding (once), its vocab-parallel lookup's psum.
    gather_data(params["embed"], specs["embed"], 1, 1)
    if cuts(specs["embed"])[0] == 0:
        w.add("psum", Mn, B * seq * d * e)
    if cfg.family == "vlm":
        gather_data(params["patch_proj"], specs["patch_proj"], 1, 1)
        if cuts(specs["patch_proj"])[0] is not None:
            w.add("all_gather", Mn, B * prefix * d * e)
    # The layers: each gather and psum forward, again in the remat, and
    # its transpose once.
    heads_cut = sharding.attn_shard_size(mesh, cfg.num_kv_heads) > 1
    manual = cfg.moe is not None and moe_lib.expert_parallel(
        cfg, mesh, (B, S_pad))
    L = cfg.num_layers
    for (path, leaf), (_, spec) in zip(
            tree_lib.flatten(params["blocks"]),
            tree_lib.flatten(specs["blocks"])):
        keys = path.split("/")
        per = torch.empty(leaf.shape[1:], dtype=leaf.dtype, device="meta")
        lspec = sharding.P(*tuple(spec)[1:])
        if not (manual and keys[0] == "moe" and "shared" not in keys
                and keys[-1] in ("w_gate", "w_up", "w_down")):
            gather_data(per, lspec, 2 * L, L)
        if keys[0] == "attn" and not heads_cut and \
                cuts(lspec)[0] is not None:
            w.add("all_gather", Mn, _nb(per), 2 * L, L)
    blocks = specs["blocks"]
    if heads_cut and cuts(blocks["attn"]["wo"])[0] is not None:
        w.add("psum", Mn, act, 2 * L, L)
    if "mlp" in blocks and cuts(blocks["mlp"]["w_down"])[0] is not None:
        w.add("psum", Mn, act, 2 * L, L)
    if cfg.moe is not None:
        moe_collectives(w, cfg, mesh, B, S_pad, e, blocks["moe"], manual,
                        2 * L, L)
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
                       "step's cache bytes) from shardings_for's specs; "
                       "temp null: no buffer plan",
    "roofline": "core.roofline with the H100's constants (989 TFLOP/s "
                "bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a direction)",
}


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
        cost = measure(cfg, shape_name)
        mem = device_bytes(cfg, shape_name, mesh)
        mem.update(temp_size_in_bytes=None, alias_size_in_bytes=None,
                   generated_code_size_in_bytes=None)
        coll_d, wire_g = None, None
        basis = BASIS
        if shape.kind == "train" and cfg.family not in \
                M.ATTENTION_FAMILIES and mesh.shape.get("model", 1) > 1:
            basis = dict(BASIS, wire_bytes_global=(
                "null: the port trains the ssm, hybrid and audio "
                "families over data alone (model = 1)"))
        elif shape.kind == "train":
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
            basis=basis,
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
    ap.add_argument("--device", default=None,
                    help="[--serving-smoke] the device the mesh names: "
                         "the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.serving_smoke:
        rec = run_serving_smoke(out_dir, device=args.device)
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
