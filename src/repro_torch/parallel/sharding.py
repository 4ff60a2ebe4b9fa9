"""Sharding rules, and the placement and collectives of tensor-parallel
serving over a ``model`` mesh axis.

Port of ``repro.parallel.sharding``.  The rules part is a copy: the
parameter, cache and batch specs in both modes, ``sanitize_specs``, the
mesh-axis state (a ``ContextVar``, scoped by ``use_axes``) and the
paged-attention dispatch gate, with ``P`` standing in for jax's
``PartitionSpec`` and paths built as the reference's ``_path_str`` builds
them.  Baseline layout (the "paper-faithful" mapping — tensor
parallelism over ``model``, FSDP storage over ``data``, replication over
``pod``):

  * attention/MLP weights: 2-D sharded (fan-in over one axis, fan-out
    over the other), the 2-D weight-stationary layout the paper adopts
    for the feed-forward network;
  * MoE expert tensors: expert dim over ``data``, expert hidden dim over
    ``model``;
  * KV caches: batch over data axes, sequence over ``model``; the paged
    pool's KV-head axis over ``model``;
  * SSM states: batch over data axes, heads over ``model``.

Not ported: ``shard_map``, ``current_mesh``, ``mesh_context`` and the
``constrain*`` anchors.  The anchors are GSPMD placement hints that never
change a value (the reference calls them in its model, layers and MoE);
the port places tensors explicitly and has no ambient mesh context, so
with nothing set in the context the axis state is empty.

The placement part is the port's own: one controller drives m shards.

  * ``Sharded`` holds one contiguous tensor per model shard, each on its
    shard's device, cut along one dim (or whole on every shard), with
    the mesh;
  * ``shard`` / ``gather`` cut a tensor by its spec and put it back;
    ``place_serve`` cuts a parameter tree by ``param_specs(mode="serve")``
    (sanitized), keeping attention whole where the KV heads do not divide
    the axis (``attn_shard_size``);
  * ``smap`` runs a function on each shard's parts;
  * tensors move between shards only through ``psum`` (partials summed in
    shard order) and ``all_gather`` (concatenation); ``broadcast`` hands
    shard 0's scheduler inputs (tokens, positions, tables, lengths) to
    the others.  Each adds the bytes it moves between shards to its
    mesh's ``moved_bytes`` — counted whether or not two shards share a
    device, so the count is an m-device mesh's.

Without a mesh the same calls pass plain tensors through (``smap`` calls
its function once, ``psum`` / ``all_gather`` / ``broadcast`` / ``gather``
return their argument, ``cut_dim`` is None), so the model's paged layer
loops are one code path with and without a mesh.

Only ``data`` = 1 is placed: a spec that cuts a ``pod``/``data`` axis of
size above 1 raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import torch

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per dim — an axis name, a tuple of
    names, or None (not cut).  Immutable; equal to the tuple of its
    entries, normalised as jax's ``PartitionSpec`` normalises them (a
    one-name tuple is the name, an empty one None)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            (a[0] if len(a) == 1 else a or None) if isinstance(a, tuple)
            else a for a in axes))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


# ---------------------------------------------------------------------------
# Mesh-axis state (context-scoped, not process-global)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisState:
    """Immutable snapshot of a mesh's (axis name, size) pairs."""
    sizes: Tuple[Tuple[str, int], ...] = ()

    @classmethod
    def from_mesh(cls, mesh) -> "AxisState":
        if mesh is None:
            return cls()
        return cls(tuple(zip(mesh.axis_names, mesh.devices.shape)))

    def size(self, name: Optional[str]) -> int:
        return dict(self.sizes).get(name, 1) if name else 1

    @property
    def dp(self) -> Tuple[str, ...]:
        names = [a for a, _ in self.sizes]
        return tuple(a for a in ("pod", "data") if a in names)

    @property
    def tp(self) -> Optional[str]:
        return "model" if any(a == "model" for a, _ in self.sizes) else None


_AXIS_STATE: "contextvars.ContextVar[AxisState]" = \
    contextvars.ContextVar("mesh_axis_state", default=AxisState())


def axis_state() -> AxisState:
    """The axis state the rules read: what ``use_axes`` or
    ``set_mesh_axis_sizes`` set in this context, else empty."""
    return _AXIS_STATE.get()


def set_mesh_axis_sizes(mesh) -> None:
    """Set the axis state for the CURRENT context (scripts and tests;
    None clears it).  Engine code uses the scoped ``use_axes``."""
    _AXIS_STATE.set(AxisState.from_mesh(mesh))


@contextlib.contextmanager
def use_axes(state) -> Iterator[AxisState]:
    """Scope the axis state to a ``with`` block.  ``state`` is an
    AxisState or a mesh (None = explicitly no axes)."""
    if not isinstance(state, AxisState):
        state = AxisState.from_mesh(state)
    token = _AXIS_STATE.set(state)
    try:
        yield state
    finally:
        _AXIS_STATE.reset(token)


def axis_size(name: Optional[str]) -> int:
    return axis_state().size(name)


def data_axes() -> Tuple[str, ...]:
    """Batch-sharding axes ("pod"/"data") present in the active state."""
    return axis_state().dp


def tp_axis() -> Optional[str]:
    """The tensor-parallel axis ("model") if the active state has one."""
    return axis_state().tp


def _map_with_path(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path_str, leaf, *rest_leaves)`` over a dict tree, the path
    its keys joined by "/" as the reference's ``_path_str`` joins them.
    A ``P`` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(path), tree, *rest)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _param_rule(cfg: ModelConfig, path: str, ndim: int, mode: str,
                fsdp: str = "data", tp: str = "model") -> P:
    """Spec for one parameter given its path and rank.

    mode="train": FSDP (ZeRO-3) over ``data`` x TP over ``model``.
    mode="serve": weights resident, TP over ``model`` only, except MoE
    expert tensors (expert parallelism over ``data`` x TP over
    ``model``).  Rules name the trailing dims; leading stacked layer or
    group dims are padded with None.
    """
    serve = mode == "serve"
    fs = None if serve else fsdp

    def pad(*spec):
        return P(*([None] * (ndim - len(spec)) + list(spec)))

    leaf = path.rsplit("/", 1)[-1]
    tp_n = axis_size(tp)
    vocab_ok = cfg.vocab_size % tp_n == 0

    # Embedding / unembedding; d_model is cut where the vocab does not
    # divide the model axis.
    if leaf == "embed":
        if vocab_ok:
            return P(tp, fs)
        return P(None, tp if serve else fsdp)
    if leaf == "lm_head":
        if vocab_ok:
            return P(fs, tp)
        return P(tp if serve else fsdp, None)
    if leaf == "patch_proj":
        return P(fs, tp)

    # Norm scales/biases: replicated (small).
    if leaf in ("scale", "bias", "conv_b", "A_log", "D", "dt_bias"):
        return pad(None)
    if leaf == "norm_scale":
        return pad(tp)

    # Attention projections.
    if leaf in ("wq", "wk", "wv"):
        return pad(fs, tp)
    if leaf == "wo":
        return pad(tp, fs)
    if leaf in ("bq", "bk", "bv"):
        return pad(tp)

    # Dense / shared-expert MLP.
    if leaf in ("w_gate", "w_up", "w_down"):
        if "moe" in path and "shared" not in path:
            # Expert-stacked (..., E, d, f) or (..., E, f, d): experts over
            # ``data`` in both modes; TP cuts d_model where the expert
            # dim divides the data axis (the manual-collective layout),
            # else the hidden dim.
            ep_n = axis_size(fsdp)
            d_layout = cfg.moe is not None and ep_n > 1 \
                and cfg.moe.num_experts % ep_n == 0
            if d_layout:
                if leaf == "w_down":
                    return pad(fsdp, None, tp)
                return pad(fsdp, tp, None)
            if leaf == "w_down":
                return pad(fsdp, tp, None)
            return pad(fsdp, None, tp)
        if leaf == "w_down":
            return pad(tp, fs)
        return pad(fs, tp)
    if leaf == "router":
        return pad(fs, None)

    # Mamba2.
    if leaf == "in_proj":
        return pad(fs, tp)
    if leaf == "conv_w":
        return pad(None, tp)
    if leaf == "out_proj":
        return pad(tp, fs)

    return pad(None)


def param_specs(cfg: ModelConfig, params_shape, mode: str = "train") -> Any:
    """Spec tree matching params (or any tree of leaves with ``.shape``,
    e.g. ``model.param_specs``'s meta tensors)."""
    return _map_with_path(
        lambda path, leaf: _param_rule(cfg, path, len(leaf.shape), mode),
        params_shape)


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, cache_shape, dp: Optional[Tuple[str, ...]],
                batch: int, tp: str = "model", paged: bool = False) -> Any:
    """dp = batch axes (None to replicate small batches).

    paged: the k/v leaves are block pools (L, N, bs, Hk, hd): any table
    may point anywhere in the pool, so the pool is cut on its KV heads
    over ``model`` (the decode attention's TP layout), with the SCLAD
    scale leaves (L, N, bs, Hk) on the same axis.
    """
    dpa = dp if (dp and batch % _axes_size_hint(dp) == 0) else None

    def rule(path, leaf):
        nd = len(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            if paged:
                return P(None, None, None, tp, None)
            # (L, B, S, Hk, hd): batch over dp, sequence over model.
            return P(None, dpa, tp, None, None)
        if name in ("k_scale", "v_scale") and paged:
            return P(None, None, None, tp)
        if name == "state":
            # (..., B, H, P, N): heads over model.
            return P(*([None] * (nd - 4)), dpa, tp, None, None)
        if name == "conv":
            # (..., B, k-1, conv_dim): channels over model.
            return P(*([None] * (nd - 3)), dpa, None, tp)
        return P(*([None] * nd))

    return _map_with_path(rule, cache_shape)


def _axes_size_hint(axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= axis_size(a)
    return n


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, batch_shape, dp: Optional[Tuple[str, ...]],
                batch: int) -> Any:
    dpa = dp if (dp and batch % _axes_size_hint(dp) == 0) else None
    return _map_with_path(
        lambda path, leaf: P(dpa, *([None] * (len(leaf.shape) - 1))),
        batch_shape)


def sanitize_specs(spec_tree, shape_tree) -> Any:
    """Drop the cut on any dim the mesh axis does not divide evenly (60
    experts, a 50280 vocab, batch 1, ...)."""
    def fix(path, spec, leaf):
        dims = leaf.shape
        out = []
        for i, axes in enumerate(tuple(spec)
                                 + (None,) * (len(dims) - len(spec))):
            if axes is None:
                out.append(None)
                continue
            axes_t = axes if isinstance(axes, tuple) else (axes,)
            size = 1
            for a in axes_t:
                size *= axis_size(a)
            out.append(axes if dims[i] % size == 0 else None)
        return P(*out)

    return _map_with_path(fix, spec_tree, shape_tree)


#: The tensor-parallel mesh axis every serving-side rule cuts over.
TP_AXIS = "model"


def attn_shard_size(mesh, num_kv_heads: int, axis: str = TP_AXIS) -> int:
    """How many ways the paged attention dispatch cuts the KV-head axis:
    the ``axis`` size when it is above 1 and divides ``num_kv_heads``,
    else 1 (no mesh, no such axis, or heads that do not divide) — exactly
    where ``sanitize_specs`` keeps the pool's head cut, so placement and
    dispatch agree."""
    if mesh is None:
        return 1
    m = AxisState.from_mesh(mesh).size(axis)
    return m if m > 1 and num_kv_heads % m == 0 else 1


def paged_attn_specs(axis: str = TP_AXIS) -> Dict[str, P]:
    """Specs of the sharded paged-attention dispatch.  The head cut is
    contiguous, so a shard's Hk/m KV heads arrive with all ``rep = H //
    Hk`` of their query heads (queries are head-major): a shard runs the
    unchanged single-device kernel on its head slice.  ``out_chunk`` is
    the prefill output after its (B, S, H, D) -> (B, S, H*D) head-major
    flatten."""
    return {
        "q_decode": P(None, axis, None),        # (B, H, D) head groups
        "q_chunk": P(None, None, axis, None),   # (B, S, H, D)
        "new_kv": P(None, None, axis, None),    # (B, S, Hk, D) chunk K/V
        "pool": P(None, None, axis, None),      # (N, bs, Hk, D)
        "scale": P(None, None, axis),           # (N, bs, Hk) SCLAD scales
        "host": P(),                            # tables/lengths/starts
        "out_decode": P(None, axis, None),      # (B, H, D)
        "out_chunk": P(None, None, axis),       # (B, S, H*D) head-major
    }


# ---------------------------------------------------------------------------
# Placement: one tensor per model shard
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """One contiguous tensor per model shard of ``mesh``, shard i's on
    the mesh's i-th model device: the whole tensor cut into equal
    contiguous pieces along ``dim``, or, with ``dim`` None, the whole
    tensor on every shard (one object where shards share a device)."""
    parts: Tuple[torch.Tensor, ...]
    dim: Optional[int]
    mesh: Any

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.parts[0].shape)
        if self.dim is not None:
            s[self.dim] *= len(self.parts)
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """Shard 0's device."""
        return self.parts[0].device

    def __getitem__(self, i: int) -> "Sharded":
        """Index the leading dim (a layer of stacked leaves) of every
        part; it must not be the cut dim."""
        if not isinstance(i, int) or self.dim == 0:
            raise IndexError("a Sharded takes one int index on an uncut "
                             "leading dim")
        return Sharded(tuple(p[i] for p in self.parts),
                       None if self.dim is None else self.dim - 1, self.mesh)

    def distinct_parts(self) -> List[torch.Tensor]:
        """The parts, each object once (shards on one device share a
        replicated part)."""
        seen, out = set(), []
        for p in self.parts:
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out


def model_devices(mesh) -> List[torch.device]:
    """The model shards' devices, shard 0 first (``data`` index 0)."""
    return mesh.axis_devices(TP_AXIS)


def _cut_dim(spec: Sequence, mesh) -> Optional[int]:
    """The dim ``spec`` cuts over the model axis (None: no cut).  Axes of
    size 1 cut nothing; any other axis raises: only (data=1, model=m)
    meshes are placed."""
    st = AxisState.from_mesh(mesh)
    cut = None
    for i, axes in enumerate(spec):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is None or st.size(a) == 1:
                continue
            if a != TP_AXIS or cut is not None:
                raise NotImplementedError(
                    f"spec {spec} cuts axis {a!r} of size {st.size(a)}: "
                    f"only the model axis is placed")
            cut = i
    return cut


def _per_device(x: torch.Tensor, devices) -> Tuple[torch.Tensor, ...]:
    """x on each device, one object a device."""
    on: Dict[torch.device, torch.Tensor] = {}
    return tuple(on.setdefault(d, x.to(d)) for d in devices)


def shard(x: torch.Tensor, spec: Sequence, mesh) -> Sharded:
    """Place ``x`` by ``spec``: cut into contiguous equal parts along the
    model-axis dim, or whole on every shard.  Placement, not a
    collective: nothing is counted."""
    if isinstance(x, Sharded):
        return x
    devs = model_devices(mesh)
    dim = _cut_dim(spec, mesh)
    if dim is None or len(devs) == 1:
        return Sharded(_per_device(x, devs), None, mesh)
    if x.shape[dim] % len(devs):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {len(devs)} shards")
    parts = x.chunk(len(devs), dim)
    return Sharded(tuple(p.to(d).contiguous() for p, d in zip(parts, devs)),
                   dim, mesh)


def place_new(shape: Sequence[int], spec: Sequence, mesh,
              make: Callable[[Tuple[int, ...], torch.device], torch.Tensor]
              ) -> Sharded:
    """A new sharded tensor of global ``shape`` laid out by ``spec``, each
    part made by ``make(local_shape, device)`` (no global tensor is
    built)."""
    devs = model_devices(mesh)
    dim = _cut_dim(spec, mesh)
    if dim is None or len(devs) == 1:
        on: Dict[torch.device, torch.Tensor] = {}
        return Sharded(tuple(on.setdefault(d, make(tuple(shape), d))
                             for d in devs), None, mesh)
    local = list(shape)
    if local[dim] % len(devs):
        raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                         f"into {len(devs)} shards")
    local[dim] //= len(devs)
    return Sharded(tuple(make(tuple(local), d) for d in devs), dim, mesh)


def cut_dim(x) -> Optional[int]:
    """The dim a ``Sharded`` is cut along; None when it is whole on every
    shard or a plain tensor."""
    return x.dim if isinstance(x, Sharded) else None


def gather(s: Sharded) -> torch.Tensor:
    """The whole tensor on shard 0's device (an ``all_gather`` when it is
    cut)."""
    if not isinstance(s, Sharded):
        return s
    if s.dim is None:
        return s.parts[0]
    return all_gather(s).parts[0]


def _count(mesh, kind: str, nbytes: int) -> None:
    """Add ``nbytes`` moved between shards to ``mesh.moved_bytes[kind]``."""
    mesh.moved_bytes[kind] = mesh.moved_bytes.get(kind, 0) + nbytes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def psum(s: Sharded) -> Sharded:
    """The sum of the shards' partials, on every shard: shards 1.. send
    theirs to shard 0, which adds them in shard order, 0 first, and
    sends the sum back — 2 (m - 1) partials' bytes.  A plain tensor
    passes through."""
    if not isinstance(s, Sharded):
        return s
    m = len(s.parts)
    if m == 1:
        return Sharded(s.parts, None, s.mesh)
    dev0 = s.parts[0].device
    acc = s.parts[0]
    for p in s.parts[1:]:
        acc = acc + p.to(dev0)
    _count(s.mesh, "psum", 2 * (m - 1) * _nbytes(acc))
    return Sharded(_per_device(acc, model_devices(s.mesh)), None, s.mesh)


def all_gather(s: Sharded, dim: Optional[int] = None) -> Sharded:
    """The parts concatenated along ``dim`` (default: the cut dim), on
    every shard: each shard receives the m - 1 parts it lacks.  A plain
    tensor passes through."""
    if not isinstance(s, Sharded):
        return s
    dim = s.dim if dim is None else dim
    m = len(s.parts)
    if m == 1 or dim is None:
        return Sharded(s.parts, None, s.mesh)
    dev0 = s.parts[0].device
    full = torch.cat([p.to(dev0) for p in s.parts], dim)
    _count(s.mesh, "all_gather", (m - 1) * _nbytes(full))
    return Sharded(_per_device(full, model_devices(s.mesh)), None, s.mesh)


def broadcast(x, mesh) -> Sharded:
    """Shard 0's tensor on every shard: (m - 1) copies of its bytes.  A
    ``Sharded``, None, or any tensor without a mesh passes through."""
    if mesh is None or x is None or isinstance(x, Sharded):
        return x
    devs = model_devices(mesh)
    _count(mesh, "broadcast", (len(devs) - 1) * _nbytes(x))
    return Sharded(_per_device(x, devs), None, mesh)


def local(tree, i: int):
    """Shard i's view of ``tree``: its part of each ``Sharded``, dicts,
    tuples and lists walked, anything else as it is."""
    if isinstance(tree, Sharded):
        return tree.parts[i]
    if isinstance(tree, dict):
        return {k: local(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local(v, i) for v in tree)
    return tree


def smap(fn: Callable, *args, mesh, dim=None):
    """``fn`` on each shard's view of ``args`` (``local``), in shard
    order: a ``Sharded`` of the results cut along ``dim`` (None: equal on
    every shard), or a tuple of them when ``fn`` returns a tuple (``dim``
    then one for all, or a tuple of one each).  Without a mesh:
    ``fn(*args)``."""
    if mesh is None:
        return fn(*args)
    outs = [fn(*local(list(args), i)) for i in range(len(model_devices(mesh)))]
    if isinstance(outs[0], tuple):
        n = len(outs[0])
        dims = dim if isinstance(dim, tuple) else (dim,) * n
        return tuple(Sharded(tuple(o[j] for o in outs), dims[j], mesh)
                     for j in range(n))
    return Sharded(tuple(outs), dim, mesh)


#: The attention leaves kept whole on every shard when the KV heads do
#: not divide the model axis.
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def serve_specs(cfg: ModelConfig, params_shape, mesh) -> Any:
    """``param_specs(mode="serve")`` under ``mesh``'s axes, sanitized,
    with the attention leaves whole where ``attn_shard_size`` is 1: a
    shard computes whole heads, so the q/k/v columns cannot be cut
    mid-head as GSPMD may cut them."""
    with use_axes(mesh):
        specs = sanitize_specs(param_specs(cfg, params_shape, mode="serve"),
                               params_shape)
    if attn_shard_size(mesh, cfg.num_kv_heads) > 1:
        return specs
    return _map_with_path(
        lambda path, spec: P(*([None] * len(spec)))
        if path.rsplit("/", 1)[-1] in ATTN_LEAVES else spec, specs)


def place_serve(cfg: ModelConfig, params, mesh) -> Any:
    """The parameter tree cut by ``serve_specs``, leaf by leaf.  Leaves
    that are already ``Sharded`` on ``mesh`` are kept."""
    specs = serve_specs(cfg, params, mesh)

    def place(path, x, spec):
        if isinstance(x, Sharded):
            if x.mesh is not mesh:
                raise ValueError(f"{path}: placed on another mesh")
            return x
        return shard(x, spec, mesh)

    return _map_with_path(place, params, specs)


def shard_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config one shard's attention sees: H / a query and Hk / a KV
    heads, a = ``attn_shard_size``."""
    a = attn_shard_size(mesh, cfg.num_kv_heads)
    if a == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // a,
                               num_kv_heads=cfg.num_kv_heads // a)
