"""Sharding rules, and the placement and collectives of one controller
driving every place of a mesh: serving over (``data``, ``model``) —
tensor-parallel over ``model``, lanes over the data axes — and training
over (``pod``, ``data``, ``model``).

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

The placement part is the port's own: one controller drives every place
of the mesh grid (its devices in row-major order; a mesh may name one
device several times).

  * ``Sharded`` holds one contiguous tensor per place: the whole tensor
    cut along at most one dim over ``model`` and one dim over other axes
    (the data axes: FSDP storage, expert parallelism, the batch; or a
    pipeline's ``stage``), whole over the rest; the ``model`` cut either
    contiguous or by components (``Components``: a Mamba-2 leaf's packed
    columns, each component cut on its own or held whole), beside a cut
    over the data axes on another dim or not;
  * ``shard`` / ``place_like`` / ``gather`` / ``to_whole`` cut a tensor
    by its spec and put it back; ``place_serve`` cuts a parameter tree by
    ``param_specs(mode="serve")`` (sanitized, attention whole where the
    KV heads do not divide the axis, the Mamba-2 leaves by
    ``mamba_spec``), ``wave_cache_specs`` places the wave path's caches,
    ``place_train`` by ``train_placement`` (``param_specs(mode="train")``
    sanitized, the Mamba-2 leaves cut over ``model`` as ``mamba_spec``
    cuts them beside the rule's cut over ``data``), ``place_batch`` a
    batch over the data axes (whole on every data place where it does
    not divide them, as ``sanitize_specs`` keeps it);
  * ``smap`` runs a function on each place's parts (a place without
    lanes, whose parts ``scatter`` left None, runs nothing);
  * serving over the data axes (the last section): ``split_rows`` cuts a
    batch by the lanes its rows serve, ``scatter`` hands each place its
    rows, ``gather_rows`` brings results back in batch order and
    ``gather_writes`` copies the pool rows each place wrote to the other
    data replicas; ``call_rows`` / ``dispatch_groups`` give the MoE the
    reference's dispatch groups of a call;
  * tensors move between places only through the collectives, each over
    an axis (a name or a tuple of names): ``psum`` (partials summed in
    member order), ``all_gather`` (concatenation), ``all_to_all``,
    ``ppermute``, and ``broadcast`` (place 0's scheduler inputs to every
    place).  Each adds the bytes it moves to its mesh's ``moved_bytes``
    under its kind — counted whether or not two places share a device,
    so the count is a mesh of distinct devices'.  Under autograd each is
    a ``torch.autograd.Function`` whose backward is its transpose,
    counted under ``kind + "/bwd"``: psum's is the members' cotangents
    summed and handed to every member (a broadcast of the sum),
    all_gather's the reduce-scatter (FSDP's gradient reduction),
    all_to_all's and ppermute's the reverse move;
  * a piece several places hold is one autograd leaf a place in the
    train step (``member_leaves``), its gradients summed explicitly
    (``sum_replicas``, "grad_sum"), never silently by a shared object —
    the components a ``Components`` cut holds whole on every model
    shard included (``sum_components``).

Without a mesh the same calls pass plain tensors through (``smap`` calls
its function once, the collectives and ``gather`` return their argument,
``cut_dim`` is None), so the model's layer loops — the paged serving
loop and the full-sequence forward of the attention families — are one
code path with and without a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
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


#: A dim's consecutive components: (length, cut over ``model``) each.
Comps = Tuple[Tuple[int, bool], ...]


class Components(P):
    """The port's own spec for a dim of packed components (a Mamba-2
    leaf's [z | x B C | dt] columns), which a contiguous cut would split
    off head boundaries: ``ndim`` dims, ``dim`` over ``model``, cut
    component by component (``comps``) — shard j holds piece j of every
    cut component and the whole of every other, concatenated in order —
    and, with ``rows`` = (axes, dim), another dim cut contiguously over
    the data axes (FSDP storage).  Equal, as a tuple, to the plain spec
    that names ``model`` at ``dim`` (and ``axes`` at the rows' dim)."""

    def __new__(cls, ndim: int, dim: int, comps: Comps, rows=None):
        entries = [TP_AXIS if i == dim else None for i in range(ndim)]
        if rows is not None:
            if rows[1] == dim:
                raise ValueError(f"Components: rows {rows} on the model "
                                 f"dim {dim}")
            entries[rows[1]] = rows[0]
        self = super().__new__(cls, *entries)
        self.comps = tuple(comps)
        return self

    def __repr__(self) -> str:
        return f"Components({tuple.__repr__(self)}, {self.comps})"


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
# Placement: one tensor per place of the mesh grid
# ---------------------------------------------------------------------------


def _axes_tuple(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, tuple) else (axes,)


def grid_devices(mesh) -> List[torch.device]:
    """Every place's device, in the mesh's row-major order (the last
    axis, ``model``, varies fastest)."""
    return list(mesh.devices.flat)


def axes_size(mesh, axes) -> int:
    """The product of ``axes``' sizes on ``mesh`` (1 for an axis it
    lacks)."""
    st = AxisState.from_mesh(mesh)
    return math.prod(st.size(a) for a in _axes_tuple(axes))


def axis_index(mesh, axes) -> Tuple[int, ...]:
    """Each place's index along ``axes`` (a name or a tuple of names,
    major first): the twin of ``lax.axis_index``."""
    return _axis_index(mesh.devices.shape, tuple(mesh.axis_names),
                       _axes_tuple(axes))


def groups(mesh, axes) -> Tuple[Tuple[int, ...], ...]:
    """The places that differ only along ``axes``: one tuple a group, in
    index order along ``axes``; the groups in order of their first
    place."""
    return _groups(mesh.devices.shape, tuple(mesh.axis_names),
                   _axes_tuple(axes))


# Pure functions of a mesh's shape and axis names, cached: every
# collective asks for its groups.
@functools.lru_cache(maxsize=256)
def _axis_index(shape, names, axes) -> Tuple[int, ...]:
    coords = np.unravel_index(np.arange(math.prod(shape)), shape)
    idx = np.zeros(math.prod(shape), dtype=np.int64)
    for a in axes:
        if a in names:
            i = names.index(a)
            idx = idx * shape[i] + coords[i]
    return tuple(idx.tolist())


@functools.lru_cache(maxsize=256)
def _groups(shape, names, axes) -> Tuple[Tuple[int, ...], ...]:
    n = math.prod(shape)
    coords = np.unravel_index(np.arange(n), shape)
    other = [i for i, a in enumerate(names) if a not in axes]
    along = _axis_index(shape, names, axes)
    out: Dict[tuple, List[int]] = {}
    for k in range(n):
        out.setdefault(tuple(int(coords[i][k]) for i in other), []).append(k)
    return tuple(sorted((tuple(sorted(g, key=along.__getitem__))
                         for g in out.values()), key=lambda g: g[0]))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """One contiguous tensor per place of ``mesh``'s grid (its devices in
    row-major order): the whole tensor cut into equal contiguous pieces
    along ``dim`` over the ``model`` axis and along ``rows[1]`` over the
    axes ``rows[0]`` (the data axes — FSDP storage, expert parallelism,
    the batch — or a pipeline's stage axis), whole over every other
    axis.  Places holding the same piece on one device share one object.
    On a (data=1, model=m) mesh it is one part per model shard.
    ``comps``: the ``model`` cut is by components (``Components``), not
    contiguous (a Mamba-2 leaf; its ``rows`` cut, if any, on another
    dim)."""
    parts: Tuple[torch.Tensor, ...]
    dim: Optional[int]
    mesh: Any
    rows: Optional[Tuple[Tuple[str, ...], int]] = None
    comps: Optional[Comps] = None

    @property
    def _ref(self) -> torch.Tensor:
        """The first part a place holds (a place without lanes holds
        None)."""
        return next(p for p in self.parts if p is not None)

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self._ref.shape)
        if self.comps is not None:
            s[self.dim] = sum(n for n, _ in self.comps)
        elif self.dim is not None:
            s[self.dim] *= axes_size(self.mesh, TP_AXIS)
        if self.rows is not None:
            s[self.rows[1]] *= axes_size(self.mesh, self.rows[0])
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self._ref.dtype

    @property
    def device(self) -> torch.device:
        """Place 0's device."""
        return self.mesh.devices.flat[0]

    def with_parts(self, parts) -> "Sharded":
        """The same placement holding ``parts``."""
        return Sharded(tuple(parts), self.dim, self.mesh, self.rows,
                       self.comps)

    def _shifted(self, parts, dims: int) -> "Sharded":
        shift = (lambda d: None if d is None else d - dims)
        return Sharded(tuple(parts), shift(self.dim), self.mesh,
                       None if self.rows is None
                       else (self.rows[0], shift(self.rows[1])),
                       self.comps)

    def __getitem__(self, i) -> "Sharded":
        """Index the leading dims (a layer of stacked leaves; a tuple of
        ints indexes several) of every part; they must not be cut."""
        idx = i if isinstance(i, tuple) else (i,)
        cut = [d for d in (self.dim, self.rows and self.rows[1])
               if d is not None]
        if not idx or not all(isinstance(k, int) for k in idx) \
                or any(d < len(idx) for d in cut):
            raise IndexError("a Sharded takes int indices on uncut leading "
                             "dims")
        return self._shifted([p[idx] for p in self.parts], len(idx))

    def unbind(self) -> List["Sharded"]:
        """``__getitem__`` of every index of the leading dim, one
        ``unbind`` a part (autograd stacks their gradients in one pass)."""
        if 0 in (self.dim, self.rows and self.rows[1]):
            raise IndexError("unbind of a cut leading dim")
        per = [torch.unbind(p, 0) for p in self.parts]
        return [self._shifted([u[i] for u in per], 1)
                for i in range(len(per[0]))]

    def distinct_parts(self) -> List[torch.Tensor]:
        """The parts, each object once (places on one device share a
        replicated part)."""
        seen, out = set(), []
        for p in self.parts:
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes of size above 1 along which every place holds
        the same piece."""
        cut = set(self.rows[0] if self.rows else ())
        if self.dim is not None:
            cut.add(TP_AXIS)
        st = AxisState.from_mesh(self.mesh)
        return tuple(a for a in self.mesh.axis_names
                     if a not in cut and st.size(a) > 1)

    def replica_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The places holding each distinct piece, one list a piece."""
        return groups(self.mesh, self.replicated_axes())


def model_devices(mesh) -> List[torch.device]:
    """The model shards' devices, shard 0 first (index 0 of every other
    axis)."""
    return mesh.axis_devices(TP_AXIS)


def _cuts(spec: Sequence, mesh):
    """(dim cut over ``model``, (axes, dim) cut over other axes) of
    ``spec`` on ``mesh``; axes of size 1 cut nothing.  One dim a role:
    a spec naming ``model`` with another axis in one entry, or two
    non-model entries, raises."""
    st = AxisState.from_mesh(mesh)
    dim, rows = None, None
    for i, axes in enumerate(spec):
        names = tuple(a for a in _axes_tuple(axes) if st.size(a) > 1)
        if not names:
            continue
        if TP_AXIS in names:
            if len(names) > 1 or dim is not None:
                raise NotImplementedError(
                    f"spec {spec}: the model axis cuts one dim alone")
            dim = i
        elif rows is not None:
            raise NotImplementedError(
                f"spec {spec} cuts two dims over non-model axes")
        else:
            rows = (names, i)
    return dim, rows


def _spec_cuts(spec: Sequence, mesh):
    """``_cuts`` of ``spec`` and its components (None unless a
    ``Components`` spec cuts over ``model`` here)."""
    dim, rows = _cuts(spec, mesh)
    comps = getattr(spec, "comps", None) if dim is not None else None
    return dim, rows, comps


def _local_lengths(comps: Comps, m: int) -> List[int]:
    """Each component's length in one of m shards' parts."""
    for n, cut in comps:
        if cut and n % m:
            raise ValueError(f"component of {n} does not divide into {m} "
                             f"pieces")
    return [n // m if cut else n for n, cut in comps]


def _pieces(mesh, dim, rows, shape, comps=None
            ) -> Tuple[List[Tuple[int, int]], Tuple[int, ...]]:
    """Each place's (model piece, row piece) and the local shape."""
    n = mesh.devices.size
    local = list(shape)
    for d, axes in ((dim, TP_AXIS), (rows and rows[1], rows and rows[0])):
        if d is None:
            continue
        k = axes_size(mesh, axes)
        if d == dim and comps is not None:
            if sum(c for c, _ in comps) != local[d]:
                raise ValueError(f"components {comps} of dim {d} of "
                                 f"{tuple(shape)}")
            local[d] = sum(_local_lengths(comps, k))
            continue
        if local[d] % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {k} pieces")
        local[d] //= k
    mi = axis_index(mesh, TP_AXIS) if dim is not None else [0] * n
    ri = axis_index(mesh, rows[0]) if rows else [0] * n
    return list(zip(mi, ri)), tuple(local)


def _component_piece(x: torch.Tensor, dim: int, j: int, m: int,
                     comps: Comps) -> torch.Tensor:
    """Model shard j's part of ``x`` cut by ``comps`` along ``dim``: piece
    j of each cut component, the whole of each other, in order."""
    out, at = [], 0
    for (n, cut), k in zip(comps, _local_lengths(comps, m)):
        out.append(x.narrow(dim, at + (j * k if cut else 0), k))
        at += n
    return _cat(out, dim)


def _place(x: torch.Tensor, dim, rows, mesh, comps=None) -> Sharded:
    pieces, local = _pieces(mesh, dim, rows, x.shape, comps)
    m = axes_size(mesh, TP_AXIS)
    made: Dict[tuple, torch.Tensor] = {}
    parts = []
    for (j, r), dev in zip(pieces, grid_devices(mesh)):
        key = (j, r, dev)
        if key not in made:
            p = x
            if comps is not None:
                p = _component_piece(p, dim, j, m, comps)
            elif dim is not None:
                p = p.narrow(dim, j * local[dim], local[dim])
            if rows is not None:
                p = p.narrow(rows[1], r * local[rows[1]], local[rows[1]])
            made[key] = p.to(dev).contiguous() if p is not x else p.to(dev)
        parts.append(made[key])
    return Sharded(tuple(parts), dim, mesh, rows, comps)


def shard(x: torch.Tensor, spec: Sequence, mesh) -> Sharded:
    """Place ``x`` by ``spec``: cut into contiguous equal pieces along the
    dim ``spec`` cuts over ``model`` (component by component for a
    ``Components`` spec) and the dim it cuts over other axes, whole
    elsewhere.  Placement, not a collective: nothing is counted."""
    if isinstance(x, Sharded):
        return x
    dim, rows, comps = _spec_cuts(spec, mesh)
    return _place(x, dim, rows, mesh, comps)


def place_like(x: torch.Tensor, like: Sharded) -> Sharded:
    """``x`` placed as ``like`` is (its mesh and cuts)."""
    return _place(x, like.dim, like.rows, like.mesh, like.comps)


def place_new(shape: Sequence[int], spec: Sequence, mesh,
              make: Callable[[Tuple[int, ...], torch.device], torch.Tensor],
              data_replicas: bool = False) -> Sharded:
    """A new sharded tensor of global ``shape`` laid out by ``spec``, each
    part made by ``make(local_shape, device)`` (no global tensor is
    built).  ``data_replicas``: every data index holds its own part even
    where ``spec`` leaves the data axes whole (the paged pool, which each
    data place writes and ``gather_writes`` keeps equal), rather than one
    part a device."""
    dim, rows, comps = _spec_cuts(spec, mesh)
    pieces, local = _pieces(mesh, dim, rows, shape, comps)
    di = axis_index(mesh, AxisState.from_mesh(mesh).dp) if data_replicas \
        else [0] * mesh.devices.size
    made: Dict[tuple, torch.Tensor] = {}
    parts = []
    for (j, r), i, dev in zip(pieces, di, grid_devices(mesh)):
        if (j, r, i, dev) not in made:
            made[j, r, i, dev] = make(local, dev)
        parts.append(made[j, r, i, dev])
    return Sharded(tuple(parts), dim, mesh, rows, comps)


def cut_dim(x) -> Optional[int]:
    """The dim a ``Sharded`` is cut along over ``model``; None when it is
    whole over it or a plain tensor."""
    return x.dim if isinstance(x, Sharded) else None


def gather(s: Sharded) -> torch.Tensor:
    """The whole tensor on place 0's device (``all_gather``s over the
    axes it is cut along; of a component cut, the cut components' bytes
    as an all_gather moves them, assembled as ``to_whole`` does)."""
    if not isinstance(s, Sharded):
        return s
    if s.rows is not None:
        s = all_gather(s, axis=s.rows[0])
    if s.comps is not None:
        m = axes_size(s.mesh, TP_AXIS)
        row = _nbytes(s.parts[0]) // s.parts[0].shape[s.dim]
        _count(s.mesh, "all_gather", (m - 1) * row * sum(
            n for n, cut in s.comps if cut))
        return to_whole(s)
    if s.dim is not None:
        s = all_gather(s)
    return s.parts[0]


def _cat(ts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat``, on the bytes of float8 parts (an f8 pool's): not
    every PyTorch build concatenates float8 tensors on every device."""
    if ts[0].dtype != torch.float8_e4m3fn:
        return torch.cat(ts, dim)
    return torch.cat([t.view(torch.uint8) for t in ts], dim) \
        .view(torch.float8_e4m3fn)


def to_whole(s) -> torch.Tensor:
    """The whole tensor on place 0's device, assembled from the pieces
    without a collective (nothing counted, no autograd): a host fetch,
    as a checkpoint takes it."""
    if not isinstance(s, Sharded):
        return s
    pieces, _ = _pieces(s.mesh, s.dim, s.rows, s.shape, s.comps)
    dev0 = s.parts[0].device
    held = {pc: s.parts[k].detach() for k, pc in reversed(
        list(enumerate(pieces)))}
    m = axes_size(s.mesh, TP_AXIS) if s.dim is not None else 1

    def across(i):  # row piece i, whole over ``model``
        if s.comps is not None:
            split = [torch.split(held[j, i].to(dev0),
                                 _local_lengths(s.comps, m), s.dim)
                     for j in range(m)]
            return _cat([_cat([sp[c] for sp in split], s.dim) if cut
                         else split[0][c]
                         for c, (_, cut) in enumerate(s.comps)], s.dim)
        if m > 1:
            return _cat([held[j, i].to(dev0) for j in range(m)], s.dim)
        return held[0, i].to(dev0)

    r = axes_size(s.mesh, s.rows[0]) if s.rows else 1
    by_row = [across(i) for i in range(r)]
    return _cat(by_row, s.rows[1]) if r > 1 else by_row[0]


def _count(mesh, kind: str, nbytes: int) -> None:
    """Add ``nbytes`` moved between places to ``mesh.moved_bytes[kind]``."""
    mesh.moved_bytes[kind] = mesh.moved_bytes.get(kind, 0) + nbytes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Collectives: autograd-aware, counted per kind, "/bwd" for the transpose
# ---------------------------------------------------------------------------


class _Collective(torch.autograd.Function):
    """A collective over a grid's parts: ``op.fwd`` on the parts, its
    transpose ``op.bwd`` on their cotangents.  Every output is its own
    tensor (a shared one is cloned), so each place's consumers give it
    their own cotangent and the transpose sums them explicitly."""

    @staticmethod
    def forward(ctx, op, *parts):
        ctx.op = op
        seen = {id(p) for p in parts}
        outs = []
        for o in op.fwd(list(parts)):
            if id(o) in seen:
                o = o.clone()
            seen.add(id(o))
            outs.append(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.op.bwd(list(grads)))


def _run(op, parts) -> Tuple[torch.Tensor, ...]:
    """``op`` through autograd where a part needs a gradient, else
    directly (the serving path: outputs then shared per device, a place
    without lanes (``scatter``) None in and out)."""
    if torch.is_grad_enabled() and any(p is not None and p.requires_grad
                                       for p in parts):
        return _Collective.apply(op, *parts)
    return tuple(op.fwd(list(parts)))


class _Op:
    def __init__(self, mesh, grps, kind):
        self.mesh, self.grps, self.kind = mesh, grps, kind
        self.devs = grid_devices(mesh)

    def _spread(self, out, g, value):
        on: Dict[torch.device, torch.Tensor] = {}
        for k in g:
            out[k] = on.setdefault(self.devs[k], value.to(self.devs[k]))


class _Sum(_Op):
    """psum: each group's parts summed on its first place in group order,
    the sum on every member (2 (g - 1) parts' bytes: in to one place and
    back out).  The transpose is the same sum of the members' cotangents
    (the output is one value every member holds), handed to every
    member's part: a broadcast of the summed cotangent."""

    def _sum(self, xs, kind):
        out = [None] * len(xs)
        for g in self.grps:
            if xs[g[0]] is None:  # a data index without lanes
                continue
            dev0 = xs[g[0]].device
            acc = xs[g[0]]
            for k in g[1:]:
                acc = acc + xs[k].to(dev0)
            _count(self.mesh, kind, 2 * (len(g) - 1) * _nbytes(acc))
            self._spread(out, g, acc)
        return out

    def fwd(self, xs):
        return self._sum(xs, self.kind)

    def bwd(self, gs):
        return self._sum(gs, self.kind + "/bwd")


class _Gather(_Op):
    """all_gather along ``dim``: each member receives the g - 1 parts it
    lacks ((g - 1) x the gathered bytes a group).  The transpose is a
    reduce-scatter: the members' cotangents summed and cut back."""

    def __init__(self, mesh, grps, kind, dim):
        super().__init__(mesh, grps, kind)
        self.dim = dim

    def fwd(self, xs):
        out = [None] * len(xs)
        for g in self.grps:
            if xs[g[0]] is None:  # a data index without lanes
                continue
            dev0 = xs[g[0]].device
            full = _cat([xs[k].to(dev0) for k in g], self.dim)
            _count(self.mesh, self.kind, (len(g) - 1) * _nbytes(full))
            self._spread(out, g, full)
        return out

    def bwd(self, gs):
        out = [None] * len(gs)
        for g in self.grps:
            dev0 = gs[g[0]].device
            acc = gs[g[0]]
            for k in g[1:]:
                acc = acc + gs[k].to(dev0)
            _count(self.mesh, self.kind + "/bwd",
                   (len(g) - 1) * _nbytes(acc))
            for k, piece in zip(g, acc.chunk(len(g), self.dim)):
                out[k] = piece.to(self.devs[k])
        return out


class _AllToAll(_Op):
    """all_to_all: member r cuts its part into g pieces along
    ``split_dim`` and sends piece s to member s, which concatenates what
    it receives in member order along ``concat_dim``; the pieces that
    change place are counted.  The transpose is the all_to_all the
    other way."""

    def __init__(self, mesh, grps, kind, split_dim, concat_dim):
        super().__init__(mesh, grps, kind)
        self.split, self.concat = split_dim, concat_dim

    def _a2a(self, xs, split, concat, kind):
        out = [None] * len(xs)
        for g in self.grps:
            n = len(g)
            pieces = [xs[k].chunk(n, split) for k in g]
            moved = 0
            for s, ks in enumerate(g):
                dev = self.devs[ks]
                out[ks] = torch.cat([pieces[r][s].to(dev) for r in range(n)],
                                    concat)
                moved += sum(_nbytes(pieces[r][s]) for r in range(n)
                             if r != s)
            _count(self.mesh, kind, moved)
        return out

    def fwd(self, xs):
        return self._a2a(xs, self.split, self.concat, self.kind)

    def bwd(self, gs):
        return self._a2a(gs, self.concat, self.split, self.kind + "/bwd")


class _Permute(_Op):
    """ppermute: member ``dst`` receives member ``src``'s part for each
    (src, dst) pair of ``perm`` (indices along the axis); a member no
    pair names receives zeros.  Parts that change member are counted.
    The transpose sends each cotangent back along its pair."""

    def __init__(self, mesh, grps, kind, perm):
        super().__init__(mesh, grps, kind)
        self.perm = tuple(perm)

    def _move(self, xs, pairs, kind):
        out = [None] * len(xs)
        moved = 0
        for g in self.grps:
            for src, dst in pairs:
                out[g[dst]] = xs[g[src]].to(self.devs[g[dst]])
                moved += _nbytes(xs[g[src]]) if src != dst else 0
        _count(self.mesh, kind, moved)
        return [torch.zeros_like(x) if o is None else o
                for o, x in zip(out, xs)]

    def fwd(self, xs):
        return self._move(xs, self.perm, self.kind)

    def bwd(self, gs):
        return self._move(gs, [(d, s) for s, d in self.perm],
                          self.kind + "/bwd")


def _groups_of(s: Sharded, axis):
    """The groups of ``s``'s mesh over ``axis``, or None when every group
    has one member (the collective is the identity)."""
    grps = groups(s.mesh, axis)
    return None if len(grps[0]) == 1 else grps


def _drop(s: Sharded, axis, parts) -> Sharded:
    """``parts`` with ``s``'s cut over ``axis`` removed (its components
    kept while its ``model`` cut is)."""
    axes = set(_axes_tuple(axis))
    dim = None if TP_AXIS in axes else s.dim
    rows = s.rows if s.rows is None or not axes & set(s.rows[0]) else None
    return Sharded(tuple(parts), dim, s.mesh, rows,
                   s.comps if dim is not None else None)


def psum(s: Sharded, axis=TP_AXIS) -> Sharded:
    """The sum of the members' partials over ``axis`` (a name or a tuple
    of names), on every member: shards 1.. of each group send theirs to
    the group's first, which adds them in member order, 0 first, and
    sends the sum back — 2 (g - 1) partials' bytes a group ("psum"; the
    backward "psum/bwd").  A plain tensor passes through."""
    if not isinstance(s, Sharded):
        return s
    grps = _groups_of(s, axis)
    if grps is None:
        return _drop(s, axis, s.parts)
    return _drop(s, axis, _run(_Sum(s.mesh, grps, "psum"), s.parts))


def all_gather(s: Sharded, dim: Optional[int] = None,
               axis=TP_AXIS) -> Sharded:
    """The members' parts over ``axis`` concatenated along ``dim``
    (default: the dim ``s`` is cut along over ``axis``), on every member:
    each receives the g - 1 parts it lacks.  The backward is the
    reduce-scatter of the cotangents ("all_gather/bwd").  A component cut
    gathers over the data axes only (its FSDP dim; the components stay
    cut).  A plain tensor passes through."""
    if not isinstance(s, Sharded):
        return s
    axes = _axes_tuple(axis)
    if s.comps is not None and TP_AXIS in axes:
        raise NotImplementedError("all_gather of a component cut over "
                                  "model: read it with gather")
    if dim is None:
        dim = s.dim if axes == (TP_AXIS,) else (
            s.rows[1] if s.rows and set(s.rows[0]) <= set(axes) else None)
    grps = _groups_of(s, axis)
    if grps is None or dim is None:
        return _drop(s, axis, s.parts)
    return _drop(s, axis, _run(_Gather(s.mesh, grps, "all_gather", dim),
                               s.parts))


def all_to_all(s: Sharded, axis, split_dim: int, concat_dim: int
               ) -> Sharded:
    """``lax.all_to_all(tiled=True)`` over ``axis``: each member's part
    cut into g pieces along ``split_dim``, piece s to member s,
    concatenated in member order along ``concat_dim``.  The result keeps
    ``s``'s placement record (the caller knows what it holds)."""
    grps = _groups_of(s, axis)
    if grps is None:
        return s
    return s.with_parts(_run(_AllToAll(s.mesh, grps, "all_to_all",
                                       split_dim, concat_dim), s.parts))


def ppermute(s: Sharded, axis: str, perm) -> Sharded:
    """``lax.ppermute`` over ``axis``: for each (src, dst) of ``perm``
    member dst receives member src's part; members no pair names get
    zeros."""
    grps = _groups_of(s, axis)
    if grps is None:
        return s
    return s.with_parts(_run(_Permute(s.mesh, grps, "ppermute", perm),
                             s.parts))


def broadcast(x, mesh) -> Sharded:
    """Place 0's tensor on every place: (n - 1) copies of its bytes.  A
    ``Sharded``, None, or any tensor without a mesh passes through."""
    if mesh is None or x is None or isinstance(x, Sharded):
        return x
    devs = grid_devices(mesh)
    _count(mesh, "broadcast", (len(devs) - 1) * _nbytes(x))
    on: Dict[torch.device, torch.Tensor] = {}
    return Sharded(tuple(on.setdefault(d, x.to(d)) for d in devs), None,
                   mesh)


def sum_replicas(s: Sharded) -> Sharded:
    """Each piece's per-place gradients summed over the places that hold
    that piece (``Sharded.replica_groups``), the sum on every one of them
    ("grad_sum": an all-reduce, 2 (g - 1) pieces' bytes a group), after
    ``sum_components``.  The train step's explicit sum for replicated
    leaves: each place's leaf is its own autograd leaf, so none is
    summed silently."""
    if not isinstance(s, Sharded):
        return s
    s = sum_components(s)
    axes = s.replicated_axes()
    if not axes:
        return s
    op = _Sum(s.mesh, groups(s.mesh, axes), "grad_sum")
    return s.with_parts(op.fwd(list(s.parts)))


def sum_components(s: Sharded) -> Sharded:
    """Of a ``Components`` cut, the components every model shard holds
    whole (a Mamba-2 leaf's B and C columns): each shard's heads give
    them a partial gradient, summed here over ``model`` and handed to
    every member ("grad_sum", 2 (m - 1) times those columns' bytes a
    group); the cut components are left as they are.  Anything else
    passes through."""
    if not isinstance(s, Sharded) or s.comps is None:
        return s
    grps = _groups_of(s, TP_AXIS)
    whole = [c for c, (_, cut) in enumerate(s.comps) if not cut]
    if grps is None or not whole:
        return s
    lens = _local_lengths(s.comps, len(grps[0]))
    devs = grid_devices(s.mesh)
    out = list(s.parts)
    for g in grps:
        split = [torch.split(s.parts[k], lens, s.dim) for k in g]
        dev0 = s.parts[g[0]].device
        sums = {}
        for c in whole:
            acc = split[0][c]
            for sp in split[1:]:
                acc = acc + sp[c].to(dev0)
            _count(s.mesh, "grad_sum", 2 * (len(g) - 1) * _nbytes(acc))
            sums[c] = acc
        for i, k in enumerate(g):
            out[k] = _cat([sums[c].to(devs[k]) if c in sums else split[i][c]
                           for c in range(len(s.comps))], s.dim)
    return s.with_parts(out)


def elements(x) -> List[torch.Tensor]:
    """Tensors holding each element of ``x`` once: its distinct pieces
    (``pieces``), except that of a ``Components`` cut the components
    every model shard holds whole are taken from model shard 0's pieces
    only (a global norm's terms)."""
    if not isinstance(x, Sharded) or x.comps is None:
        return pieces(x)
    mi = axis_index(x.mesh, TP_AXIS)
    lens = _local_lengths(x.comps, axes_size(x.mesh, TP_AXIS))
    out = []
    for g in x.replica_groups():
        p = x.parts[g[0]]
        if mi[g[0]] == 0:
            out.append(p)
        else:
            out += [t for t, (_, cut) in zip(torch.split(p, lens, x.dim),
                                             x.comps) if cut]
    return out


def local_shape(shape: Sequence[int], spec: Sequence, mesh
                ) -> Tuple[int, ...]:
    """The shape of one place's part of a tensor of ``shape`` placed by
    ``spec`` on ``mesh`` (component cuts included)."""
    dim, rows, comps = _spec_cuts(spec, mesh)
    return _pieces(mesh, dim, rows, tuple(shape), comps)[1]


def map_pieces(fn: Callable, *xs):
    """``fn`` once for each distinct piece of the like-placed ``xs`` (the
    parts of each replica group's first place), its result placed on
    every place of the group, one object a device: a ``Sharded`` — a
    tuple of them when ``fn`` returns a tuple.  Plain tensors:
    ``fn(*xs)``."""
    s = xs[0]
    if not isinstance(s, Sharded):
        return fn(*xs)
    devs = grid_devices(s.mesh)
    outs: Optional[List[list]] = None
    for g in s.replica_groups():
        res = fn(*(x.parts[g[0]] for x in xs))
        tup = res if isinstance(res, tuple) else (res,)
        if outs is None:
            outs = [[None] * len(devs) for _ in tup]
        for o, r in zip(outs, tup):
            on: Dict[torch.device, torch.Tensor] = {}
            for k in g:
                o[k] = on.setdefault(devs[k], r.to(devs[k]))
    placed = tuple(s.with_parts(o) for o in outs)
    return placed if isinstance(res, tuple) else placed[0]


def pieces(x) -> List[torch.Tensor]:
    """Each distinct piece of ``x`` once (one part a replica group); a
    plain tensor is its one piece."""
    if not isinstance(x, Sharded):
        return [x]
    return [x.parts[g[0]] for g in x.replica_groups()]


def local(tree, i: int):
    """Place i's view of ``tree``: its part of each ``Sharded``, dicts,
    tuples and lists walked, anything else as it is."""
    if isinstance(tree, Sharded):
        return tree.parts[i]
    if isinstance(tree, dict):
        return {k: local(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local(v, i) for v in tree)
    return tree


def _absent(args, i: int) -> bool:
    """Whether place i holds no rows of the batch: a ``Sharded`` argument
    whose part there is None (``scatter`` gives a data place without
    lanes none)."""
    return any(isinstance(a, Sharded) and a.parts[i] is None for a in args)


def smap(fn: Callable, *args, mesh, dim=None, rows=False):
    """``fn`` on each place's view of ``args`` (``local``), in place
    order: a ``Sharded`` of the results cut along ``dim`` over ``model``
    (None: whole), or a tuple of them when ``fn`` returns a tuple
    (``dim`` then one for all, or a tuple of one each).  ``rows``: ``fn``
    keeps dim 0 as the rows of the one cut of dim 0 among ``args``
    (``Sharded.rows``), and the results are cut alike; else they carry no
    ``rows`` cut.  A place without rows (``_absent``) runs nothing and
    its results are None.  Without a mesh: ``fn(*args)``."""
    if mesh is None:
        return fn(*args)
    cut = None
    if rows:
        cuts = {a.rows for a in args
                if isinstance(a, Sharded) and a.rows and a.rows[1] == 0}
        if len(cuts) != 1:
            raise ValueError("smap(rows=True) needs one cut of dim 0 among "
                             f"its arguments, not {len(cuts)}")
        cut = cuts.pop()
    outs = [None if _absent(args, i) else fn(*local(list(args), i))
            for i in range(mesh.devices.size)]
    ref = next(o for o in outs if o is not None)
    if isinstance(ref, tuple):
        n = len(ref)
        dims = dim if isinstance(dim, tuple) else (dim,) * n
        return tuple(Sharded(tuple(None if o is None else o[j]
                                   for o in outs), dims[j], mesh, cut)
                     for j in range(n))
    return Sharded(tuple(outs), dim, mesh, cut)


def global_batch(x, mesh) -> int:
    """The global batch (dim 0) of an activation ``x`` on ``mesh``: its
    ``shape[0]``, which for a ``Sharded`` is the whole tensor's (cut on
    dim 0 by ``rows``, or whole over the data axes).  An ``smap`` result
    on a batch cut over the data axes, made without ``rows=True``, is
    neither: each data place holds its own rows.  Raises where the
    placement shows that (data places on one device holding distinct
    parts: places holding one piece on one device share one object)."""
    if isinstance(x, Sharded) and x.rows is None and data_size(mesh) > 1:
        for g in groups(mesh, AxisState.from_mesh(mesh).dp):
            held = {(mesh.devices.flat[i], id(x.parts[i])) for i in g}
            if len(held) > len({dev for dev, _ in held}):
                raise ValueError(
                    "cannot read the global batch of a Sharded whose data "
                    "places hold distinct parts (an smap result made "
                    "without rows=True): pass the call's rows")
    return x.shape[0]


def member_leaves(tree):
    """A tree of ``Sharded`` leaves with every part turned into an
    autograd leaf, one a place (``detach`` views: no copy), so that a
    piece several places hold gets one gradient per place."""
    if isinstance(tree, dict):
        return {k: member_leaves(v) for k, v in tree.items()}
    return tree.with_parts([p.detach().requires_grad_(True)
                            for p in tree.parts])


#: The attention leaves kept whole on every shard when the KV heads do
#: not divide the model axis.
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def serve_specs(cfg: ModelConfig, params_shape, mesh) -> Any:
    """``param_specs(mode="serve")`` under ``mesh``'s axes, sanitized,
    with the attention leaves whole where ``attn_shard_size`` is 1: a
    shard computes whole heads, so the q/k/v columns cannot be cut
    mid-head as GSPMD may cut them.  The Mamba-2 leaves take
    ``mamba_spec`` (head-aligned, by component), not the rule's
    contiguous cut.  Every leaf is whole over the data axes (the
    weights resident on every data place) but the routed experts, which
    keep the rule's expert parallelism: where the experts divide the
    data axes, ``w_gate`` / ``w_up`` (E, d, f) cut on E over ``data``
    and on d over ``model``, ``w_down`` (E, f, d) on E and d (a place
    holds its E / d experts' d / m slice); else whole over data and cut
    on f over ``model``.  The router and the shared expert are whole
    over data."""
    with use_axes(mesh):
        specs = sanitize_specs(param_specs(cfg, params_shape, mode="serve"),
                               params_shape)
    attn_whole = attn_shard_size(mesh, cfg.num_kv_heads) == 1

    def fix(path, spec, leaf):
        keys = path.split("/")
        if "mamba" in keys:
            return mamba_spec(cfg, mesh, keys[-1], len(leaf.shape))
        if attn_whole and keys[-1] in ATTN_LEAVES:
            return P(*([None] * len(spec)))
        return spec

    return _map_with_path(fix, specs, params_shape)


# ---------------------------------------------------------------------------
# Mamba-2 leaves and the wave caches: the port's placement
#
# The rules above cut ``in_proj`` (d, [z | x B C | dt]) and the conv
# leaves contiguously over ``model``, which GSPMD computes correctly
# whatever the cut; a per-shard body cannot: at mamba2-1.3b's widths
# shard 0 of 2 would hold all of z and 160 columns of x.  The port cuts
# them head-aligned, by component (the Mamba-2 paper's TP recipe): z, x
# and dt by the shard's heads, B and C (ngroups x state, one group in
# both configs) whole on every shard.  The dense wave stripes are cut on
# their KV heads, as the paged pool is, where the rule cuts the sequence
# (GSPMD may; a per-shard body would need a cross-shard log-sum-exp).
# ---------------------------------------------------------------------------

def mamba_shard_size(mesh, cfg: ModelConfig) -> int:
    """How many ways the Mamba-2 blocks are cut on their heads: the
    ``model`` axis size when it is above 1 and divides the heads of a
    one-group block (every shard's heads then share the whole B and C);
    else 1 (the blocks whole on every shard)."""
    if mesh is None or cfg.ssm is None:
        return 1
    m = AxisState.from_mesh(mesh).size(TP_AXIS)
    ok = cfg.ssm.nheads(cfg.d_model) % m == 0 and cfg.ssm.ngroups == 1
    return m if m > 1 and ok else 1


def mamba_components(cfg: ModelConfig, leaf: str) -> Comps:
    """The components of a Mamba-2 leaf's last dim: ``in_proj``'s [z | x
    | B | C | dt], the conv channels' [x | B | C] (``conv_w``,
    ``conv_b``, the ``conv`` window); z, x and dt cut by heads, B and C
    whole."""
    s = cfg.ssm
    di, H = s.d_inner(cfg.d_model), s.nheads(cfg.d_model)
    gn = s.ngroups * s.state_size
    xbc = ((di, True), (gn, False), (gn, False))
    return ((di, True),) + xbc + ((H, True),) if leaf == "in_proj" else xbc


def mamba_spec(cfg: ModelConfig, mesh, leaf: str, ndim: int) -> P:
    """A Mamba-2 leaf's serving spec (stacked leading dims whole): where
    ``mamba_shard_size`` is 1 whole; else ``in_proj`` and the conv
    leaves by ``mamba_components``, ``A_log`` / ``D`` / ``dt_bias`` and
    ``norm_scale`` (contiguous over d_inner = H x P, head-major) on their
    last dim, ``out_proj`` on its rows."""
    m = mamba_shard_size(mesh, cfg)
    lead = [None] * (ndim - 1)
    if m == 1:
        return P(*lead, None)
    if leaf in ("in_proj", "conv_w", "conv_b"):
        return Components(ndim, ndim - 1, mamba_components(cfg, leaf))
    if leaf == "out_proj":
        return P(*lead[:-1], TP_AXIS, None)
    return P(*lead, TP_AXIS)


#: The wave caches' leaves holding K/V stripes (..., B, S, Hk, D).
STRIPE_LEAVES = ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v")


def wave_cache_specs(cfg: ModelConfig, cache_shape, mesh) -> Any:
    """Specs of the wave path's dense caches (``model.init_cache``) over
    ``mesh``: over ``model`` the K/V stripes (..., B, S, Hk, D) cut on
    Hk where ``attn_shard_size`` is above 1 — the paged pool's cut, not
    ``cache_specs``' sequence cut; the Mamba-2 ``state`` (..., B, H, P,
    N) on its heads and the ``conv`` window (..., B, k - 1, channels) by
    ``mamba_components`` where ``mamba_shard_size`` is; whole elsewhere.
    Over the data axes, every leaf cut on its batch dim B where they
    divide it (``cache_specs``' ``dpa``; ``split_rows`` cuts the rows
    alike), else whole."""
    attn = attn_shard_size(mesh, cfg.num_kv_heads) > 1
    m = mamba_shard_size(mesh, cfg)
    d = data_size(mesh)
    dp = AxisState.from_mesh(mesh).dp

    def rule(path, leaf):
        nd, name = len(leaf.shape), path.rsplit("/", 1)[-1]
        bdim = nd - 3 if name == "conv" else nd - 4
        rows = (dp, bdim) if d > 1 and leaf.shape[bdim] % d == 0 else None
        cut = None
        if name in STRIPE_LEAVES and attn:
            cut = nd - 2
        elif name == "state" and m > 1:
            cut = nd - 3
        elif name == "conv" and m > 1:
            return Components(nd, nd - 1, mamba_components(cfg, name), rows)
        return P(*(TP_AXIS if i == cut else rows[0] if rows and i == rows[1]
                   else None for i in range(nd)))

    return _map_with_path(rule, cache_shape)


def place_serve(cfg: ModelConfig, params, mesh) -> Any:
    """The parameter tree cut by ``serve_specs``, leaf by leaf.  Leaves
    that are already ``Sharded`` on ``mesh`` are kept."""
    return place(params, serve_specs(cfg, params, mesh), mesh)


def train_specs(cfg: ModelConfig, params_shape, mesh) -> Any:
    """``param_specs(mode="train")`` under ``mesh``'s axes, sanitized:
    FSDP over ``data`` x TP over ``model`` (``steps.shardings_for``'s
    parameter specs)."""
    with use_axes(mesh):
        return sanitize_specs(param_specs(cfg, params_shape, mode="train"),
                              params_shape)


def place(tree, specs, mesh) -> Any:
    """``tree`` cut leaf by leaf by the same-shaped ``specs``; leaves
    already ``Sharded`` on ``mesh`` are kept."""
    def one(path, x, spec):
        if isinstance(x, Sharded):
            if x.mesh is not mesh:
                raise ValueError(f"{path}: placed on another mesh")
            return x
        return shard(x, spec, mesh)

    return _map_with_path(one, tree, specs)


def train_placement(cfg: ModelConfig, params_shape, mesh) -> Any:
    """The specs ``place_train`` cuts by: ``train_specs``, except the
    Mamba-2 leaves, which take ``mamba_spec``'s head-aligned cut over
    ``model`` (z, x and dt of ``in_proj`` and the conv leaves by heads, B
    and C whole on every shard; ``A_log`` / ``D`` / ``dt_bias`` /
    ``norm_scale`` on their heads; ``out_proj`` on its rows; whole where
    ``mamba_shard_size`` is 1) beside the rule's cut over the data axes
    (``in_proj``'s rows, ``out_proj``'s columns: FSDP storage), as
    ``serve_specs`` departs from the serving rule.  ``train_specs`` (the
    reference's, ``steps.shardings_for``'s) is left as it is."""
    specs = train_specs(cfg, params_shape, mesh)

    def fix(path, spec, leaf):
        keys = path.split("/")
        if "mamba" not in keys:
            return spec
        nd = len(leaf.shape)
        data = [None if TP_AXIS in _axes_tuple(a) else a for a in spec]
        data += [None] * (nd - len(data))
        ms = mamba_spec(cfg, mesh, keys[-1], nd)
        cut = [i for i, a in enumerate(ms) if a is not None]
        if any(data[i] is not None for i in cut):
            raise ValueError(f"{path}: {spec} and {ms} cut one dim")
        if isinstance(ms, Components):
            rows = [(a, i) for i, a in enumerate(data) if a is not None]
            return Components(nd, cut[0], ms.comps,
                              rows[0] if rows else None)
        return P(*(a if a is not None else b for a, b in zip(ms, data)))

    return _map_with_path(fix, specs, params_shape)


def place_train(cfg: ModelConfig, params, mesh) -> Any:
    """The parameter tree cut by ``train_placement``, leaf by leaf (the
    twin of ``place_serve`` for the sharded train step)."""
    return place(params, train_placement(cfg, params, mesh), mesh)


def place_batch(cfg: ModelConfig, batch, mesh) -> Any:
    """A training batch placed by the reference's specs (``batch_specs``,
    ``sanitize_specs``): every leaf cut on its leading (batch) dim over
    the data axes where the batch divides them (each data shard its own
    rows), else whole on every data place (each computes every row);
    whole over ``model``.  ``train_rows`` describes the placement."""
    with use_axes(mesh):
        B = next(iter(batch.values())).shape[0]
        specs = sanitize_specs(batch_specs(cfg, batch, data_axes(), B),
                               batch)
    return place(batch, specs, mesh)


def shard_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config one shard's attention sees: H / a query and Hk / a KV
    heads, a = ``attn_shard_size``."""
    a = attn_shard_size(mesh, cfg.num_kv_heads)
    if a == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // a,
                               num_kv_heads=cfg.num_kv_heads // a)


# ---------------------------------------------------------------------------
# Serving over the data axes: lanes cut by their slot, the paged pool
# replicated with each place's writes gathered
#
# The reference places serving activations batch-first over the data axes
# (``cache_specs``' ``dpa``, ``constrain_tokens``) when the batch divides
# them, else keeps them whole (``sanitize_specs``); weights and the paged
# pool are whole over data.  The port cuts a batch by the lanes its rows
# serve: lane s of ``width`` belongs to data index s // (width / d), so a
# lane stays on one data place from its first chunk to its last decode
# step.  Each (data, model) place computes its own lanes on its model
# shard's heads; a place with no lanes in a call runs nothing (its parts
# are None).  Every data place holds its own replica of the pool, which
# its K1 reads and its K2 or decode store writes; ``gather_writes`` copies
# the rows each place wrote to the other replicas of its model shard, so
# a lane may read a block another data place wrote (a shared prefix, a
# recompute after preemption).  The routed experts are cut on E over data
# where E divides it (the serve rule's expert parallelism); the MoE
# dispatches in the reference's groups of the call's rows
# (``CallRows``, ``dispatch_groups``), which need not be the places'.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lanes:
    """The lanes a batch's rows serve: row j is lane ``slots[j]`` of
    ``width`` (an engine's slots, or a wave's rows).  ``all_lanes``: the
    reference runs this call over all ``width`` lanes in slot order, the
    lanes not in ``slots`` as empty rows (the speculative verify pass),
    where the port runs only ``slots``; else the reference's batch is
    these rows in this order (a prefill cohort)."""
    slots: Tuple[int, ...]
    width: int
    all_lanes: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class RowSplit:
    """Which rows of an ``n``-row batch each data index of ``mesh``
    holds, in batch order: ``rows[i]`` those of data index i (empty: that
    data index runs nothing)."""
    mesh: Any
    rows: Tuple[Tuple[int, ...], ...]
    n: int

    def data_index(self) -> Tuple[int, ...]:
        """Each place's index over the data axes."""
        return axis_index(self.mesh, AxisState.from_mesh(self.mesh).dp)

    def firsts(self) -> Dict[int, int]:
        """Data index -> its model shard 0's place."""
        mi = axis_index(self.mesh, TP_AXIS)
        out: Dict[int, int] = {}
        for k, i in enumerate(self.data_index()):
            if mi[k] == 0:
                out.setdefault(i, k)
        return out


def data_size(mesh) -> int:
    """The product of ``mesh``'s data axes (1 without a mesh)."""
    if mesh is None:
        return 1
    return axes_size(mesh, AxisState.from_mesh(mesh).dp)


def split_rows(mesh, lanes: Optional[Lanes], n: int) -> Optional[RowSplit]:
    """The data axes' cut of an ``n``-row batch whose rows serve
    ``lanes`` (default: row j is lane j of n): lane s to data index
    s // (width / d).  None — every data place holds every row, as
    ``sanitize_specs`` keeps a batch whole — without a mesh, with one
    data index, or where the lanes' width does not divide the data
    axes."""
    d = data_size(mesh)
    if d == 1:
        return None
    lanes = lanes or Lanes(tuple(range(n)), n)
    if len(lanes.slots) != n:
        raise ValueError(f"{len(lanes.slots)} lanes for {n} rows")
    if lanes.width % d:
        return None
    per = lanes.width // d
    return RowSplit(mesh, tuple(
        tuple(j for j, s in enumerate(lanes.slots) if s // per == i)
        for i in range(d)), n)


@dataclasses.dataclass(frozen=True, eq=False)
class CallRows:
    """A call's rows as the reference's batch holds them: row j of the
    call is row ``at[j]`` of the reference's ``size``-row batch, whose
    other rows are empty (pads that route nowhere); ``split`` is the
    data axes' cut of the call (``split_rows``; None: every data place
    holds every row).  The MoE's dispatch groups are formed on this
    batch (``dispatch_groups``).  ``train``: a training batch
    (``train_rows``), whose MoE also forms its load-balancing loss and
    takes the manual path where the reference does; else a serving
    call (``call_rows``)."""
    at: Tuple[int, ...]
    size: int
    split: Optional[RowSplit] = None
    train: bool = False

    @property
    def n(self) -> int:
        return len(self.at)

    @property
    def identity(self) -> bool:
        """Whether the call's rows are the reference's batch as it is."""
        return self.size == self.n and self.at == tuple(range(self.n))


def call_rows(lanes: Optional[Lanes], n: int,
              split: Optional[RowSplit] = None) -> CallRows:
    """The ``CallRows`` of an ``n``-row call serving ``lanes``: the
    reference's batch is the call's rows unless ``lanes.all_lanes``, where
    it is every lane of ``lanes.width`` in slot order."""
    if lanes is None or not lanes.all_lanes:
        return CallRows(tuple(range(n)), n, split)
    return CallRows(tuple(lanes.slots), lanes.width, split)


def train_rows(mesh, batch: int) -> CallRows:
    """A training batch of ``batch`` rows as ``place_batch`` places it:
    cut contiguously over the data axes where they divide it (row j on
    data index j // (batch / d), ``split_rows``' cut), else whole on
    every data place (``split`` None)."""
    return CallRows(tuple(range(batch)), batch,
                    split_rows(mesh, None, batch), train=True)


@dataclasses.dataclass(frozen=True)
class Groups:
    """A call's MoE dispatch groups: ``count`` groups of ``per``
    consecutive rows of the reference's batch; ``of[j]`` / ``pos[j]``
    the group of the call's row j and its row within the group."""
    count: int
    per: int
    of: Tuple[int, ...]
    pos: Tuple[int, ...]


def dispatch_groups(rows: CallRows, d: int) -> Groups:
    """The reference's dispatch groups of a call (``moe._num_groups``)
    over d data places: d groups where d divides the reference's batch,
    else one; group g the batch's rows [g size / G, (g + 1) size / G),
    whatever lanes they serve and whichever data place holds them.  Each
    group has its own capacity and its own FIFO slot order."""
    G = d if rows.size % d == 0 else 1
    per = rows.size // G
    return Groups(G, per, tuple(a // per for a in rows.at),
                  tuple(a % per for a in rows.at))


def groups_on_places(rows: CallRows, groups: Groups) -> bool:
    """Whether every data place's rows of the call lie in the group of
    its data index (one group a place: each can form its group's slots
    alone) — a decode step, a wave, a verify pass, a cohort so laid
    out."""
    split = rows.split
    return split is not None and groups.count == len(split.rows) and all(
        groups.of[j] == i for i, r in enumerate(split.rows) for j in r)


def scatter(x, mesh, split: Optional[RowSplit]) -> Sharded:
    """Place 0's batch-first scheduler input on every place: each place
    its data index's rows (``split``; None where it holds none), counted
    as the bytes every place but place 0 receives ("scatter").  Without a
    split: ``broadcast``.  None and a ``Sharded`` pass through."""
    if split is None or x is None or isinstance(x, Sharded):
        return broadcast(x, mesh)
    made: Dict[tuple, torch.Tensor] = {}
    parts, moved = [], 0
    for k, (i, dev) in enumerate(zip(split.data_index(),
                                     grid_devices(mesh))):
        rows = split.rows[i]
        if not rows:
            parts.append(None)
            continue
        if (i, dev) not in made:
            idx = torch.tensor(rows, dtype=torch.long, device=x.device)
            made[i, dev] = x.index_select(0, idx).to(dev)
        parts.append(made[i, dev])
        moved += _nbytes(made[i, dev]) if k else 0
    _count(mesh, "scatter", moved)
    return Sharded(tuple(parts), None, mesh)


def gather_rows(s: Sharded, split: Optional[RowSplit]) -> torch.Tensor:
    """A batch-first result back in batch order on place 0's device, each
    data index's rows from its model shard 0 (the logits, whole over
    ``model``): the bytes of every data index but place 0's counted
    ("row_gather").  Without a split: place 0's part."""
    if split is None:
        return s.parts[0]
    dev0 = grid_devices(s.mesh)[0]
    ref = next(p for p in s.parts if p is not None)
    out = torch.empty((split.n,) + tuple(ref.shape[1:]), dtype=ref.dtype,
                      device=dev0)
    moved = 0
    for i, k in sorted(split.firsts().items()):
        rows = split.rows[i]
        if not rows:
            continue
        p = s.parts[k]
        out[torch.tensor(rows, dtype=torch.long, device=dev0)] = p.to(dev0)
        moved += _nbytes(p) if k else 0
    _count(s.mesh, "row_gather", moved)
    return out


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its uint8 view when it holds float8 (indexing float8
    tensors is not on every PyTorch build's every device)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_writes(leaves: Sequence[Sharded], split: RowSplit,
                  written: Sequence[Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]]]) -> None:
    """After a call that wrote pool rows, copy them to the other data
    replicas: ``written[i]`` the (block, offset) index tensors of the
    rows data index i's places wrote (None: none), ``leaves`` the pool's
    payload and scale leaves (L, N, bs, ...), whose parts are one replica
    a data index (``place_new(data_replicas=True)``).  Every place
    receives, from each other data index, that index's rows of its own
    model shard's piece (all layers): the bytes counted a receiving place
    ("pool_gather").  No two data places write one live row in a call
    (copy-on-write owns a written block); the trash block is left out of
    ``written`` — each replica's own sink."""
    mesh = split.mesh
    di, mi = split.data_index(), axis_index(mesh, TP_AXIS)
    src_of = {}
    for k in reversed(range(mesh.devices.size)):
        src_of[di[k], mi[k]] = k
    moved = 0
    for leaf in leaves:
        done = set()
        for k, dst in enumerate(leaf.parts):
            for i, idx in enumerate(written):
                if idx is None or i == di[k]:
                    continue
                src = leaf.parts[src_of[i, mi[k]]]
                row = math.prod(src.shape[3:]) * src.element_size()
                moved += src.shape[0] * idx[0].numel() * row
                if (id(dst), i) in done:
                    continue
                done.add((id(dst), i))
                blk, off = (t.to(src.device) for t in idx)
                rows = _bytes_of(src)[:, blk, off].to(dst.device)
                _bytes_of(dst)[:, blk.to(dst.device), off.to(dst.device)] = \
                    rows
    _count(mesh, "pool_gather", moved)
