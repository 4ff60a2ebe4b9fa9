"""Roofline terms of a step: compute, memory and collective time.

Port of ``repro.core.roofline`` (framework-free: the HLO text parsing is
kept as it is), with the card's constants in place of the reference's
TPU v5e ones.  Three terms per (arch x shape x mesh), all in seconds:

  compute    = FLOPs      / (chips * PEAK_FLOPS)
  memory     = bytes      / (chips * HBM_BW)
  collective = wire_bytes / (chips * LINK_BW)

``parse_collectives`` converts collective ops of an optimized HLO text to
ring-algorithm wire bytes (``_wire_factor``); the port's dry run counts
its FLOPs and bytes on ``meta`` tensors and its wire bytes analytically
(``launch.dryrun``), with the same ring factors.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM, 700 W power limit) —
989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and NVLink 4's 450 GB/s a
direction per GPU (18 links x 25 GB/s) for the link term.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PEAK_FLOPS = 989e12  # dense bf16 per H100 SXM
HBM_BW = 3.35e12  # bytes/s per H100 SXM (HBM3)
LINK_BW = 450e9  # bytes/s a direction per H100 SXM (NVLink 4: 18 x 25 GB/s)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_GROUP_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUP_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of an HLO shape string like 'bf16[128,4096]' or a tuple."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUP_V2_RE.search(line)
    if m:  # replica_groups=[num_groups,group_size]<=[...]
        return int(m.group(2))
    m = _GROUP_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


@dataclass
class CollectiveStats:
    # op -> [count, result_bytes_total, wire_bytes_global]
    by_op: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def wire_bytes(self) -> float:
        return sum(v[2] for v in self.by_op.values())


def _wire_factor(op: str, g: int) -> float:
    """Per-device ring wire bytes as a multiple of the *result* bytes."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g  # result is the gathered (big) buffer
    if op == "all-reduce":
        return 2 * (g - 1) / g  # reduce-scatter + all-gather of same size
    if op == "reduce-scatter":
        return g - 1  # result is the scattered (small) shard
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


def parse_collectives(hlo_text: str, total_devices: int) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        s = line.strip()
        # match "<name> = <shape> <op>(" — op may have -start/-done variants
        m = re.search(r"=\s+((?:\([^)]*\)|\S+))\s+(" + "|".join(_COLLECTIVES)
                      + r")(?:-start)?\(", s)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        rb = _shape_bytes(shape_str)
        if rb == 0:
            continue
        g = _group_size(s, default=total_devices)
        wire_per_dev = rb * _wire_factor(op, g)
        ent = stats.by_op.setdefault(op, [0, 0.0, 0.0])
        ent[0] += 1
        ent[1] += rb
        # every device participates in some group for this instruction
        ent[2] += wire_per_dev * total_devices
    return stats


@dataclass
class RooflineTerms:
    flops: float
    bytes_hbm: float
    wire_bytes: float
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "wire_bytes": self.wire_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def model_flops(param_count: int, tokens: int, train: bool) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for a forward/serve pass."""
    return (6.0 if train else 2.0) * param_count * tokens
