"""SCLD (store-as-compressed, load-as-dense) end to end.

    PYTHONPATH=src python -m repro_torch.examples.sclad_sparsity [--device cpu]

1. Block-compresses a weight matrix at several sparsities.
2. Applies it through ``SCLDLinear``: the CUDA kernel on the card (the
   default), the plain PyTorch version with ``--device cpu``.
3. Reports the storage/bandwidth savings and the analytic TCO/token effect
   on an OPT-175B-class model (paper Fig 13).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import hardware, perf, sparsity
from repro_torch.core.workloads import PAPER_MODELS
from repro_torch.device import resolve_device
from repro_torch.kernels.sclad_matmul.ops import SCLDLinear
from repro_torch.kernels.sclad_matmul.ref import sclad_matmul_ref

UNITS = (16, 8, 6)
SPARSITIES = (0.0, 0.3, 0.5, 0.6, 0.7)


def system_lines() -> list:
    """The system section: TCO/token vs weight sparsity on a gpt3-175b
    workload, and the largest model that fits at 60% sparsity."""
    wl = PAPER_MODELS["gpt3-175b"]
    chip = hardware.ChipConfig(die_mm2=140, sram_mb=226, tflops=5.5)
    server = hardware.ServerConfig(chip=chip, chips_per_lane=17)
    base = perf.best_mapping(server, wl, ctx=2048).tco_per_mtoken
    lines = []
    for s in SPARSITIES:
        wls = dataclasses.replace(
            wl, weight_storage_factor=sparsity.storage_factor(s))
        dp = perf.best_mapping(server, wls, ctx=2048)
        ppl = sparsity.OPT175B_PERPLEXITY.get(s)
        lines.append(f"  sparsity={s:.1f} tco_delta="
                     f"{100 * (dp.tco_per_mtoken - base) / base:+5.1f}% "
                     f"perplexity={ppl}")
    lines.append(f"  max model scale at 60%: "
                 f"{sparsity.max_model_scale(0.6):.2f}x")
    return lines


def main(argv=None) -> dict:
    """Run both sections and print them; returns {"kernel": {units:
    (SCLDLinear's output, the plain version's)}, "system": [lines]}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    w = rng.standard_normal((512, 512)).astype(np.float32)
    x = torch.from_numpy(
        rng.standard_normal((128, 512)).astype(np.float32)).to(dev)

    print("== kernel: block-SCLD matmul ==")
    kernel = {}
    for units in UNITS:
        lin = SCLDLinear.from_dense(w, units_kept=units, device=dev)
        y = lin(x)
        ref = sclad_matmul_ref(x, lin.vals, lin.rows)
        err = float((y - ref).abs().max())
        dense_b = w.size * 2
        stored_b = lin.vals.numel() * 2 + lin.rows.numel() * 4
        print(f"  units={units:2d} sparsity={lin.sparsity:.2f} "
              f"traffic={stored_b / dense_b:.2f}x dense  max_err={err:.2e}")
        kernel[units] = (y, ref)

    print("== system: TCO/token vs sparsity (OPT-175B-class, Fig 13) ==")
    lines = system_lines()
    for line in lines:
        print(line)
    return {"kernel": kernel, "system": lines}


if __name__ == "__main__":
    main()
