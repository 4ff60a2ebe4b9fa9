"""Run the paper's two-phase co-design search end to end (Table 2 style).

    PYTHONPATH=src python -m repro_torch.examples.codesign_search --model gpt3-175b
    PYTHONPATH=src python -m repro_torch.examples.codesign_search --arch phi3-medium-14b

Phase 1 enumerates ~1.3k feasible chip/server designs under the Table 1
constraints; phase 2 searches TP/PP/batch/micro-batch mappings per design
with the analytic inference simulator and ranks by TCO per token.  The same
engine accepts the port's architectures (``repro_torch.configs``) through
the workload adapter.  Host-side analytics (``core.explore``): nothing is
launched on a device.  A twin of the reference package's
``examples/codesign_search.py``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import explore
from repro_torch.core.workloads import PAPER_MODELS, from_model_config


def main(argv=None) -> dict:
    """Print the workload, the phase-1 count and the TCO/token-optimal
    design's table row; returns the row."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    choices=sorted(PAPER_MODELS))
    ap.add_argument("--arch", default=None,
                    help="one of the port's architectures instead")
    ap.add_argument("--ctx", type=int, default=2048)
    args = ap.parse_args(argv)

    if args.arch:
        from repro_torch.configs.base import get_config
        wl = from_model_config(get_config(args.arch))
    else:
        wl = PAPER_MODELS[args.model or "gpt3-175b"]

    print(f"workload: {wl.name}  params={wl.params:.3g} "
          f"(active {wl.active:.3g})  kv/tok={wl.kv_bytes_per_token()/1e3:.0f}KB")
    servers = explore.phase1_servers()
    print(f"phase 1: {len(servers)} feasible server designs")
    res = explore.explore(wl, ctx=args.ctx, servers=servers, keep_all=False)
    row = res.best.table_row()
    print("phase 2 TCO/token-optimal design:")
    for k, v in row.items():
        print(f"  {k:18s} {v}")
    return row


if __name__ == "__main__":
    main()
