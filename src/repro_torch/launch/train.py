"""Training launcher.

Examples:
  # CPU smoke (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64

  # On the card, full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --batch 4 --seq 2048 --ckpt ckpts/tinyllama

Port of ``repro.launch.train``, on one device: the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import TrainConfig, TrainState, train


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"devices={torch.cuda.device_count()} ({device})")

    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq, global_batch=args.batch,
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, seed=args.seed,
        opt=opt_lib.AdamWConfig(lr=args.lr, total_steps=args.steps))
    state = train(cfg, tcfg, device=device)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
