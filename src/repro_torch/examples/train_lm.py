"""End-to-end training example.

    # CPU demo:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset smoke \
        --device cpu

    # ~100M-parameter run on the card, a few hundred steps:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m

Twin of ``examples/train_lm.py`` on the port: the restartable synthetic
data stream, the autograd train step, AdamW and async atomic
checkpoints, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import get_config
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import TrainConfig, TrainState, train


def preset_config(name: str):
    base = get_config("tinyllama-1.1b")
    if name == "smoke":
        return base.reduced(), dict(steps=30, seq_len=64, global_batch=4)
    if name == "100m":
        cfg = dataclasses.replace(
            base, name="tinyllama-100m", num_layers=8, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_000)
        return cfg, dict(steps=300, seq_len=512, global_batch=32)
    raise ValueError(name)


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default="checkpoints/train_lm",
                    help="checkpoint directory (relative to the working "
                         "directory)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, defaults = preset_config(args.preset)
    if args.steps:
        defaults["steps"] = args.steps
    print(f"training {cfg.name}: {cfg.param_count():,} params, "
          f"{defaults['steps']} steps")
    tcfg = TrainConfig(ckpt_dir=args.ckpt, ckpt_every=50, log_every=10,
                       opt=opt_lib.AdamWConfig(total_steps=defaults["steps"]),
                       **defaults)
    state = train(cfg, tcfg, device=args.device)
    print(f"done at step {state.step}; checkpoints in {args.ckpt}")
    return state


if __name__ == "__main__":
    main()
