"""Quickstart: build an architecture, run a forward pass, generate tokens.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch tinyllama-1.1b] [--device cpu]

Twin of ``examples/quickstart.py``'s first two sections on the port:
the reduced (smoke) config, one full-sequence ``forward``, then the
serving engine on three requests of different prompt and completion
lengths (continuous batching over the paged pool for the attention
families, lockstep waves for ssm/hybrid/audio).  Runs on the card by
default; ``--device cpu`` takes the plain PyTorch path.  The forward
runs under ``torch.no_grad()``, so on the card its attention takes the
flash-attention kernel where the shapes allow (``model.kernel_route``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig


def main(argv=None) -> dict:
    """Returns {"logits": the forward's logits, "generated": {uid:
    tokens}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={M.param_count(cfg):,} device={dev}")

    # 1. Initialize parameters and run one forward pass.
    params = M.init_params(cfg, seed=0, device=dev)
    batch = {"tokens": (torch.arange(32, device=dev)[None]
                        % cfg.vocab_size)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (1, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (1, cfg.encdec.encoder_seq_len, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        logits, _ = M.forward(cfg, params, batch)
    print(f"forward: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits.float()).all())}")

    # 2. Generate through the serving engine (see examples/quickstart.py
    # for its knobs): step() admits queued work, prefills one prompt
    # chunk and decodes every live lane.
    eng = ServingEngine(cfg, params, max_batch=2, max_len=48, eos_id=-1,
                        block_size=8, prefill_chunk=16, prefix_cache=True,
                        sampler=SamplerConfig(temperature=0.7, top_k=20),
                        device=dev)
    eng.submit(np.arange(1, 9), max_new_tokens=8)
    eng.submit(np.arange(5, 18), max_new_tokens=5)
    eng.submit(np.arange(2, 8), max_new_tokens=6)  # waits for a freed slot
    done = eng.run()
    for uid, toks in sorted(done.items()):
        print(f"generated[{uid}]: {toks}")
    print(f"decode throughput: {eng.stats.tokens_per_s:.1f} tok/s, "
          f"{eng.mode} engine ({dev})")
    return {"logits": logits, "generated": done}


if __name__ == "__main__":
    main()
