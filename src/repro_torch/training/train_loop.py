"""Training loop: train step, async checkpointing, restart, metrics.

Port of ``repro.training.train_loop`` on one device (the card unless the
caller passes ``device="cpu"``).  Fault-tolerance contract, as there:

  * checkpoints are atomic and keep-last-k (``training.checkpoint``);
  * the data stream is a pure function of the step index
    (``training.data``), so a restart at step k reproduces the exact
    remaining stream;
  * ``train`` without a state resumes from the latest checkpoint in
    ``ckpt_dir`` when there is one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import data as data_lib
from repro_torch.training import optimizer as opt_lib


@dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    opt: opt_lib.AdamWConfig = field(default_factory=opt_lib.AdamWConfig)


@dataclass
class TrainState:
    params: Any
    opt_state: opt_lib.AdamWState
    step: int


def init_state(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> TrainState:
    params = M.init_params(cfg, seed, device=device)
    return TrainState(params=params, opt_state=opt_lib.init(params), step=0)


def make_batch(cfg: ModelConfig, stream: data_lib.TokenStream, index: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of ``stream`` on ``device``, with the zero bf16
    ``patch_embeds`` (vlm) or ``frames`` (audio) stub the reference's
    loop feeds."""
    B = stream.cfg.global_batch
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in stream.batch(index).items()}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return batch


def train(cfg: ModelConfig, tcfg: TrainConfig,
          state: Optional[TrainState] = None,
          hooks: Optional[List[Callable[[int, Dict], None]]] = None,
          device: DeviceLike = None) -> TrainState:
    dev = resolve_device(device)
    stream = data_lib.TokenStream(data_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed))

    start_step = 0
    if state is None:
        state = init_state(cfg, tcfg.seed, dev)
        if tcfg.ckpt_dir and (ls := ckpt_lib.latest_step(tcfg.ckpt_dir)) \
                is not None:
            restored = ckpt_lib.restore(
                tcfg.ckpt_dir, ls,
                {"params": state.params, "opt": state.opt_state})
            state = TrainState(params=restored["params"],
                               opt_state=restored["opt"], step=ls)
            start_step = ls
    else:
        start_step = state.step

    step_fn = steps_lib.make_train_step(cfg, tcfg.opt)
    saver = ckpt_lib.AsyncCheckpointer()
    params, opt_state = state.params, state.opt_state

    t0 = time.perf_counter()
    for i in range(start_step, tcfg.steps):
        batch = make_batch(cfg, stream, i, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if hooks:
            for h in hooks:
                h(i, {k: float(v) for k, v in metrics.items()})
        if tcfg.log_every and (i + 1) % tcfg.log_every == 0:
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            tps = tcfg.global_batch * tcfg.seq_len * tcfg.log_every / dt
            print(f"step {i+1:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"({tps:,.0f} tok/s on {dev})", flush=True)
            t0 = time.perf_counter()
        if tcfg.ckpt_dir and (i + 1) % tcfg.ckpt_every == 0:
            saver.save(tcfg.ckpt_dir, i + 1,
                       {"params": params, "opt": opt_state})
    saver.wait()
    synchronize(dev)
    return TrainState(params=params, opt_state=opt_state, step=tcfg.steps)
