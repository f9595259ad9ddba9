"""Training entry point (port of ``repro.launch.train``): synthetic LM stream
→ train step → checkpoints, with auto-resume, a step watchdog and
optional QAT, on one device (the GPU unless ``device`` says otherwise).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
      --smoke --steps 6 --batch 4 --seq 32 --qat-weight-bits 4 \\
      --qat-act-bits 8 --ckpt-dir /tmp/ck --ckpt-every 3

Logs go to standard error. ``train()`` returns the reference's
``{"final_loss", "losses", "steps"}`` and ``"step_s"``, the wall time of
each step (each ends when its loss reaches the host).
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import LMStreamConfig, lm_batches
from repro_torch.launch.fault import Watchdog
from repro_torch.launch.steps import (
    TrainState, batch_to_device, train_step, uniform_levels)
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_adam
from repro_torch.utils.pytree import named_leaves

log = logging.getLogger("repro_torch.train")


def _trainable(state: TrainState) -> TrainState:
    for _, p in named_leaves(state.params):
        p.requires_grad_(True)
    return state


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], resume: bool, ckpt_every: int,
          qat_weight_bits: Optional[int], qat_act_bits: Optional[int],
          watchdog_s: Optional[float], lr: float = 3e-3,
          log_every: int = 10, device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    qat = None
    if qat_weight_bits is not None:
        qat = uniform_levels(cfg, qat_weight_bits, qat_act_bits, device=dev)
    adam = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5),
                       total_steps=steps)

    params = init_params(cfg, seed=0, device=dev)
    state = TrainState(params, init_adam(params))
    start_step = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state)
            start_step = latest
            log.info("resumed from step %d", latest)
    state = _trainable(state)

    stream = lm_batches(LMStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        num_codebooks=cfg.num_codebooks if cfg.family == "audio" else 0,
        img_tokens=cfg.img_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, seed=0))
    for _ in range(start_step):          # fast-forward the stream on resume
        next(stream)

    wd = Watchdog(watchdog_s) if watchdog_s else None
    losses, step_s = [], []
    t0 = time.time()
    for step in range(start_step, steps):
        tb = batch_to_device(next(stream), dev)
        ts = time.perf_counter()
        if wd:
            wd.arm()
        state, metrics = train_step(state, tb, cfg, adam, qat)
        loss = float(metrics["loss"])
        if wd:
            wd.disarm()
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            log.info("step %d loss %.4f lr %.2e gnorm %.2f", step, loss,
                     float(metrics["lr"]), float(metrics["grad_norm"]))
        if ckpt and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state, blocking=False)
    if ckpt:
        ckpt.save(steps, state, blocking=True)
        ckpt.wait()
    if wd:
        wd.stop()
    dt = time.time() - t0
    log.info("trained %d steps in %.1fs (%.3f s/step); final loss %.4f",
             steps - start_step, dt, dt / max(steps - start_step, 1), losses[-1])
    return {"final_loss": losses[-1], "losses": losses, "steps": steps,
            "step_s": step_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--qat-weight-bits", type=int, default=None)
    ap.add_argument("--qat-act-bits", type=int, default=None)
    ap.add_argument("--watchdog-s", type=float, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s] "
                               "%(message)s", datefmt="%H:%M:%S")
    train(args.arch, args.smoke, args.steps, args.batch, args.seq,
          args.ckpt_dir, args.resume, args.ckpt_every,
          args.qat_weight_bits, args.qat_act_bits, args.watchdog_s, args.lr)


if __name__ == "__main__":
    main()
