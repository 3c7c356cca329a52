"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-1.7b --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ck

The reference launcher's flags (``repro/launch/train.py``) plus
``--device`` (``cuda`` by default; raises when no GPU is visible).  As
there, ``--reduced`` (the default) trains the CPU-smoke reduction of
``--arch`` and ``--full`` the full configuration; the weights are drawn
from ``PRNGKey(0)`` and every batch from ``np.random.default_rng(0)``
(:func:`synthetic_lm_batch`, then :func:`add_extras`) as the reference
draws them, so the port logs the reference's losses.  The learning rate
follows ``warmup_cosine(lr, max(steps // 20, 1), steps)``; the optimizer
is the config's; the step updates params and optimizer state in place
(the reference donates them to its jitted step).  ``--ckpt-dir``
checkpoints ``(params, opt_state)`` every ``--ckpt-every`` steps and at
the end through :mod:`repro_torch.checkpoint.io`, in the reference's
format (either package resumes the other's with ``--resume``).  A
non-finite loss at a logged step raises ``FloatingPointError`` naming
it.

:func:`run` is the loop without the argument parsing: it takes any
config (``chip_smoke.py`` trains the full-width qwen3-1.7b through it)
and returns each step's loss, wall time and the device's peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import warmup_cosine
from repro_torch.prng import prng_key


def synthetic_lm_batch(rng, vocab: int, batch: int, seq: int) -> dict:
    """The reference's Markov-ish token stream (the next token the last
    plus a drift with probability 0.7), as numpy: ``{"tokens": (batch,
    seq) int32}``."""
    toks = np.zeros((batch, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    drift = rng.integers(1, 7, (batch,))
    for t in range(1, seq):
        stay = rng.random(batch) < 0.7
        toks[:, t] = np.where(stay, (toks[:, t - 1] + drift) % vocab,
                              rng.integers(0, vocab, batch))
    return {"tokens": toks}


def add_extras(batch: dict, cfg, rng) -> dict:
    """The VLM's patch embeddings and the enc-dec's frame embeddings, drawn
    after the tokens from the same generator, f32."""
    B, S = batch["tokens"].shape
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            0, 0.1, (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = rng.normal(
            0, 0.1, (B, S, cfg.d_model)).astype(np.float32)
    return batch


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (tokens int64)."""
    return {k: torch.as_tensor(v, dtype=torch.int64 if k == "tokens"
                               else None).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: dict
    start: int  # the step resumed from (0 without a checkpoint)
    losses: List[float]  # steps start .. steps - 1
    step_s: List[float]  # each step's wall seconds, device synchronized
    peak_bytes: int  # the device's peak allocation (0 on the CPU)
    n_params: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-3,
        device="cuda", ckpt_dir: str = "", ckpt_every: int = 50,
        resume: bool = False, log_every: int = 10,
        log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Train ``cfg`` (weights from ``prng_key(0)``) for ``steps`` steps of
    ``batch`` x ``seq`` synthetic tokens on ``device``; ``log`` (None:
    silent) gets the reference launcher's lines."""
    device = resolve_device(device)
    say = log or (lambda line: None)
    model = build_model(cfg)
    params = model.init_params(prng_key(0), device)
    n_params = model.param_count(params)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    say(f"arch={cfg.name} family={cfg.family} params={n_params:,} "
        f"devices={n_dev}")

    sched = warmup_cosine(lr, warmup=max(steps // 20, 1), total_steps=steps)
    step_fn, opt = make_train_step(model, cfg, lr=sched)
    ostate = opt.init(params)
    start = 0
    if resume and ckpt_dir:
        try:
            (params, ostate), start = load_checkpoint(ckpt_dir,
                                                      (params, ostate))
            say(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(0)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(start, steps):
        data = to_device(add_extras(
            synthetic_lm_batch(rng, cfg.vocab_size, batch, seq), cfg, rng),
            device)
        _sync(device)
        ts = time.perf_counter()
        params, ostate, metrics = step_fn(params, ostate, data, step)
        loss = float(metrics["loss"])
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"({(time.time() - t0) / max(step - start + 1, 1) * 1e3:.0f}"
                " ms/step)")
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"training diverged: non-finite loss {loss} at step "
                    f"{step} (arch={cfg.name}, lr={lr})")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, (params, ostate))
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, (params, ostate))
        say(f"final checkpoint at {ckpt_dir}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return TrainResult(params, ostate, start, losses, step_s, peak, n_params)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    # full float32 products where the compute dtype is f32, like the
    # reference
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, device=args.device, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, resume=args.resume,
               log_every=args.log_every)


if __name__ == "__main__":
    main()
