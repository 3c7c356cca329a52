"""Serving launcher: batched prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 8 --prompt-len 32 --max-new 64

The reference launcher's flags (``repro/launch/serve.py``) plus
``--device`` (``cuda`` by default; raises when no GPU is visible).  As in
the reference, ``--reduced`` is always on, so the CLI serves the CPU-smoke
reduction of the architecture; :func:`run` takes any config and serves the
full width too (``chip_smoke.py`` drives qwen3-1.7b through it).  The
weights are drawn from ``PRNGKey(0)`` as the reference draws them, the
prompts from ``np.random.default_rng(0)``, so the port prints the
reference's sample token ids.  The ported architectures are the dense
family's (``qwen3-1.7b``, the default here since the reference's default
``xlstm-125m`` is not ported); another ``--arch`` and ``--temperature >
0`` (sampling) are refused.  Prefill attention runs the flash kernel
(:mod:`repro_torch.kernels.flash_attention`) once per layer; decode
attention is plain PyTorch, as the reference computes it in XLA.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.prng import prng_key


@dataclasses.dataclass
class ServeResult:
    model: DecoderLM
    tokens: torch.Tensor  # (B, S) prompts on the device
    logits: torch.Tensor  # (B, V) f32, the prefill's last position
    gen: np.ndarray  # (B, max_new) greedy token ids
    t_prefill: float  # seconds, host clock, device synchronized
    t_decode: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run(cfg, batch: int, prompt_len: int, max_new: int,
        device="cuda") -> ServeResult:
    """Build ``cfg``'s model from ``prng_key(0)`` on ``device``, prefill
    ``batch`` random prompts of ``prompt_len`` tokens with room for
    ``max_new`` more, and decode ``max_new`` tokens greedily."""
    device = resolve_device(device)
    model = build_model(cfg).init(prng_key(0), device)
    B, S = batch, prompt_len
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int64, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, capacity=S + max_new)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = []
    first = logits
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1)
    for i in range(max_new):
        outs.append(tok.cpu().numpy())
        logits, cache = model.decode_step(cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = np.stack(outs, axis=1)
    if not (np.all(gen >= 0) and np.all(gen < cfg.padded_vocab)):
        raise RuntimeError("decoded token ids outside the vocabulary")
    return ServeResult(model, tokens, first, gen, t_prefill, t_decode)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch not in ARCHS:
        ap.error(f"--arch {args.arch} is not ported yet (ported: "
                 f"{sorted(ARCHS)}; see ROADMAP.md, queue 1)")
    if args.temperature > 0:
        ap.error("--temperature > 0 (sampling) is not ported yet; only "
                 "greedy decode runs (see ROADMAP.md, queue 1)")
    return args


def main(argv=None) -> ServeResult:
    args = parse_args(argv)
    # full float32 products where the compute dtype is f32, like the
    # reference
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    res = run(cfg, args.batch, args.prompt_len, args.max_new, args.device)
    B, S, n = args.batch, args.prompt_len, args.max_new
    print(f"arch={cfg.name} prefill({B}x{S}) {res.t_prefill*1e3:.0f} ms; "
          f"decode {n} steps {res.t_decode*1e3:.0f} ms "
          f"({res.t_decode/n*1e3:.1f} ms/tok/batch)")
    print("sample token ids[0]:", res.gen[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
