"""Serving launcher: batched prefill, then greedy or sampled decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch xlstm-125m --batch 8 --prompt-len 32 --max-new 64

The reference launcher's flags (``repro/launch/serve.py``) plus
``--device`` (``cuda`` by default; raises when no GPU is visible).  As in
the reference, ``--arch`` takes the zoo's ten architectures (default
``xlstm-125m``) and ``--reduced`` is always on, so the CLI serves the
CPU-smoke reduction of the architecture; :func:`run` takes any config
and serves the full width too (``chip_smoke.py`` drives the zoo through
it).  The weights are drawn from ``PRNGKey(0)`` as the reference draws
them; the prompts, then the VLM's patch embeddings or the enc-dec's
frame embeddings, from ``np.random.default_rng(0)`` in the reference's
order; ``--temperature T > 0`` samples each token after the first as
``categorical(sub, logits / T)`` with ``key, sub = split(key)`` from
``PRNGKey(1)`` each step (:func:`repro_torch.prng.categorical_torch`).
So the port prints the reference's sample token ids.  Prefill attention
runs the flash kernel (:mod:`repro_torch.kernels.flash_attention`);
decode attention is plain PyTorch, as the reference computes it in XLA.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.prng import prng_key


@dataclasses.dataclass
class ServeResult:
    model: torch.nn.Module
    tokens: torch.Tensor  # (B, S) prompts on the device
    logits: torch.Tensor  # (B, V) f32, the prefill's last position
    gen: np.ndarray  # (B, max_new) token ids
    t_prefill: float  # seconds, host clock, device synchronized
    t_decode: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cfg, batch: int, prompt_len: int, device):
    """The reference launcher's inputs from ``default_rng(0)``: (tokens
    (B, S), the extra prefill inputs, the prefix length)."""
    B, S = batch, prompt_len
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int64, device=device)
    inputs, prefix = {}, 0
    if cfg.family == "vlm":
        inputs["prefix_embeds"] = torch.as_tensor(
            rng.normal(0, 0.1, (B, cfg.n_prefix_tokens, cfg.d_model)),
            dtype=torch.float32, device=device)
        prefix = cfg.n_prefix_tokens
    if cfg.family == "audio":
        inputs["enc_frames"] = torch.as_tensor(
            rng.normal(0, 0.1, (B, S, cfg.d_model)), dtype=torch.float32,
            device=device)
    return tokens, inputs, prefix


def sample_keys(n: int):
    """The reference's sampling keys: from ``PRNGKey(1)``, ``key, sub =
    split(key)`` before each of ``n`` steps; the ``sub`` keys."""
    key, subs = prng_key(1), []
    for _ in range(n):
        key, sub = prng.split(key, 2)
        subs.append(sub)
    return subs


@torch.inference_mode()
def generate(model, tokens: torch.Tensor, inputs: dict, prefix: int,
             max_new: int, temperature: float = 0.0):
    """Prefill ``tokens`` (after ``inputs``' ``prefix`` positions) with room
    for ``max_new`` more, and decode ``max_new`` tokens, greedily or, with
    ``temperature`` > 0, sampled.  -> (the prefill's last logits (B, V)
    f32, the token ids (B, max_new), prefill seconds, decode seconds)."""
    device = tokens.device
    S = tokens.shape[1]
    temp = torch.tensor(np.float32(temperature), device=device)
    keys = sample_keys(max_new) if temperature > 0 else None
    _sync(device)
    t0 = time.perf_counter()
    if model.cfg.family == "ssm":
        logits, cache = model.prefill(tokens)
    else:
        logits, cache = model.prefill(tokens, capacity=S + prefix + max_new,
                                      **inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = []
    first = logits
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1)
    for i in range(max_new):
        outs.append(tok.cpu().numpy())
        logits, cache = model.decode_step(cache, tok, S + prefix + i)
        if keys is not None:
            tok = prng.categorical_torch(keys[i], logits / temp)
        else:
            tok = torch.argmax(logits, dim=-1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return first, np.stack(outs, axis=1), t_prefill, t_decode


@torch.inference_mode()
def run(cfg, batch: int, prompt_len: int, max_new: int, device="cuda",
        temperature: float = 0.0) -> ServeResult:
    """Build ``cfg``'s model from ``prng_key(0)`` on ``device``, and serve
    ``batch`` random prompts of ``prompt_len`` tokens through
    :func:`generate`."""
    device = resolve_device(device)
    model = build_model(cfg).init(prng_key(0), device)
    tokens, inputs, prefix = make_inputs(cfg, batch, prompt_len, device)
    first, gen, t_prefill, t_decode = generate(model, tokens, inputs, prefix,
                                               max_new, temperature)
    if not (np.all(gen >= 0) and np.all(gen < cfg.padded_vocab)):
        raise RuntimeError("decoded token ids outside the vocabulary")
    return ServeResult(model, tokens, first, gen, t_prefill, t_decode)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> ServeResult:
    args = parse_args(argv)
    # full float32 products where the compute dtype is f32, like the
    # reference
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    res = run(cfg, args.batch, args.prompt_len, args.max_new, args.device,
              temperature=args.temperature)
    B, S, n = args.batch, args.prompt_len, args.max_new
    print(f"arch={cfg.name} prefill({B}x{S}) {res.t_prefill*1e3:.0f} ms; "
          f"decode {n} steps {res.t_decode*1e3:.0f} ms "
          f"({res.t_decode/n*1e3:.1f} ms/tok/batch)")
    print("sample token ids[0]:", res.gen[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
