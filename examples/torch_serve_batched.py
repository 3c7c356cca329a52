"""End-to-end serving driver on the PyTorch port: serve a model with
batched requests through the full prefill + decode path, the requests'
prompts of different lengths left-padded into one batch (the port of
``examples/serve_batched.py``).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py \\
          [--arch xlstm-125m] [--requests 16] [--max-new 48] [--device cpu]

As the reference: the reduced config of ``--arch`` with weights from
``PRNGKey(0)``, ``--requests`` prompts of 8-32 tokens from
``np.random.default_rng(0)``, left-padded with 0 and no mask, prefill
with room for ``--max-new`` more tokens (the ``ssm`` family takes no
capacity), then greedy decode until every request has emitted the
synthetic EOS id 7 or ``--max-new`` tokens.  It runs on the GPU unless
``--device cpu`` is given.  :func:`serve` is the loop over a built model
and :func:`run` builds any config's model and serves it, so the loop
also runs at full width.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

#: the synthetic end-of-sequence id
EOS = 7


def pad_prompts(prompts, vocab, pad=0):
    """Left-pad the prompts into (tokens (B, S) int32, mask (B, S) f32)
    so that decode positions align (the reference's ``pad_prompts``)."""
    S = max(len(p) for p in prompts)
    out = np.full((len(prompts), S), pad, np.int32)
    mask = np.zeros((len(prompts), S), np.float32)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = p
        mask[i, S - len(p):] = 1
    return out, mask


def make_prompts(cfg, requests: int):
    """The queue of requests: prompts of 8-32 token ids from
    ``default_rng(0)``, as the reference draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, rng.integers(8, 33)).tolist()
            for _ in range(requests)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(model, prompts, max_new: int, device, log=print) -> dict:
    """Prefill the padded prompts on ``device``, then decode greedily
    until every request has emitted ``EOS`` or ``max_new`` tokens.
    Returns each request's generated ids, their lengths, the batched
    decode steps taken and the prefill and decode seconds."""
    cfg = model.cfg
    toks, _ = pad_prompts(prompts, cfg.vocab_size)
    B, S = toks.shape
    tokens = torch.as_tensor(toks, dtype=torch.int64, device=device)
    _sync(device)
    t0 = time.perf_counter()
    if cfg.family == "ssm":
        logits, cache = model.prefill(tokens)
    else:
        logits, cache = model.prefill(tokens, capacity=S + max_new)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    log(f"prefill {B} reqs (max prompt {S}) in {t_prefill:.2f}s")

    done = np.zeros(B, bool)
    tok = torch.argmax(logits, dim=-1)
    generated = [[] for _ in range(B)]
    t0 = time.perf_counter()
    steps = 0
    for i in range(max_new):
        ids = tok.cpu().numpy()
        for b in range(B):
            if not done[b]:
                generated[b].append(int(ids[b]))
        done |= ids == EOS
        if done.all():
            break
        logits, cache = model.decode_step(cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1)
        steps += 1
    _sync(device)
    t_decode = time.perf_counter() - t0
    lens = [len(g) for g in generated]
    if any(not 0 <= t < cfg.padded_vocab for g in generated for t in g):
        raise RuntimeError("decoded token ids outside the vocabulary")
    log(f"decoded {sum(lens)} tokens over {steps} batched steps in "
        f"{t_decode:.2f}s ({sum(lens) / max(t_decode, 1e-9):.0f} tok/s "
        "aggregate)")
    log(f"per-request lengths: {lens}")
    log(f"first request ids: {generated[0][:12]}")
    return dict(generated=generated, lens=lens, steps=steps, batch=B,
                prompt=S, t_prefill=t_prefill, t_decode=t_decode)


def run(cfg, requests: int = 16, max_new: int = 48, device="cuda",
        log=print) -> dict:
    """Build ``cfg``'s model from ``prng_key(0)`` on ``device`` and
    :func:`serve` ``requests`` prompts."""
    device = resolve_device(device)
    model = build_model(cfg).init(prng_key(0), device)
    out = serve(model, make_prompts(cfg, requests), max_new, device, log)
    if min(out["lens"]) <= 0:
        raise RuntimeError("a request generated no token")
    log("serve_batched OK")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=list(ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # full float32 products where the compute dtype is f32, like the
    # reference
    torch.backends.cuda.matmul.allow_tf32 = False
    return run(reduced_config(get_config(args.arch)), args.requests,
               args.max_new, args.device)


if __name__ == "__main__":
    main()
