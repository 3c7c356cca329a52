"""Quickstart on the PyTorch port: the three layers of the framework in
one run (the port of ``examples/quickstart.py``).

  1. big-model substrate -- build an assigned architecture (reduced), take
     real optimizer steps;
  2. the paper's technique -- run a semi-asynchronous FL round with both
     aggregation targets (FedSGD vs FedAvg) and read the metrics;
  3. serving -- prefill + a few decode steps against the KV cache.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

As the reference: the reduced qwen3-1.7b from ``prng_key(0)``, 5 AdamW
steps at lr 5e-3 (``launch.steps.make_train_step``) on one (4, 32) batch
drawn by ``prng.randint(prng_key(1), ...)`` (bitwise
``jax.random.randint``); the width-4 CNN on 800 synthetic CIFAR-10
images at 16x16, 8 hetero-Dirichlet clients (alpha 0.3), k = 4,
semi-async fedsgd and fedavg for 6 rounds each; then the trained model's
prefill with room for 40 positions and 4 greedy decode steps.  It runs
on the GPU unless ``--device cpu`` is given.  :func:`train`,
:func:`federate` and :func:`decode` are the three parts; each returns
what it computed, so the parts also run on their own.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import FLEngine  # noqa: E402
from repro_torch.data import (build_client_shards, make_dataset,  # noqa: E402
                              train_test_split)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import STACKS  # noqa: E402
from repro_torch.models.vision_cnn import build_paper_model  # noqa: E402
from repro_torch.prng import prng_key, randint  # noqa: E402

#: part 1: the batch (B, S), the AdamW lr and the steps
B, S, LR, STEPS = 4, 32, 5e-3, 5
#: part 2: the data, clients, rounds and test samples
SAMPLES, CLIENTS, ROUNDS, N_TEST = 800, 8, 6, 200
#: part 3: the KV cache's capacity and the greedy decode steps
CAPACITY, DECODE = 40, 4


def lm_config():
    """Part 1's model: the reduced qwen3-1.7b."""
    return reduced_config(ARCHS["qwen3-1.7b"])


def token_batch(cfg, device) -> dict:
    """The (B, S) token batch, ``jax.random.randint(PRNGKey(1), (B, S), 0,
    vocab)`` bit for bit."""
    toks = randint(prng_key(1), (B, S), 0, cfg.vocab_size, device)
    return {"tokens": toks.long()}


def train(device, steps: int = STEPS, log=print) -> dict:
    """Part 1: ``steps`` AdamW steps of the reduced qwen3 on one batch.
    Returns the config, model, trained params, batch and every step's
    loss."""
    cfg = lm_config()
    model = build_model(cfg)
    params = model.init_params(prng_key(0), device)
    step_fn, opt = make_train_step(model, cfg, lr=LR)
    ostate = opt.init(params)
    batch = token_batch(cfg, device)
    losses = []
    for i in range(steps):
        params, ostate, m = step_fn(params, ostate, batch, i)
        losses.append(float(m["loss"]))
    log(f"[1] {cfg.name} (reduced, {model.param_count(params):,} params) "
        f"loss after {steps} steps: {losses[-1]:.3f}")
    return dict(cfg=cfg, model=model, params=params, ostate=ostate,
                batch=batch, losses=losses)


def fl_setup(device):
    """Part 2's data and model: (shards, test set, (params, state,
    apply))."""
    ds = make_dataset("cifar10", n=SAMPLES, seed=0, hw=16)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", CLIENTS, 32,
                                 alpha=0.3)
    model = build_paper_model("cnn", prng_key(0), width=4, image_size=16,
                              device=device)
    return shards, te, model


def federate(device, rounds: int = ROUNDS, log=print) -> dict:
    """Part 2: SAFL-FedSGD and SAFL-FedAvg, ``rounds`` rounds each.
    Returns ``{aggregation: (engine, result)}``."""
    shards, te, (p0, s0, fn) = fl_setup(device)
    out = {}
    for aggn in ("fedsgd", "fedavg"):
        fl = FLConfig(n_clients=CLIENTS, k=4, mode="semi_async",
                      aggregation=aggn, client_lr=0.05,
                      server_lr=0.05 if aggn == "fedsgd" else 1.0)
        eng = FLEngine(fl, fn, "image", p0, s0, shards, te.x[:N_TEST],
                       te.y[:N_TEST], device=device)
        res = eng.run(rounds)
        s = res.metrics.summary()
        log(f"[2] SAFL-{aggn}: best acc {s['best_accuracy']:.3f}, "
            f"tx {s['tx_GB']*1e3:.1f} MB, staleness "
            f"{s['mean_staleness']:.2f}")
        out[aggn] = (eng, res)
    return out


@torch.inference_mode()
def decode(cfg, params, batch, steps: int = DECODE, log=print) -> dict:
    """Part 3: prefill ``batch`` with room for :data:`CAPACITY` positions,
    then ``steps`` greedy decode steps.  Returns every step's ids and
    logits (the prefill's first)."""
    module = STACKS[cfg.family].from_tree(cfg, params)
    tokens = batch["tokens"]
    logits, cache = module.prefill(tokens, capacity=CAPACITY)
    tok = torch.argmax(logits, dim=-1)
    ids, all_logits = [tok], [logits]
    for i in range(steps):
        logits, cache = module.decode_step(cache, tok, tokens.shape[1] + i)
        tok = torch.argmax(logits, dim=-1)
        ids.append(tok)
        all_logits.append(logits)
    last = tok.cpu().tolist()
    log(f"[3] decoded {steps} tokens, last ids: {last}")
    return dict(ids=[t.cpu().tolist() for t in ids], last=last,
                logits=[x.float().cpu() for x in all_logits])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # full float32 products and deterministic convolutions, as fl_sim
    # sets them: a run on the card repeats bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    lm = train(device)
    fl = federate(device)
    served = decode(lm["cfg"], lm["params"], lm["batch"])
    print("quickstart OK")
    return dict(train=lm, federate=fl, decode=served)


if __name__ == "__main__":
    main()
