"""Reproduce the paper's central experiment end to end on the PyTorch
port: the four system modes (SS/SA/AS/AA) on one scenario, with accuracy
curves and all four metric families (§4.4) printed (the port of
``examples/safl_paper_sim.py``).

Run:  PYTHONPATH=src python examples/torch_safl_paper_sim.py \\
          [--rounds 30] [--clients 16] [--device cpu]

As the reference: 2000 synthetic CIFAR-10 images at 16x16, split and
partitioned over ``--clients`` hetero-Dirichlet clients (alpha 0.3), the
width-8 CNN from ``prng_key(0)``, k = 4, client lr 0.05, server lr 0.05
under fedsgd and 1.0 under fedavg, target accuracy 0.45, speed sigma
0.8, 400 test samples.  It runs on the GPU unless ``--device cpu`` is
given.  :func:`simulate` runs the four modes and returns each one's
``summary()`` and accuracy curve; :func:`main` prints them.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import FLEngine  # noqa: E402
from repro_torch.data import (build_client_shards, make_dataset,  # noqa: E402
                              train_test_split)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.vision_cnn import build_paper_model  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

#: (mode, aggregation, tag) of the paper's four settings
SETTINGS = (("sync", "fedsgd", "SS"), ("sync", "fedavg", "SA"),
            ("semi_async", "fedsgd", "AS"), ("semi_async", "fedavg", "AA"))
N_TEST = 400


def sparkline(vals, width=40):
    bars = " .:-=+*#%@"
    if not vals:
        return ""
    step = max(len(vals) // width, 1)
    vals = vals[::step][:width]
    return "".join(bars[min(int(v * (len(bars) - 1)), len(bars) - 1)]
                   for v in vals)


def setup(clients: int, device):
    """The scenario: (shards, test set, (params, state, apply))."""
    ds = make_dataset("cifar10", n=2000, seed=0, hw=16)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", clients, 32,
                                 alpha=0.3)
    model = build_paper_model("cnn", prng_key(0), width=8, image_size=16,
                              device=device)
    return shards, te, model


def simulate(rounds: int = 30, clients: int = 16, device="cuda") -> dict:
    """The four modes, ``rounds`` rounds each on one scenario.  Returns
    ``{tag: dict(summary, curve, engine, result)}`` in the paper's
    order."""
    device = resolve_device(device)
    shards, te, (p0, s0, fn) = setup(clients, device)
    out = {}
    for mode, aggn, tag in SETTINGS:
        fl = FLConfig(n_clients=clients, k=4, mode=mode, aggregation=aggn,
                      client_lr=0.05,
                      server_lr=0.05 if aggn == "fedsgd" else 1.0,
                      target_accuracy=0.45, speed_sigma=0.8)
        eng = FLEngine(fl, fn, "image", p0, s0, shards, te.x[:N_TEST],
                       te.y[:N_TEST], device=device)
        res = eng.run(rounds)
        out[tag] = dict(summary=res.metrics.summary(),
                        curve=[r.accuracy for r in res.metrics.records],
                        engine=eng, result=res)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # full float32 products and deterministic convolutions, as fl_sim
    # sets them: a run on the card repeats bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = simulate(args.rounds, args.clients, args.device)
    print(f"{'mode':4s} {'best':>6s} {'T_f':>4s} {'T_s-T_f':>7s} "
          f"{'osc@.05':>7s} {'tx MB':>7s} {'stale':>5s}  curve")
    for tag, run in out.items():
        s = run["summary"]
        stab = s["stability"] if s["stability"] is not None else "-"
        print(f"{tag:4s} {s['best_accuracy']:6.3f} {str(s['T_f']):>4s} "
              f"{str(stab):>7s} {s['oscillations'][0.05]:7d} "
              f"{s['tx_GB']*1e3:7.1f} {s['mean_staleness']:5.2f}  "
              f"{sparkline(run['curve'])}")
    print("\npaper claims at this scale: AS>AA accuracy; FedSGD less tx; "
          "SAFL more oscillation than SFL")
    return out


if __name__ == "__main__":
    main()
