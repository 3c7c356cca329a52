"""Pretraining with the paper's FL aggregation as the cross-pod step, on
the PyTorch port (the port of ``examples/distributed_pretrain.py``).

Run:  PYTHONPATH=src python examples/torch_distributed_pretrain.py \\
          [--steps 20] [--aggregation fedsgd|fedavg] [--device cpu]

The reference runs on a (2, 2, 2) ("pod", "data", "model") mesh of 8
host devices.  The port keeps that mesh on one controller
(:class:`repro_torch.launch.mesh.AxisMesh`): its two pods are the leading
axis of stacked params and optimizer state, stepped one after another by
:func:`repro_torch.launch.steps.make_fl_train_step`, and the "data" and
"model" axes are the identities of :mod:`repro_torch.sharding.ctx`.
Every shard is on one device (the GPU unless ``--device cpu``); nothing
runs across GPUs.  As the reference: the reduced qwen3-1.7b at d_model
256 with 4 / 2 heads, B 8 x S 32 random tokens a step from
``np.random.default_rng(0)``, lr 5e-3, two local steps a round under
fedavg, unit pod weights; the losses of steps 0, 5, 10, 15 and the last,
then the cross-pod drift of the first leaf, which the aggregation keeps
at 0.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import tree as treemod  # noqa: E402
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import AxisMesh  # noqa: E402
from repro_torch.launch.steps import make_fl_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

B, S, LR = 8, 32, 5e-3


def pretrain_config():
    """The reference example's model: the reduced qwen3-1.7b at d_model
    256, 4 heads, 2 KV heads."""
    return dataclasses.replace(reduced_config(ARCHS["qwen3-1.7b"]),
                               d_model=256, n_heads=4, n_kv_heads=2)


def run(cfg=None, steps: int = 20, aggregation: str = "fedsgd",
        device="cuda", log=print) -> dict:
    """``steps`` FL rounds of ``cfg`` (default :func:`pretrain_config`)
    over the two pods.  Returns every step's loss and the drift."""
    cfg = cfg or pretrain_config()
    device = resolve_device(device)
    mesh = AxisMesh({"pod": 2, "data": 2, "model": 2})
    log(f"devices=1 mesh={dict(mesh.shape)} aggregation={aggregation}")
    log(f"every shard of the mesh is on {device}: the pods run one after "
        "another, the data and model axes are identities")
    n_pods = mesh.shape["pod"]
    model = build_model(cfg)
    step_fn, opt = make_fl_train_step(
        model, cfg, aggregation=aggregation, lr=LR,
        inner_steps=2 if aggregation == "fedavg" else 1)
    init = model.init_params(prng_key(0), device)
    params = treemod.tree_map(lambda x: torch.stack([x] * n_pods), init)
    ostate = treemod.tree_map(lambda x: torch.stack([x] * n_pods),
                              opt.init(init))
    del init
    rng = np.random.default_rng(0)
    weights = np.ones(n_pods, np.float32)
    losses = []
    t0 = time.time()
    for step in range(steps):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int64, device=device)
        params, ostate, m = step_fn(params, ostate, {"tokens": toks}, step,
                                    weights)
        losses.append(float(m["loss"]))
        if step % 5 == 0 or step == steps - 1:
            log(f"step {step:3d} loss {losses[-1]:.4f}")
    # pod replicas stay in sync after aggregation (FedSGD) / averaging
    leaf = treemod.tree_leaves(params)[0]
    drift = float((leaf[0] - leaf[1]).abs().max())
    log(f"cross-pod param drift after aggregation: {drift:.2e}")
    if not drift < 1e-4:
        raise AssertionError("pods diverged — aggregation broken")
    wall = time.time() - t0
    log(f"distributed_pretrain OK ({wall:.1f}s)")
    return dict(losses=losses, drift=drift, wall_s=wall)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--aggregation", default="fedsgd",
                    choices=["fedsgd", "fedavg"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # full float32 products where the compute dtype is f32, like the
    # reference
    torch.backends.cuda.matmul.allow_tf32 = False
    return run(steps=args.steps, aggregation=args.aggregation,
               device=args.device)


if __name__ == "__main__":
    main()
