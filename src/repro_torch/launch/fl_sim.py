"""Paper-experiment launcher: one SAFL/SFL run from the command line.

    PYTHONPATH=src python -m repro_torch.launch.fl_sim --dataset cifar10 \
        --model cnn --dist hetero_dirichlet --alpha 0.3 \
        --mode semi_async --aggregation fedsgd --rounds 30 --device cuda

The reference launcher's flags and ``--json-out`` schema, plus
``--device`` (``cuda`` by default; raises when no GPU is visible).  The
run is the sequential engine, which is what the reference runs with
``--sequential``.  Every ``--aggregation`` of the study runs (fedsgd,
fedavg, fedbuff, fedasync, fedopt, sdga), on the f32 wire, ``--wire
q8`` (``--compress`` is its legacy alias), ``--wire q4`` or ``--wire
topk`` (the gradient schemes; ``--topk-frac`` of the coordinates kept
per upload), with fault injection (``--fault-*``, semi-async only) and
the server defense (``--defense screen|clip``, ``--defense-norm-cap``).
Flags for parts not ported yet are refused with a "not ported yet" error
when given anything but their default.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import FLEngine
from repro_torch.device import resolve_device
from repro_torch.data import build_client_shards, make_dataset, train_test_split
from repro_torch.models.vision_cnn import build_paper_model
from repro_torch.prng import prng_key

#: --json-out summary schema version (the reference's)
SUMMARY_SCHEMA = 1

#: flags of parts not ported yet -> the only value accepted (the default)
NOT_PORTED = {
    "model": "cnn", "devices": 1, "mesh": None, "wave_impl": "auto",
    "no_wave_buckets": False, "sched_timing": "static", "horizon": "k",
    "horizon_queue": 0, "horizon_timeout_s": 0.0, "sched_policy": "full",
    "sched_rate_limit": 0, "sched_c": 0, "sched_stale_cap": 4,
    "sched_jitter_sigma": 0.25, "sched_drop_p": 0.1, "sched_seed": 0,
    "ckpt_dir": "", "ckpt_every": 0,
    "resume": False, "trace_dir": "", "trace_jax": False,
}
#: server learning rate per aggregation (the reference launcher's table)
SERVER_LR = {"fedsgd": 0.05, "sdga": 0.05, "fedbuff": 0.05, "fedopt": 0.005}


def to_native(obj):
    """Recursively convert to JSON-native types that round-trip through
    ``json.dumps``/``json.loads`` by equality."""
    if isinstance(obj, dict):
        return {str(k): to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_native(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [to_native(v) for v in obj.tolist()]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100", "femnist",
                             "shakespeare", "sentiment140"])
    ap.add_argument("--model", default="cnn",
                    choices=["cnn", "resnet18", "vgg16", "lstm"])
    ap.add_argument("--dist", default="hetero_dirichlet")
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--sigma", type=float, default=0.5)
    ap.add_argument("--n-labels", type=int, default=2)
    ap.add_argument("--mode", default="semi_async",
                    choices=["sync", "semi_async"])
    ap.add_argument("--aggregation", default="fedsgd",
                    choices=["fedsgd", "fedavg", "fedbuff", "fedasync",
                             "fedopt", "sdga"])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda raises when no GPU is visible")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--wire", default="f32",
                    choices=["f32", "q8", "q4", "topk"])
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="--wire topk: fraction of coordinates kept per "
                         "upload (rounded up to a whole quant block)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="evaluate every Nth aggregation round (the final "
                         "round is always evaluated)")
    ap.add_argument("--sequential", action="store_true",
                    help="the sequential per-upload engine; it is the only "
                         "engine ported, so this is also the default")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("E", "P"))
    ap.add_argument("--wave-impl", default="auto",
                    choices=["auto", "vmap", "map"])
    ap.add_argument("--no-wave-buckets", action="store_true")
    ap.add_argument("--sched-timing", default="static",
                    choices=["static", "lognormal", "markov"])
    ap.add_argument("--horizon", default="k",
                    choices=["k", "queue", "timeout", "hybrid"])
    ap.add_argument("--horizon-queue", type=int, default=0)
    ap.add_argument("--horizon-timeout-s", type=float, default=0.0)
    ap.add_argument("--server-channel", default="auto",
                    choices=["auto", "streaming", "buffered"],
                    help="streaming folds each upload into an O(D) "
                         "running sum on arrival (safl_fold); buffered "
                         "keeps the (K, D) rows (safl_aggregate); auto = "
                         "streaming for semi_async, buffered for sync")
    ap.add_argument("--sched-policy", default="full",
                    choices=["full", "uniform", "seafl", "fedqs",
                             "ratelimit"])
    ap.add_argument("--sched-rate-limit", type=int, default=0)
    ap.add_argument("--sched-c", type=int, default=0)
    ap.add_argument("--sched-stale-cap", type=int, default=4)
    ap.add_argument("--sched-jitter-sigma", type=float, default=0.25)
    ap.add_argument("--sched-drop-p", type=float, default=0.1)
    ap.add_argument("--sched-seed", type=int, default=0)
    ap.add_argument("--fault-crash-p", type=float, default=0.0,
                    help="P(an upload is lost and its client crashes; it "
                         "resyncs and retries after a backoff)")
    ap.add_argument("--fault-straggler-p", type=float, default=0.0,
                    help="P(the client's next period is the config's "
                         "fault_straggler_mult x slower)")
    ap.add_argument("--fault-corrupt-p", type=float, default=0.0,
                    help="P(NaN/Inf lanes, or flipped int8 bytes and an "
                         "Inf scale, in the upload)")
    ap.add_argument("--fault-byzantine-p", type=float, default=0.0,
                    help="P(the upload is sign-flipped and rescaled by "
                         "the config's fault_byzantine_rescale)")
    ap.add_argument("--fault-seed", type=int, default=7,
                    help="seed of the counter-keyed fault schedule")
    ap.add_argument("--defense", default="none",
                    choices=["none", "screen", "clip"],
                    help="server-side defense: screen drops non-finite "
                         "(and, with a cap, over-norm) uploads; clip drops "
                         "non-finite ones and down-weights over-norm ones "
                         "to the cap")
    ap.add_argument("--defense-norm-cap", type=float, default=0.0,
                    help="L2 norm cap of the defense (0 with screen: "
                         "integrity only)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--trace-level", default="",
                    choices=["", "off", "round", "upload"])
    ap.add_argument("--trace-jax", action="store_true")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    for name, default in NOT_PORTED.items():
        if getattr(args, name) != default:
            ap.error(f"--{name.replace('_', '-')}="
                     f"{getattr(args, name)!r} is not ported yet (only "
                     f"{default!r})")
    if args.trace_level not in ("", "off"):
        ap.error(f"--trace-level={args.trace_level!r} is not ported yet")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)  # cuda without a GPU raises
    # full float32, like the reference: cuDNN would otherwise run the
    # convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # deterministic convolution algorithms, none picked by timing: a run
    # on the card repeats bit for bit (some of cuDNN's weight-gradient
    # algorithms sum with atomics in an order that varies run to run)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mk_kw = {"hw": 16} if "cifar" in args.dataset or \
        args.dataset == "femnist" else {}
    ds = make_dataset(args.dataset, n=args.samples, seed=args.seed, **mk_kw)
    if args.dataset == "femnist":
        ds.x = np.repeat(ds.x, 3, axis=-1)
    tr, te = train_test_split(ds)
    dist_kw = {}
    if "dirichlet" in args.dist:
        dist_kw = ({"alpha": args.alpha} if args.dist == "hetero_dirichlet"
                   else {"sigma": args.sigma})
    if args.dist == "shards":
        dist_kw = {"n_labels": args.n_labels}
    shards = build_client_shards(tr, args.dist, args.clients, 32,
                                 seed=args.seed, **dist_kw)

    # the reference's CPU-sized CNN (width 8 on 16x16 images), drawn from
    # PRNGKey(0) whatever --seed is, as the reference draws it
    p0, s0, fn = build_paper_model(args.model, prng_key(0), device=device,
                                   n_classes=ds.n_classes, in_ch=3,
                                   width=8, image_size=16)

    cfg = FLConfig(n_clients=args.clients, k=args.k, mode=args.mode,
                   aggregation=args.aggregation, client_lr=0.05,
                   server_lr=SERVER_LR.get(args.aggregation, 1.0),
                   seed=args.seed, speed_sigma=0.8,
                   compress_updates=args.compress, wire=args.wire,
                   topk_frac=args.topk_frac, eval_every=args.eval_every,
                   server_channel=args.server_channel,
                   fault_crash_p=args.fault_crash_p,
                   fault_straggler_p=args.fault_straggler_p,
                   fault_corrupt_p=args.fault_corrupt_p,
                   fault_byzantine_p=args.fault_byzantine_p,
                   fault_seed=args.fault_seed, defense=args.defense,
                   defense_norm_cap=args.defense_norm_cap)
    eng = FLEngine(cfg, fn, ds.kind, p0, s0, shards, te.x[:400], te.y[:400],
                   device=device)
    res = eng.run(args.rounds, log_every=max(args.rounds // 10, 1))
    summary = res.metrics.summary()
    summary["schema"] = SUMMARY_SCHEMA
    summary["tx_bytes"] = int(res.metrics.total_tx_bytes())
    summary["rx_bytes"] = int(res.metrics.total_rx_bytes())
    ss = dict(res.sched_stats)
    ss["staleness_bins"] = [int(v) for v in ss["staleness_bins"]]
    ss["staleness_hist"] = {int(kk): v
                            for kk, v in sorted(res.staleness_hist.items())}
    summary["sched"] = ss
    summary["traffic"] = dict(eng._server.traffic)
    summary = to_native(summary)
    print(json.dumps(summary, indent=1))
    print(f"# device: {device}  sched[{ss['policy']}/{ss['timing']}] "
          f"participation per client: {ss['participation']}")
    print(f"# staleness hist: {ss['staleness_hist']}")
    print(f"# faults: crashed {ss['crashed_uploads']}  corrupted "
          f"{ss['corrupted_uploads']}  byzantine "
          f"{ss['byzantine_uploads']}  defense[{args.defense}]: "
          f"screened {ss['screened_uploads']}  clipped "
          f"{ss['clipped_uploads']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
        with open(args.json_out) as f:
            assert json.load(f) == summary, \
                "--json-out did not round-trip losslessly"
    if summary["nan_rounds"]:
        # a diverged run must not look like success to the caller
        print(f"# FAILED: non-finite eval from round "
              f"{res.metrics.first_nan_round()} "
              f"({summary['nan_rounds']} nan rounds)")
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
