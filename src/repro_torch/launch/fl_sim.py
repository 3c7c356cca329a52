"""Paper-experiment launcher: one SAFL/SFL run from the command line.

    PYTHONPATH=src python -m repro_torch.launch.fl_sim --dataset cifar10 \
        --model cnn --dist hetero_dirichlet --alpha 0.3 \
        --mode semi_async --aggregation fedsgd --rounds 30 --device cuda

The reference launcher's flags and ``--json-out`` schema, plus
``--device`` (``cuda`` by default; raises when no GPU is visible).
``--model`` takes the paper's four (``cnn``, ``resnet18``, ``vgg16``,
``lstm``) at the reference launcher's sizes (:func:`build_model`).  The
run is the horizon-batched engine, as in the reference (``--wave-impl``
picks how a wave's lanes run; ``--no-wave-buckets`` is accepted and
changes nothing, since the port runs every wave at its own size);
``--sequential`` runs the sequential per-upload engine, the parity
oracle.  Every ``--aggregation`` of the
study runs (fedsgd, fedavg, fedbuff, fedasync, fedopt, sdga), on the
f32 wire, ``--wire q8`` (``--compress`` is its legacy alias), ``--wire
q4`` or ``--wire topk`` (the gradient schemes; ``--topk-frac`` of the
coordinates kept per upload), with fault injection (``--fault-*``,
semi-async only) and the server defense (``--defense screen|clip``,
``--defense-norm-cap``).  The scheduler's flags run as the reference's:
``--sched-timing static|lognormal|markov``, ``--sched-policy
full|uniform|seafl|fedqs|ratelimit`` (with ``--sched-c``,
``--sched-stale-cap``, ``--sched-rate-limit``, ``--sched-jitter-sigma``,
``--sched-drop-p``, ``--sched-seed``) and ``--horizon
k|queue|timeout|hybrid`` (``--horizon-queue``, ``--horizon-timeout-s``).
``--ckpt-dir`` snapshots the engine at the end of the run, and every
``--ckpt-every`` rounds with the run cut into segments; ``--resume``
restores the latest snapshot there first, so a killed run run again ends
bit for bit where the uninterrupted run ends.  ``--trace-dir D`` traces
the run (:mod:`repro_torch.obs`; ``--trace-level round|upload``, upload
by default with a directory) and writes ``D/trace.jsonl``,
``D/trace.json`` (Chrome trace, Perfetto), ``D/metrics.prom`` and
``D/metrics.json``; ``python -m repro_torch.obs.report D/trace.jsonl``
renders the trace.  ``--trace-jax`` (the reference's flag name) wraps the
run in ``torch.profiler`` and writes ``D/torch_profile.json``.
``--devices N`` lays the channel rows and the wave lanes over a 1-D mesh
of N shards and ``--mesh E P`` over the 2-D (edge, pod) mesh of E*P
(:mod:`repro_torch.sharding.flat`; ``--mesh 1 P`` is ``--devices P`` bit
for bit); with ``--device cpu`` the shards share the CPU, with
``--device cuda`` they take the first N visible GPUs (fewer raises).  The
summary's ``traffic`` is the mesh's cross-edge record.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import FLEngine
from repro_torch.device import resolve_device
from repro_torch.data import build_client_shards, make_dataset, train_test_split
from repro_torch.models.lstm import build_lstm
from repro_torch.models.vision_cnn import build_paper_model
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.prng import prng_key

#: --json-out summary schema version (the reference's)
SUMMARY_SCHEMA = 1

#: server learning rate per aggregation (the reference launcher's table)
SERVER_LR = {"fedsgd": 0.05, "sdga": 0.05, "fedbuff": 0.05, "fedopt": 0.005}


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
                    help="force the sequential per-upload engine "
                         "(batch_clients=False), the parity oracle of the "
                         "default horizon-batched engine")
    ap.add_argument("--devices", type=int, default=1,
                    help="multi-device SAFL: the channel rows and the "
                         "batched waves over a 1-D mesh of this many "
                         "shards (k %% devices == 0); --device cpu puts "
                         "them on the CPU, --device cuda needs this many "
                         "visible GPUs")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("E", "P"),
                    help="hierarchical 2-D (edge, pod) mesh: the P pod "
                         "partials of an edge tree-reduce, then the E edge "
                         "partials add (P a power of two, k %% (E*P) == "
                         "0); --mesh 1 P is --devices P bit for bit")
    ap.add_argument("--wave-impl", default="auto",
                    choices=["auto", "vmap", "map"],
                    help="batched-wave lanes: vmap (one batched step), map "
                         "(one lane after another, the sequential step), "
                         "auto (map for a conv model such as the CNN, vmap "
                         "for one without a convolution)")
    ap.add_argument("--no-wave-buckets", action="store_true",
                    help="accepted for the reference's command lines; the "
                         "port runs every wave at its own size")
    ap.add_argument("--sched-timing", default="static",
                    choices=["static", "lognormal", "markov"],
                    help="device-time model: static (deterministic), "
                         "lognormal (heavy-tailed compute jitter), markov "
                         "(drop-out / rejoin on top of the jitter)")
    ap.add_argument("--horizon", default="k",
                    choices=["k", "queue", "timeout", "hybrid"],
                    help="aggregation trigger (semi-async): k uploads, "
                         "--horizon-queue uploads, the first upload after "
                         "--horizon-timeout-s simulated seconds since the "
                         "last aggregation (streaming channel only), or "
                         "whichever of queue / timeout comes first")
    ap.add_argument("--horizon-queue", type=int, default=0,
                    help="queue / hybrid: admitted uploads a horizon "
                         "(0 -> k)")
    ap.add_argument("--horizon-timeout-s", type=float, default=0.0,
                    help="timeout / hybrid: simulated seconds between "
                         "aggregations")
    ap.add_argument("--server-channel", default="auto",
                    choices=["auto", "streaming", "buffered"],
                    help="streaming folds each upload into an O(D) "
                         "running sum on arrival (safl_fold); buffered "
                         "keeps the (K, D) rows (safl_aggregate); auto = "
                         "streaming for semi_async, buffered for sync")
    ap.add_argument("--sched-policy", default="full",
                    choices=["full", "uniform", "seafl", "fedqs",
                             "ratelimit"],
                    help="participation policy: full, uniform C-of-N "
                         "(--sched-c), seafl staleness cap "
                         "(--sched-stale-cap), fedqs staleness x sample "
                         "reweighting, ratelimit back-pressure "
                         "(--sched-rate-limit; idled clients keep "
                         "training and retry)")
    ap.add_argument("--sched-rate-limit", type=int, default=0,
                    help="ratelimit: admitted uploads a round (0 -> k)")
    ap.add_argument("--sched-c", type=int, default=0,
                    help="uniform: clients admitted a round (0 = all)")
    ap.add_argument("--sched-stale-cap", type=int, default=4,
                    help="seafl: the largest admissible staleness")
    ap.add_argument("--sched-jitter-sigma", type=float, default=0.25,
                    help="lognormal / markov: compute jitter sigma")
    ap.add_argument("--sched-drop-p", type=float, default=0.1,
                    help="markov: P(go offline) after each upload")
    ap.add_argument("--sched-seed", type=int, default=0,
                    help="seed of the timing jitter and policy sampling")
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
    ap.add_argument("--ckpt-dir", default="",
                    help="engine snapshot directory (semi-async); with "
                         "--ckpt-every the run is cut into segments, each "
                         "snapshotted, so a killed run resumes bit for "
                         "bit with --resume")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="snapshot every N aggregation rounds (0 = only "
                         "at the end of the run when --ckpt-dir is set)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot of --ckpt-dir "
                         "before running (none there: start afresh)")
    ap.add_argument("--trace-dir", default="",
                    help="write the span trace into this directory: "
                         "trace.jsonl (the records), trace.json (Chrome "
                         "trace, Perfetto), metrics.prom / metrics.json "
                         "(the registry); render with python -m "
                         "repro_torch.obs.report <dir>/trace.jsonl")
    ap.add_argument("--trace-level", default="",
                    choices=["", "off", "round", "upload"],
                    help="round (horizon spans only) or upload (each "
                         "upload's life and the scheduler's instants); "
                         "upload when --trace-dir is given, else off")
    ap.add_argument("--trace-jax", action="store_true",
                    help="also wrap the run in torch.profiler (the "
                         "reference's flag name) and write its Chrome "
                         "trace into --trace-dir (torch_profile.json)")
    ap.add_argument("--json-out", default="")
    return ap.parse_args(argv)


def build_model(name: str, ds, device):
    """(params, state, apply_fn) of ``--model`` at the reference
    launcher's CPU sizes, drawn from PRNGKey(0) whatever ``--seed`` is, as
    the reference draws them: the LSTM at embed 32, hidden 64 with the
    dataset's task head (vocab and outputs 80 for ``char``); the CNN at
    width 8 on 16x16 images; ResNet-18 at width 8; VGG-16 at width 1/8
    for 32x32 inputs (on the launcher's 16x16 images its fifth pool leaves
    no pixel and the first forward raises, as the reference's does)."""
    key = prng_key(0)
    if name == "lstm":
        task = "char" if ds.kind == "char" else "sentiment"
        kw = dict(embed=32, hidden=64)
        if task == "char":
            kw.update(vocab=80, n_out=80)
        return build_lstm(key, task, device=device, **kw)
    kw = dict(n_classes=ds.n_classes, in_ch=3)
    if name == "cnn":
        kw.update(width=8, image_size=16)
    elif name == "resnet18":
        kw.update(width=8)
    else:
        kw.update(width_mult=0.125, image_size=32)
    return build_paper_model(name, key, device=device, **kw)


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

    p0, s0, fn = build_model(args.model, ds, device)

    cfg = FLConfig(n_clients=args.clients, k=args.k, mode=args.mode,
                   aggregation=args.aggregation, client_lr=0.05,
                   server_lr=SERVER_LR.get(args.aggregation, 1.0),
                   seed=args.seed, speed_sigma=0.8,
                   compress_updates=args.compress, wire=args.wire,
                   topk_frac=args.topk_frac, eval_every=args.eval_every,
                   batch_clients=not args.sequential,
                   devices=args.devices,
                   mesh_shape=tuple(args.mesh) if args.mesh else None,
                   wave_impl=args.wave_impl,
                   wave_buckets=not args.no_wave_buckets,
                   server_channel=args.server_channel,
                   horizon=args.horizon, horizon_queue=args.horizon_queue,
                   horizon_timeout_s=args.horizon_timeout_s,
                   sched_timing=args.sched_timing,
                   sched_policy=args.sched_policy, sched_c=args.sched_c,
                   sched_rate_limit=args.sched_rate_limit,
                   sched_stale_cap=args.sched_stale_cap,
                   sched_jitter_sigma=args.sched_jitter_sigma,
                   sched_drop_p=args.sched_drop_p,
                   sched_seed=args.sched_seed,
                   fault_crash_p=args.fault_crash_p,
                   fault_straggler_p=args.fault_straggler_p,
                   fault_corrupt_p=args.fault_corrupt_p,
                   fault_byzantine_p=args.fault_byzantine_p,
                   fault_seed=args.fault_seed, defense=args.defense,
                   defense_norm_cap=args.defense_norm_cap,
                   trace_level=args.trace_level or (
                       "upload" if args.trace_dir else "off"),
                   trace_dir=args.trace_dir)
    eng = FLEngine(cfg, fn, ds.kind, p0, s0, shards, te.x[:400], te.y[:400],
                   device=device)
    log_every = max(args.rounds // 10, 1)
    if args.resume and args.ckpt_dir:
        try:
            start = eng.load_snapshot(args.ckpt_dir)
            print(f"# resumed from snapshot at round {start}")
        except FileNotFoundError:
            pass
    with obs_profile.torch_profile(args.trace_dir, enabled=args.trace_jax):
        if args.ckpt_dir and args.ckpt_every > 0:
            # segmented run: run() stops at each snapshot boundary (the
            # channel is empty between aggregations), so a kill loses at
            # most ckpt_every rounds and --resume replays the rest bit
            # for bit
            res = None
            while eng.t_global < args.rounds:
                upto = min(eng.t_global + args.ckpt_every, args.rounds)
                res = eng.run(upto, log_every=log_every)
                eng.save_snapshot(args.ckpt_dir)
            if res is None:  # resumed at the last round: nothing to run
                res = eng.run(args.rounds, log_every=log_every)
        else:
            res = eng.run(args.rounds, log_every=log_every)
            if args.ckpt_dir:
                eng.save_snapshot(args.ckpt_dir)
    if eng.tracer is not None:
        eng.tracer.close()
        if args.trace_dir:
            # beside trace.jsonl: the Chrome trace and the registry
            obs_export.export_chrome_trace(
                eng.tracer.records,
                os.path.join(args.trace_dir, "trace.json"))
            reg = obs_metrics.from_engine(eng)
            with open(os.path.join(args.trace_dir, "metrics.prom"),
                      "w") as f:
                f.write(reg.to_prometheus())
            with open(os.path.join(args.trace_dir, "metrics.json"),
                      "w") as f:
                json.dump(reg.to_json(), f, indent=1)
            print(f"# trace: {len(eng.tracer.records)} records -> "
                  f"{args.trace_dir}/trace.jsonl (Perfetto: trace.json, "
                  "metrics: metrics.prom/.json)")
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
    summary = obs_export.to_native(summary)
    print(json.dumps(summary, indent=1))
    if eng._mesh is not None:
        print(f"# mesh: {eng._mesh}  cross-edge bytes a round: "
              f"{summary['traffic']['cross_edge_bytes']}")
    print(f"# device: {device}  sched[{ss['policy']}/{ss['timing']}] "
          f"participation per client: {ss['participation']}")
    print(f"# rejected uploads: {ss['rejected_uploads']}  "
          f"idle requests: {ss['idle_requests']}  "
          f"no-shows: {ss['no_shows']}  staleness hist: "
          f"{ss['staleness_hist']}")
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
