"""Readings that set a cell's correctness limits, taken on the card at the
cell's own size (the benchmark's own runs never run this).  Each side's
warm-up rounds are judged as a run judges the program's
(:func:`bench.correct.judge`: the float32 reference follows them round by
round), and each line also says whether the cell's limits pass it:

  * ``sound``: the program, as every benchmark run judges it;
  * ``tf32``: the control, the plain reference in TF32 (the nearest
    precision below the configuration's float32 with TF32 off) put in
    the program's place; it has to come out not correct;
  * ``f32_algos``: the plain reference in float32 with cuDNN's fastest
    algorithms (``cudnn.benchmark`` on, ``deterministic`` off) in the
    program's place: another float32 summation order, as a later change
    of the program's kernels would bring; the limits have to pass it;
  * one line per planted fault of the program: ``unchanged`` (the
    server's step returns the weights it was given), ``half`` (the
    second half of each round's uploads left out, the mean taken over
    the rest), ``half_batch`` (the second half of every training batch
    left out of the gradient), ``altered`` (the first upload of each
    wave doubled where the client produces it); each has to come out
    not correct.

    python3 bench/controls.py --workload vgg16-ss-f32 --seeds 1,2,3 \
        [--faults unchanged,half,half_batch,altered] [--no-control]

Each reading prints as one JSON line.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


FAULTS = ("unchanged", "half", "half_batch", "altered")


def plant(fault: str):
    """A ``program_hook`` that breaks the engine's timed path."""
    import numpy as np
    import torch

    def unchanged(eng):
        srv = eng._server
        step, finalize = srv.step, srv.finalize

        def step_same(p, *a, **kw):
            _, opt, m = step(p, *a, **kw)
            return p, opt, m

        def finalize_same(p, *a, **kw):
            _, opt, m, z = finalize(p, *a, **kw)
            return p, opt, m, z

        srv.step, srv.finalize = step_same, finalize_same

    def half(eng):
        inner = eng._weight_vector

        def first_half(staleness, sizes):
            w = np.array(inner(staleness, sizes), np.float32)
            w[(len(w) + 1) // 2:] = 0.0
            return w

        eng._weight_vector = first_half

    def half_batch(eng):
        inner = eng.apply_fn

        def apply(params, state, x, train):
            logits, new_state = inner(params, state, x, train)
            if train:
                h = logits.shape[0] // 2
                logits = torch.cat([logits[:h], logits[h:].detach()])
            return logits, new_state

        eng.apply_fn = apply

    def altered(eng):
        inner = eng._payload_rows

        def doubled(vecs, cids):
            vecs = vecs.clone()
            vecs[0] = vecs[0] * torch.tensor(2.0, device=vecs.device)
            return inner(vecs, cids)

        eng._payload_rows = doubled

    return {"unchanged": unchanged, "half": half, "half_batch": half_batch,
            "altered": altered}[fault]


def warm_snaps(spec, data, start, device, hook=None):
    """The program's warm-up rounds from ``start``, recorded as
    :func:`bench.program.warm_up` records them."""
    from bench import program
    eng = program.build_engine(spec["config"], spec["traffic"], data,
                               program.clone(start["params"]),
                               program.clone(start["state"]), device)
    if hook is not None:
        hook(eng)
    return program.warm_up(eng, spec["traffic"]["warm_rounds"],
                           data["valid"])


def readings_for(spec, seed, device, faults, control=True):
    import torch
    from bench import correct, inputs, program
    from bench.reference import fl, models
    cfg, tr, limits = spec["config"], spec["traffic"], spec["limits"]
    warm = tr["warm_rounds"]
    program.set_precision(cfg)
    data = inputs.make_data(tr, seed, device)
    params, state = inputs.make_weights(cfg, seed, device)
    start = {"params": params, "state": state}
    dev_data = inputs.data_to(data, device)
    out = []

    def line(kind, prog, **extra):
        t0 = time.perf_counter()
        nums = correct.judge(cfg, tr, dev_data, start, prog, warm)
        ok = correct.verdict(nums, limits)["correct"]
        out.append(dict(kind=kind, seed=seed, correct=ok,
                        judge_s=time.perf_counter() - t0,
                        losses=[r["loss"]
                                for r in prog["snaps"][warm]["records"]],
                        **extra, **nums))
        # each side's engine and record go before the next is built
        prog.clear()
        gc.collect()
        torch.cuda.empty_cache()

    def in_place(tf32=False, fastest=False):
        """The reference, free-running in TF32 or on cuDNN's fastest
        algorithms, as the program's warm-up record."""
        if tf32:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        if fastest:
            torch.backends.cudnn.benchmark = True
            torch.backends.cudnn.deterministic = False
        try:
            return correct.from_reference(cfg, fl.simulate(
                cfg, tr, dev_data, models.ravel(params), state, warm), warm)
        finally:
            program.set_precision(cfg)

    t0 = time.perf_counter()
    prog = warm_snaps(spec, data, start, device)
    line("sound", prog, program_s=time.perf_counter() - t0)
    del prog
    if control:
        line("tf32", in_place(tf32=True))
        line("f32_algos", in_place(fastest=True))
    for f in faults:
        line(f, warm_snaps(spec, data, start, device, hook=plant(f)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--no-control", action="store_true",
                    help="leave out the tf32 and f32_algos readings")
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    spec = harness.resolve(harness.load_json(ROOT / "BENCHMARK.json"),
                           args.workload)
    if not torch.cuda.is_available():
        print("controls: no CUDA device visible", file=sys.stderr)
        return 2
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings_for(spec, seed, torch.device("cuda", 0), faults,
                                 control=not args.no_control):
            print(json.dumps({"workload": args.workload, **line}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
