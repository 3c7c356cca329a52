"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload vgg16-ss-f32 --seed 7 \
        --seconds 51 --trace 0

Runs ``repro_torch``'s FL engine on the card (the JAX package is never
imported) and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted`` (rounds in the window), ``failed``
(rounds whose eval was not finite), ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number beside its limit, which also end standard error.  Exits non-zero
with no result when no card is visible, when the card count is short of
the cell's, or when a JAX module was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

# one process with one CPU thread for the host's math: the engine's work
# is on the card, and idle thread pools only contend with the thread
# that launches it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths, so
# that only a cell's first run there builds (the port's own nvcc
# libraries go to build/torch_kernels/ by themselves)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ["PYTHONPATH"] = os.pathsep.join(
    [str(ROOT / "src"), str(ROOT)]
    + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.resolve(manifest, args.workload)
    spec["manifest"] = manifest
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {need} CUDA device(s), {have} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           device, T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    line = harness.result_line(spec, out, bool(args.trace), device)
    print("window: %d rounds in %.3f s, each %s" % (
        out["rounds"], out["window_s"],
        " ".join("%.3f" % s for s in out["rec"]["round_s"])),
        file=sys.stderr)
    print("window eval losses: %s" % " ".join(
        "%.4g" % v for v in out["rec"]["losses"]), file=sys.stderr)
    print("set-up: interpreter and imports %.3f s, inputs by %.3f s, "
          "engine by %.3f s, warm rounds by %.3f s; reference %.3f s" % (
              out["parts"]["start"], out["parts"]["inputs"],
              out["parts"]["engine"], out["setup_s"],
              out["parts"]["reference"]), file=sys.stderr)
    t = out["rec"].get("trace")
    if t is not None:
        print("trace: %d device records, busy %.3f s of %.3f s, server "
              "calls %s, their kernels %s s, synchronizes matched: %s" % (
                  t["device_events"], t["busy_s"], t["window_s"],
                  t["server_calls"], t["server_kernel_s"], t["sync_match"]),
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
