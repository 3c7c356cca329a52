"""Dry run of every (architecture x input shape) on the production meshes
(the reference's ``repro/launch/dryrun.py``), on the meta device: no
weights, no data, no GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
      --shape train_4k --mesh single            # one pair
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --mesh single,multi                       # the full matrix

Writes one JSON per (arch, shape, mesh[, variant]) into ``--out``
(``experiments/dryrun_torch``).

The reference lowers and compiles each step for a 256- or 512-chip TPU
mesh and reads XLA's memory analysis and its HLO (``hlo_cost``).  The
port has no partitioner and no HLO.  Each pair here builds the same step
(``make_train_step``; on the multi-pod mesh ``make_fl_train_step``,
``inner_steps = 4`` for fedavg; ``make_prefill_step``;
``make_decode_step``) over meta stand-ins of its arguments
(:mod:`repro_torch.launch.specs`), runs it once under the cost counter
(:func:`repro_torch.launch.cost.analyze`) and records:

  * the reference's keys where the port computes the same quantity:
    ``arch``, ``shape``, ``mesh`` (axis -> size), ``status``, ``kind``,
    ``family``, ``fl_aggregation``, ``window``, ``capacity``,
    ``model_flops``, and ``memory.argument_size_B`` /
    ``memory.output_size_B``: per device, exact from the specs
    (:mod:`repro_torch.sharding.rules`).  The step number and the decode
    position are host integers in the port, not arguments (4 bytes each
    in the reference's).  Outputs take the spec of what they update
    (params, optimizer state, caches), logits their batch's spec, the
    metrics none;
  * its own keys where the quantity differs: ``trace_s``,
    ``flops_global`` (the whole step's; ``flops_per_device`` divides it
    by the chips, which assumes an even split: GSPMD's replicated work is
    not visible here), ``useful_flops_ratio`` (``model_flops /
    flops_global``), ``op_bytes_global`` / ``op_bytes_per_device`` (the
    eager op-by-op traffic, :mod:`repro_torch.launch.cost`),
    ``peak_live_B_global``, and ``collective_bytes`` per device: only the
    payloads that the specs fix, the pod-axis FL aggregation (one
    all-reduce a round of each device's f32 parameter shard under
    fedavg, gradient shard under fedsgd) and the data-axis gradient
    all-reduce of each leaf not sharded on "data" (one a gradient
    evaluation).  ``not_counted`` lists what has no value here;
    ``roofline`` and ``bottleneck`` use the H100's constants
    (:mod:`repro_torch.launch.mesh`), each collective payload at its
    axis's link rate (``collective_s_assumes`` says which).

A variant whose field the port's models do not read is refused by name.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import cost
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, axis_bw,
                                     make_production_mesh, mesh_chips)
from repro_torch.launch.steps import (make_decode_step, make_fl_train_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.sharding.rules import (Spec, batch_spec, cache_specs,
                                        map_with_path, param_specs)

#: what the reference's record holds and the port cannot know
NOT_COUNTED = (
    "memory.temp_size_B: XLA's buffer assignment (peak_live_B_global is "
    "the eager step's live storages, not a per-device temp size)",
    "model-axis activation traffic (GSPMD's partitioning of the layers)",
    "FSDP all-gathers of params and reduce-scatters of gradients")


def build_pair(cfg, shape, mesh, *, fl_aggregation: str = "fedsgd"):
    """-> (step fn, its args, (arg specs, out specs), meta) for one (cfg,
    shape, mesh); ``shape`` an ``INPUT_SHAPES`` name or an
    :class:`InputShape`.  ``out specs(out)`` maps the step's output to
    its spec tree."""
    sh = S.input_shape(shape)
    model = build_model(cfg)
    params = S.param_structs(model)
    pspecs = param_specs(params, cfg, mesh)
    meta = {"arch": cfg.name, "shape": sh.name, "mesh": dict(mesh.shape),
            "kind": sh.kind, "family": cfg.family}

    if sh.kind == "train":
        batch, bspecs = S.train_batch_structs(cfg, sh, mesh)
        if "pod" in mesh.shape:
            n_pods = mesh.shape["pod"]
            inner = 4 if fl_aggregation == "fedavg" else 1
            step_fn, opt = make_fl_train_step(
                model, cfg, aggregation=fl_aggregation, inner_steps=inner)
            params = S.stack_structs(params, n_pods)
            pspecs = S.prepend_pod(pspecs)
            weights = torch.empty((n_pods,), dtype=torch.float32,
                                  device=S.META)
            ostate = opt.init(params)
            args = (params, ostate, batch, 0, weights)
            arg_specs = (pspecs, {k: pspecs for k in ostate}, bspecs, None,
                         None)
            meta["fl_aggregation"] = fl_aggregation
            meta["inner_steps"] = inner
        else:
            step_fn, opt = make_train_step(model, cfg)
            ostate = opt.init(params)
            args = (params, ostate, batch, 0)
            arg_specs = (pspecs, {k: pspecs for k in ostate}, bspecs, None)
        out_specs = lambda out: (arg_specs[0], arg_specs[1], None)  # noqa

    elif sh.kind == "prefill":
        batch, bspecs = S.prompt_batch_structs(cfg, sh.global_batch,
                                               sh.seq_len, mesh)
        step_fn = make_prefill_step(model)
        args = (params, batch)
        arg_specs = (pspecs, bspecs)
        out_specs = lambda out: (  # noqa: E731
            batch_spec(mesh) + (None,), cache_specs(
                out[1], mesh, sh.global_batch))

    else:  # decode
        cache, cspecs, pos, capacity = S.decode_cache_structs(
            cfg, model, sh, mesh)
        win = S.decode_window(cfg, sh)
        step_fn = make_decode_step(model, window=win)
        B = sh.global_batch
        dsize = mesh.shape.get("data", 1)
        tok_spec = Spec(("data",) if B % dsize == 0 and B >= dsize
                        else (None,))
        tokens = torch.empty((B,), dtype=torch.int32, device=S.META)
        args = (params, cache, tokens, pos)
        arg_specs = (pspecs, cspecs, tok_spec, None)
        out_specs = lambda out: (tok_spec + (None,), cspecs)  # noqa: E731
        meta["window"] = win
        meta["capacity"] = capacity
    return step_fn, args, (arg_specs, out_specs), meta


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train; forward
    only (2*N*D) for serving shapes; decode D = new tokens = batch."""
    sh = S.input_shape(shape)
    params = S.param_structs(build_model(cfg))
    sizes = []

    def one(path, leaf):
        n = leaf.numel()
        if cfg.family == "moe" and re.search(r"moe\.w[123]$", path):
            # active params: expert tables at their top_k/E fraction
            n = n * cfg.top_k // cfg.n_experts
        sizes.append(n)

    map_with_path(one, params)
    n_active = sum(sizes)
    if sh.kind == "train":
        return 6.0 * n_active * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n_active * sh.global_batch * sh.seq_len
    return 2.0 * n_active * sh.global_batch  # decode: one token per seq


def _bytes(tree, spec_tree, mesh) -> int:
    """Per-device bytes of the tensors of a tuple of trees (host ints and
    spec-less trees: replicated)."""
    return sum(S.tree_bytes(t, s, mesh) for t, s in zip(tree, spec_tree)
               if t is not None and not isinstance(t, int))


#: the mesh axis each payload of :func:`collective_bytes` crosses
COLLECTIVE_AXIS = {"data_all_reduce": "data", "pod_all_reduce": "pod"}
COLLECTIVE_S_ASSUMES = (
    "each payload at one direction's link rate a device over its axis "
    "(launch.mesh.axis_bw): NVLink 4 inside an 8-GPU node, a 400 Gb/s "
    "InfiniBand port a GPU across nodes; the pod axis crosses sites in "
    "the paper's setting, which is slower still")


def collective_bytes(args, arg_specs, meta, mesh) -> Dict[str, int]:
    """The per-device payloads that the specs fix (the module's
    docstring): ``pod_all_reduce`` and ``data_all_reduce``."""
    if meta["kind"] != "train":
        return {}
    out = {}
    grads, f32 = [], []
    for p, spec in S.with_specs(args[0], arg_specs[0]):
        # a device's shard (of its own pod's params on the multi-pod
        # mesh: the pod axis's local size is 1)
        local = math.prod(S.local_shape(p.shape, spec, mesh))
        f32.append(local * 4)
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        if "data" not in axes and mesh.shape.get("data", 1) > 1:
            grads.append(local * p.element_size())
    evals = meta.get("inner_steps", 1)
    if grads:
        out["data_all_reduce"] = sum(grads) * evals
    if "pod" in mesh.shape:
        out["pod_all_reduce"] = sum(f32)
    return out


def measure(cfg, shape, mesh, *, fl_aggregation: str = "fedsgd") -> Dict:
    """One pair's record (the module's docstring); raises on failure."""
    t0 = time.time()
    step_fn, args, (arg_specs, out_specs), meta = build_pair(
        cfg, shape, mesh, fl_aggregation=fl_aggregation)
    res = cost.analyze(step_fn, *args)
    trace_s = time.time() - t0
    chips = mesh_chips(mesh)
    flops = float(res["flops"])
    op_bytes = float(res["bytes"])
    coll = collective_bytes(args, arg_specs, meta, mesh)
    mf = model_flops(cfg, shape)
    out = res["out"]
    rec = {
        **meta, "status": "OK", "trace_s": round(trace_s, 1),
        "model_flops": mf,
        "flops_global": flops, "flops_per_device": flops / chips,
        "flops_per_device_assumes": "an even split over the chips: "
        "GSPMD's replicated work is not visible here",
        "useful_flops_ratio": mf / flops if flops else None,
        "op_bytes_global": op_bytes, "op_bytes_per_device": op_bytes / chips,
        "peak_live_B_global": res["peak_live_B"],
        "collective_bytes": coll,
        "memory": {"argument_size_B": _bytes(args, arg_specs, mesh),
                   "output_size_B": _bytes(out, out_specs(out), mesh)},
        "not_counted": list(NOT_COUNTED),
        "roofline": {"compute_s": flops / chips / PEAK_FLOPS_BF16,
                     "memory_s": op_bytes / chips / HBM_BW,
                     "collective_s": sum(
                         n / axis_bw(mesh, COLLECTIVE_AXIS[k])
                         for k, n in coll.items())},
        "collective_s_assumes": COLLECTIVE_S_ASSUMES,
    }
    r = rec["roofline"]
    rec["bottleneck"] = max(r, key=r.get)
    return rec


def run_pair(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             fl_aggregation: str = "fedsgd", variant_cfg=None,
             tag: str = "") -> Dict:
    cfg = variant_cfg or get_config(arch)
    sh = INPUT_SHAPES[shape_name]
    if sh.kind == "decode" and not cfg.supports_long_decode \
            and shape_name == "long_500k":
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "SKIP",
               "reason": "enc-dec speech model has no 500k-token "
                         "autoregressive decode"}
        _dump(rec, out_dir, arch, shape_name, mesh_kind, tag)
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        rec = measure(cfg, shape_name, mesh, fl_aggregation=fl_aggregation)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    _dump(rec, out_dir, arch, shape_name, mesh_kind, tag)
    return rec


def _dump(rec: Dict, out_dir: str, arch: str, shape: str, mesh_kind: str,
          tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


# the reference's §Perf variants: named config transforms on the baseline
VARIANTS = {
    "": lambda c: c,
    "online": lambda c: dataclasses.replace(c, attn_impl="online"),
    "online_kv2048": lambda c: dataclasses.replace(
        c, attn_impl="online", attn_kv_chunk=2048),
    "online_kv512": lambda c: dataclasses.replace(
        c, attn_impl="online", attn_kv_chunk=512),
    "moebf16": lambda c: dataclasses.replace(
        c, moe_dispatch_dtype="bfloat16"),
    "online_moebf16": lambda c: dataclasses.replace(
        c, attn_impl="online", moe_dispatch_dtype="bfloat16"),
    "online_moebf16_g256": lambda c: dataclasses.replace(
        c, attn_impl="online", moe_dispatch_dtype="bfloat16",
        moe_group_size=256),
    "moescatter": lambda c: dataclasses.replace(
        c, moe_dispatch_impl="scatter"),
    "online_moescatter": lambda c: dataclasses.replace(
        c, attn_impl="online", moe_dispatch_impl="scatter"),
    "seqchunk4096": lambda c: dataclasses.replace(c, attn_chunk=4096),
    "unroll": lambda c: dataclasses.replace(c, scan_layers=False),
    "unroll_megatron": lambda c: dataclasses.replace(
        c, scan_layers=False, sharding="megatron"),
    "attn_norep": lambda c: c,  # grouped-GQA decode (the default; a tag)
    "chunk1024": lambda c: dataclasses.replace(c, attn_chunk=1024),
}

#: config fields that no model of the port reads: its layers are a
#: Python loop over the stack, scanned or not
UNREAD_FIELDS = ("scan_layers",)


def variant_config(name: str, cfg):
    """``VARIANTS[name]`` applied to ``cfg``; raises ``ValueError`` naming
    a field it changes that the port's models do not read."""
    out = VARIANTS[name](cfg)
    changed = [f for f in UNREAD_FIELDS
               if getattr(out, f) != getattr(cfg, f)]
    if changed:
        raise ValueError(f"variant {name!r} sets {', '.join(changed)}, "
                         "which the port's models do not read")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl-aggregation", default="fedsgd")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="", choices=list(VARIANTS))
    args = ap.parse_args(argv)

    # explicit --arch/--shape take precedence over --all
    archs = args.arch.split(",") if args.arch not in (None, "all") \
        else list(ARCHS)
    shapes = args.shape.split(",") if args.shape not in (None, "all") \
        else list(INPUT_SHAPES)
    meshes = args.mesh.split(",")
    try:
        vcfgs = {arch: variant_config(args.variant, get_config(arch))
                 if args.variant else None for arch in archs}
    except ValueError as e:
        ap.error(str(e))

    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                t0 = time.time()
                rec = run_pair(arch, shape, mk, args.out,
                               fl_aggregation=args.fl_aggregation,
                               variant_cfg=vcfgs[arch],
                               tag=args.tag or args.variant)
                status = rec["status"]
                extra = rec.get("bottleneck", rec.get("reason",
                                rec.get("error", "")))
                print(f"[{status}] {arch} x {shape} x {mk} "
                      f"({time.time()-t0:.0f}s) {str(extra)[:120]}",
                      flush=True)


if __name__ == "__main__":
    main()
