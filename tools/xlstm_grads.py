"""Where xlstm-125m's training gradients part between the card and the
CPU (``chip_smoke.py`` phase 8c: the reduced config, B 4 x S 64 of the
synthetic stream from ``default_rng(0)``, 2 steps, the card updated with
the CPU's gradients).  Needs a GPU.

  1. leaves: each parameter leaf's gradient, card against CPU, over the
     CPU's largest |value| of that leaf (phase 8c's reading);
  2. blocks: the gradient of each block's output (the mLSTM and sLSTM
     blocks in order, hooked on their outputs) and the output itself,
     the same way;
  3. ops: every op of the forward whose output takes a gradient, grouped
     by its source line in ``models/`` (the largest reading over the
     sLSTM's time steps), its output and its output's gradient, card
     against CPU; and each op alone: re-run on the card on the CPU run's
     inputs (its first, middle and last call), and its vector-Jacobian
     product with the CPU run's output gradient: the op's own
     difference, without what reaches it from upstream.  The 14 largest
     by their own difference are printed, then the mLSTM block's ops in
     call order with their outputs' gradient readings (where its
     backward grows the difference).

Run from the repo root: ``PYTHONPATH=src python tools/xlstm_grads.py``.
"""
import json
import os
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from repro_torch import tree as treemod  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import build_model, xlstm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

MODELS = os.path.join("repro_torch", "models")
#: the device held against the CPU
DEVICE = "cuda"


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| over max|b| (b the CPU's)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _site() -> str:
    """The innermost calling line in the model's sources."""
    f = sys._getframe(2)
    while f is not None:
        if MODELS in f.f_code.co_filename:
            return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class Tape(TorchFunctionMode):
    """Every call whose output is a float tensor that takes a gradient:
    (block label, site, func, inputs, output, and its gradient once the
    backward has run), in call order."""

    def __init__(self):
        super().__init__()
        self.block = "top"
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and out.requires_grad):
            rec = dict(block=self.block, site=_site(),
                       name=getattr(func, "__name__", str(func)),
                       func=func, args=args, kwargs=kwargs or {},
                       out=out.detach().clone(), grad=None)
            self.calls.append(rec)
            out.register_hook(lambda g, rec=rec: rec.__setitem__(
                "grad", g.detach().clone()))
        return out


def labelled(tape, blocks):
    """Patch the two block functions so the tape labels their ops and
    ``blocks`` keeps each block's output and its gradient."""
    real = {"mlstm_block": xlstm.mlstm_block, "slstm_block": xlstm.slstm_block}

    def wrap(name):
        def block(*args, **kwargs):
            label = f"{name[0]}{sum(b['kind'] == name for b in blocks)}"
            tape.block = label
            x, state = real[name](*args, **kwargs)
            tape.block = "top"
            rec = dict(kind=name, label=label, out=x.detach().clone(),
                       grad=None)
            blocks.append(rec)
            x.register_hook(lambda g: rec.__setitem__("grad",
                                                      g.detach().clone()))
            return x, state
        return block
    for name in real:
        setattr(xlstm, name, wrap(name))

    def undo():
        for name, fn in real.items():
            setattr(xlstm, name, fn)
    return undo


def traced_grads(model, params, batch):
    """(grads, blocks, tape) of one value_and_grad, recorded."""
    tape, blocks = Tape(), []
    undo = labelled(tape, blocks)
    try:
        with tape:
            (_, _), grads = steps.value_and_grad(model.train_loss)(params,
                                                                   batch)
    finally:
        undo()
    return grads, blocks, tape


def op_alone(rec):
    """The CPU call ``rec`` re-run on the card on the same inputs, and its
    VJP with the recorded output gradient: (output reading, VJP reading
    over the inputs that take a gradient)."""
    def move(x, dev):
        if isinstance(x, torch.Tensor):
            t = x.detach().to(dev)
            return t.requires_grad_(x.requires_grad and t.is_floating_point())
        if isinstance(x, (list, tuple)):
            return type(x)(move(y, dev) for y in x)
        return x
    outs = {}
    for dev in ("cpu", DEVICE):
        args = move(rec["args"], dev)
        with torch.enable_grad():
            out = rec["func"](*args, **rec["kwargs"])
            ins = [a for a in args if isinstance(a, torch.Tensor)
                   and a.requires_grad]
            vjp = (torch.autograd.grad(out, ins, rec["grad"].to(dev),
                                       allow_unused=True)
                   if ins and rec["grad"] is not None else [])
        outs[dev] = (out, [g for g in vjp if g is not None])
    (oc, vc), (og, vg) = outs["cpu"], outs[DEVICE]
    return rel(og, oc), max((rel(a, b) for a, b in zip(vg, vc)), default=0.0)


def main():
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tools/xlstm_grads.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    print(smi)
    cfg = reduced_config(get_config("xlstm-125m"))
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=cs.TRAIN_LR)
    p_cpu = model.init_params(prng_key(0), "cpu")
    p_gpu = treemod.tree_map(lambda x: x.to(DEVICE), p_cpu)
    s_cpu, s_gpu = opt.init(p_cpu), opt.init(p_gpu)
    B, S = cs.TRAIN_REDUCED_SHAPE
    rng = np.random.default_rng(0)
    report = []
    for step in range(cs.TRAIN_REDUCED_STEPS):
        data = train.add_extras(train.synthetic_lm_batch(
            rng, cfg.vocab_size, B, S), cfg, rng)
        gc_, bc, tc_ = traced_grads(model, p_cpu, train.to_device(data,
                                                                  "cpu"))
        gg, bg, tg = traced_grads(model, p_gpu, train.to_device(data,
                                                                DEVICE))
        leaves = sorted(((rel(a, b), path) for path, a, b in zip(
            treemod.tree_paths(gc_), treemod.tree_leaves(gg),
            treemod.tree_leaves(gc_))), reverse=True)
        print(f"step {step}: the largest leaf readings (card vs CPU, over "
              "the leaf's largest): " + ", ".join(
                  f"{name} {r:.3e}" for r, name in leaves[:6]))
        blocks = [dict(block=c["label"], out=rel(g["out"], c["out"]),
                       grad=rel(g["grad"], c["grad"]))
                  for c, g in zip(bc, bg)]
        for b in blocks:
            print(f"  block {b['block']}: output {b['out']:.3e}, its "
                  f"gradient {b['grad']:.3e}")
        if len(tc_.calls) != len(tg.calls):
            raise SystemExit("the card and the CPU recorded other op "
                             "sequences")
        sites = {}
        for c, g in zip(tc_.calls, tg.calls):
            if c["site"] == "?":  # the leaves made differentiable
                continue
            key = (c["block"][0], c["site"], c["name"])
            r = sites.setdefault(key, dict(out=0.0, grad=0.0, recs=[]))
            r["recs"].append(c)
            r["out"] = max(r["out"], rel(g["out"], c["out"]))
            if c["grad"] is not None and g["grad"] is not None:
                r["grad"] = max(r["grad"], rel(g["grad"], c["grad"]))
        rows = []
        for (kind, site, name), r in sites.items():
            recs = r["recs"]
            # the first, middle and last call (the sLSTM's time steps)
            alone = [op_alone(c) for c in {id(c): c for c in (
                recs[0], recs[len(recs) // 2], recs[-1])}.values()]
            rows.append(dict(block=kind, site=site, op=name,
                             calls=len(recs), out=r["out"], grad=r["grad"],
                             alone_out=max(a for a, _ in alone),
                             alone_vjp=max(v for _, v in alone)))
        rows.sort(key=lambda x: -max(x["alone_out"], x["alone_vjp"]))
        for x in rows[:14]:
            print(f"  op {x['block']} {x['site']} {x['op']} x{x['calls']}: "
                  f"alone on the CPU's inputs: output {x['alone_out']:.3e}, "
                  f"VJP {x['alone_vjp']:.3e}; in the run: output "
                  f"{x['out']:.3e}, its gradient {x['grad']:.3e}")
        rows = rows[:14]
        # where the mLSTM block's backward grows the reading: its ops in
        # call order (the backward runs them last to first)
        chain = [dict(site=c["site"], op=c["name"],
                      grad=rel(g["grad"], c["grad"]))
                 for c, g in zip(tc_.calls, tg.calls)
                 if c["block"] == "m0" and c["grad"] is not None]
        print("  the mLSTM block's ops in call order, each output's "
              "gradient reading: " + ", ".join(
                  f"{x['site']} {x['op']} {x['grad']:.1e}" for x in chain))
        report.append(dict(step=step, leaves=leaves[:6], blocks=blocks,
                           ops=rows, mlstm_chain=chain))
        p_cpu, s_cpu = opt.update(p_cpu, gc_, s_cpu, step)
        p_gpu, s_gpu = opt.update(
            p_gpu, treemod.tree_map(lambda x: x.to(DEVICE), gc_), s_gpu,
            step)
    print(json.dumps({"xlstm_grads": report, "smi": smi}, default=str))


if __name__ == "__main__":
    main()
