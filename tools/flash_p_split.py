"""Which cause sets the bf16 flash kernel's floor against its plain
version: the split of p into two bf16 terms, or the f32 plain version's
own rounding.  Needs a GPU and nvcc.

At the serving path's prefill shape (B 8, S 1024, H 16, Hkv 8, hd 128,
bf16, causal; ``chip_smoke.FLASH_SHAPES[3]``), on bf16 inputs drawn as
``chip_smoke.py`` phase 3 draws them, each of

  * the package's kernel (``csrc/flash_attention.cu``: p = p_hi + p_lo +
    p_lo2, three ``wgmma`` a 16-key step),
  * its parent design (``csrc/flash_variants.cu``: p = p_hi + p_lo, two
    ``wgmma`` a 16-key step),
  * the f32 plain version (``kernels.ref.flash_attention_ref``), and
  * the plain version with p rounded to bf16
    (``chip_smoke.flash_plain_bf16_p``)

is held against the same attention computed in f64 on the same inputs
(:func:`attention_f64`; the plain version casts to f32): the share of bf16 output lanes that are not the bf16 nearest the
f64 answer, and the largest |output - f64 answer|; then the share of
lanes where each kernel differs from the f32 plain version (phase 3's
reading), and the two kernels' times, in turns (two-term, three-term,
three-term, two-term; phase 4's timer: L2 flushed, the device held).
On one H100 two terms put 0.2255 % of the lanes off, three 0.1034 %,
the f32 plain version 0.0343 %, p in bf16 41.95 %.

Run from the repo root: ``PYTHONPATH=src python tools/flash_p_split.py``.
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def nearest_bf16(x64: torch.Tensor) -> torch.Tensor:
    """The bf16 nearest each f64 value (ties to even): the bf16 of its
    f32 rounding and that bf16's two neighbours, the closest taken (an f32
    rounding onto a bf16 midpoint would round twice)."""
    b = x64.float().bfloat16()
    bits = b.view(torch.int16)
    cands = [b, (bits - 1).view(torch.bfloat16), (bits + 1).view(
        torch.bfloat16)]
    dist = torch.stack([(c.double() - x64).abs() for c in cands])
    best = dist.argmin(dim=0)
    out = torch.where(best == 1, cands[1], cands[0])
    return torch.where(best == 2, cands[2], out)


def attention_f64(q, k, v):
    """The causal GQA attention of bf16 ``q``, ``k``, ``v`` in f64 (every
    bf16 input exact in f64): the answer the others are held to."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).double()
    v = torch.repeat_interleave(v, rep, dim=2).double()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) / np.sqrt(hd)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def parent_call(lib, q, k, v):
    """The parent library's bf16 entry on q, k, v (the package wrapper's
    arguments)."""
    fn = lib.flash_attention_bf16
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    B, S, H, hd = q.shape
    out = torch.empty_like(q)

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, k.shape[2], hd, 1, float(np.float32(np.sqrt(hd))),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_variants: launch failed ({rc})")
        return out
    return call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tools/flash_p_split.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    print(smi)
    info = build.compile_source("flash_variants")
    print(f"built csrc/flash_variants.cu in {info['seconds']:.1f} s")
    spilled = cs.spills(info["log"], cs.FLASH_SYMBOL)
    print(f"  {cs.FLASH_SYMBOL} (two terms): spill bytes "
          f"{sorted(spilled.values())}")
    lib = ctypes.CDLL(info["path"])
    shape = cs.FLASH_SHAPES[3]
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = cs.flash_inputs(torch, shape, torch.bfloat16, g)
    two = parent_call(lib, q, k, v)
    outs = {
        "kernel, two terms": two().clone(),
        "kernel, three terms": fa.flash_attention(q, k, v),
        "plain f32": fa.flash_attention_plain(q, k, v),
        "plain, p in bf16": cs.flash_plain_bf16_p(torch, q, k, v),
    }
    ans = attention_f64(q, k, v)
    near = nearest_bf16(ans)
    pre = fa.flash_attention_plain(q.float(), k.float(), v.float())
    rows = {}
    for name, out in outs.items():
        rows[name] = dict(
            off_f64=float((out != near).double().mean()),
            max_abs_err=float((out.double() - ans).abs().max()),
            differs_from_plain_f32=float(
                (out != outs["plain f32"]).double().mean()))
        print(f"  {name}: lanes not the bf16 nearest the f64 answer "
              f"{rows[name]['off_f64']:.4%}, max|out - f64| "
              f"{rows[name]['max_abs_err']:.3e}, lanes differing from the "
              f"f32 plain version {rows[name]['differs_from_plain_f32']:.4%}")
    pre_err = float((pre.double() - ans).abs().max())
    print(f"  the f32 plain version before its bf16 output rounding: "
          f"max|out - f64| {pre_err:.3e}; |f64 answer| max "
          f"{float(ans.abs().max()):.3e}")
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
    times = {"kernel, two terms": [], "kernel, three terms": []}
    order = ("kernel, two terms", "kernel, three terms",
             "kernel, three terms", "kernel, two terms")
    fns = {"kernel, two terms": two,
           "kernel, three terms": lambda: fa.flash_attention(q, k, v)}
    for name in order:
        times[name].append(cs.time_ms(torch, fns[name], flush, hold=True))
    for name, ts in times.items():
        print(f"  {name}: {ts[0]:.5f} / {ts[1]:.5f} ms (median of "
              f"{cs.TIMED_LAUNCHES} launches, two turns) {smi}")
    print(json.dumps({"flash_p_split": rows, "plain_f32_pre_round_err":
                      pre_err, "ms": times, "shape": list(shape),
                      "smi": smi}))


if __name__ == "__main__":
    main()
