"""The yardstick's arithmetic, frozen here so that the program's own
copies may change without moving it:

  * the wall split of a round (the phase-6 split of ``chip_smoke.py``):
    the engine's methods wrapped, each call's host seconds to a
    ``torch.cuda.synchronize()`` added to its bucket;
  * the union of device intervals (the phase-6b busy-share merge);
  * the bytes of the server's logical aggregation operation, counted from
    its shapes as ``PERF.md`` section 6's Bound column counts them: each
    input byte read once and each output byte written once, at the
    wire's width;
  * the model FLOPs of one forward pass of a sample, from the model's
    shapes.

The card's peaks are in the readers that divide by them
(``bench/metrics/``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

#: the wall split's buckets: the engine's methods timed into each (the
#: sequential engine's, then the batched engine's)
SPLIT = {"client_train": ("_run_local", "_train_wave"),
         "server_ingest": ("_enqueue_upload", "_payload_rows",
                           "_ingest_wave"),
         "server_round": ("_aggregate",),
         "eval": ("_eval_and_record", "_eval_round")}


def precision_now() -> str:
    """The precision float32 matmuls and convolutions compute in under
    the process's current flags."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    return "tf32" if tf32 else "f32"


def sync(device, marks: Dict = None, tag=None) -> None:
    """``torch.cuda.synchronize`` (nothing on the CPU); while
    ``marks["on"]``, ``tag`` is logged in ``marks["syncs"]``, so the
    device trace's synchronize records can be matched to the calls that
    made them, one for one (the engine never synchronizes itself)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if marks is not None and marks["on"] and tag is not None:
            marks["syncs"].append(tag)


def new_marks() -> Dict:
    """A holder of call marks: while ``on``, each timed call appends its
    label to ``calls`` and its two synchronizes, ``("pre", i)`` and
    ``("post", i)``, to ``syncs``."""
    return {"on": False, "calls": [], "syncs": []}


def wrap_timed(obj, method: str, label: str, acc: Dict[str, float],
               device, marks: Dict = None) -> None:
    """Wrap ``obj.<method>`` so that each call runs between two
    synchronizes and adds its host seconds to ``acc[label]``; while
    ``marks["on"]`` the call and its synchronizes are logged."""
    inner = getattr(obj, method)

    def wrapper(*a, **kw):
        i = None
        if marks is not None and marks["on"]:
            i = len(marks["calls"])
            marks["calls"].append(label)
        sync(device, marks, None if i is None else ("pre", i))
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        sync(device, marks, None if i is None else ("post", i))
        acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
        return out

    setattr(obj, method, wrapper)


def wrap_split(eng, device, marks: Dict = None) -> Dict[str, float]:
    """The wall split on ``eng``: a dict of bucket -> seconds that fills
    as the engine runs."""
    acc = dict.fromkeys(SPLIT, 0.0)
    for bucket, methods in SPLIT.items():
        for m in methods:
            wrap_timed(eng, m, bucket, acc, device, marks)
    return acc


def merged(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def wire_row_bytes(wire: str, d: int, qblock: int) -> int:
    """Bytes of one upload's payload on the wire: f32 lanes, or the
    padded int8 / packed int4 lanes and one f32 scale a block."""
    dq = -(-d // qblock) * qblock
    if wire == "f32":
        return 4 * d
    if wire == "q8":
        return dq + 4 * (dq // qblock)
    if wire == "q4":
        return dq // 2 + 4 * (dq // qblock)
    raise ValueError(f"wire {wire!r}")


def agg_bytes(call: str, wire: str, d: int, *, k: int = 1,
              mode: str = "fedsgd", qblock: int = 512) -> int:
    """Bytes of one server call's logical operation:

      * ``fold``: the bank read and written once (f32 lanes: D on the f32
        wire, the padded Dq on a quantized one), the upload read once;
      * ``step`` (the buffered aggregate): the K rows read once, the
        global row read once (FedSGD), the new (D,) row written once;
      * ``finalize`` (the streaming round's step from the bank's sum):
        the sum's D lanes and the global row (FedSGD) read once, the new
        row written once.
    """
    dq = -(-d // qblock) * qblock
    p_read = 4 * d if mode == "fedsgd" else 0
    if call == "fold":
        bank = 4 * (d if wire == "f32" else dq)
        return 2 * bank + wire_row_bytes(wire, d, qblock)
    if call == "step":
        return k * wire_row_bytes(wire, d, qblock) + p_read + 4 * d
    if call == "finalize":
        return 4 * d + p_read + 4 * d
    raise ValueError(f"call {call!r}")


def forward_flops(cfg: Dict) -> int:
    """FLOPs of one forward pass of one sample: 2 per multiply-add of
    every convolution and dense layer (normalizations, activations and
    pools are not counted, as model FLOPs are)."""
    h, w, c = cfg["image"]
    total = 0

    def conv(side, cin, cout, k, stride):
        out = -(-side // stride)
        return out, 2 * out * out * cout * cin * k * k

    if cfg["family"] == "resnet18":
        side, f = conv(h, c, cfg["width"], 3, 1)
        total += f
        c = cfg["width"]
        for cout, stride in cfg["stages"]:
            for bi in range(cfg["blocks_per_stage"]):
                s = stride if bi == 0 else 1
                out, f1 = conv(side, c, cout, 3, s)
                _, f2 = conv(out, cout, cout, 3, 1)
                total += f1 + f2
                if s != 1 or c != cout:
                    total += conv(side, c, cout, 1, s)[1]
                side, c = out, cout
        total += 2 * c * cfg["n_classes"]
    else:
        side = h
        for item in cfg["plan"]:
            if item == "M":
                side //= 2
                continue
            cout = max(8, int(item * cfg["width_mult"]))
            total += conv(side, c, cout, 3, 1)[1]
            c = cout
        widths = [side * side * c] + list(cfg["dense"]) + [cfg["n_classes"]]
        total += sum(2 * a * b for a, b in zip(widths, widths[1:]))
    return total
