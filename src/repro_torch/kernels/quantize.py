"""Wire formats of the upload channel and their byte accounting.

A copy of the reference's pure-Python part of ``repro/kernels/quantize.py``
(``BLOCK``, ``WIRES``, ``payload_nbytes``), so both packages count the same
bytes for the same upload.  ``BLOCK`` (512) is the quantization granule:
one f32 absmax scale per ``BLOCK`` lanes of a quantized row.
"""
from __future__ import annotations

BLOCK = 512

WIRES = ("f32", "q8", "q4", "topk")


def payload_nbytes(wire: str, *, d: int, dq: int = 0, n_qblocks: int = 0,
                   nk: int = 0, nk_qblocks: int = 0) -> int:
    """Bytes ONE upload payload puts on the wire.

    f32: 4 B/coord over the raw d.  q8: 1 B/coord over the padded dq +
    4 B per scale block.  q4: half a byte per padded coord + the same
    scales.  topk: 4 B index + 1 B value per kept coord + 4 B per scale
    block of the compacted array.
    """
    if wire not in WIRES:
        raise ValueError(f"wire {wire!r} not in {WIRES}")
    if wire == "f32":
        return d * 4
    if wire == "q8":
        return dq + n_qblocks * 4
    if wire == "q4":
        return dq // 2 + n_qblocks * 4
    return nk * 5 + nk_qblocks * 4
