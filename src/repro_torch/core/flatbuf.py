"""Flat (K, D) update-buffer codec and the server channel buffers.

  * :class:`PytreeCodec` fixes the layout of the model's parameter dict
    once: leaves in sorted-key order (the order ``jax.tree_util`` gives a
    dict), each leaf flattened in its own (row-major) layout, so a flat
    row is element for element the reference's.  On the q8 wire it also
    emits an upload as int8 blocks: pad to ``dq``, add the client's
    error-feedback residual, quantize each ``qblock`` block
    (:func:`repro_torch.kernels.ref.quantize_ref`), and keep what the
    quantization dropped as the new residual.
  * :func:`alloc_buffer` / :func:`write_slot` are the buffered f32
    channel's resident (K, D) rows and their in-place row write;
    :class:`QuantBuffer` is its q8 counterpart (int8 (K, Dq) rows plus
    (K, Dq/qblock) scales).
  * :class:`AccumBuffer` is the streaming channel: two O(D) sum banks
    and the host-side weights of the horizon in flight.

The q4 and topk wires come in a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.quantize import BLOCK as QBLOCK


class PytreeCodec:
    """Flat dict of tensors (the paper CNN's parameters) <-> flat (D,) f32
    vector, leaves in sorted-key order.

    ``qblock`` is the quantization granule (one f32 absmax scale per
    ``qblock`` lanes); ``dq`` is D rounded up to a qblock multiple, the
    padded length of a quantized row, and ``n_qblocks = dq / qblock``."""

    def __init__(self, template: Dict[str, torch.Tensor],
                 qblock: int = QBLOCK):
        self.keys = sorted(template)
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.d = int(self.offsets[-1])
        if qblock < 1:
            raise ValueError(f"qblock={qblock} must be >= 1")
        self.qblock = int(qblock)
        self.n_qblocks = -(-self.d // self.qblock)
        self.dq = self.n_qblocks * self.qblock

    def ravel(self, tree) -> torch.Tensor:
        return torch.cat([tree[k].reshape(-1).to(torch.float32)
                          for k in self.keys])

    def ravel_delta(self, start, end, scale: float) -> torch.Tensor:
        """ravel((start - end) / scale): FedSGD's cumulative gradient
        (Eq. 3) fused with the flatten."""
        return torch.cat([(start[k].reshape(-1).to(torch.float32)
                           - end[k].reshape(-1).to(torch.float32)) / scale
                          for k in self.keys])

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(D,) -> dict of VIEWS into ``flat`` (no copies).  The engine
        never writes a flat params row in place, so the views stay valid
        for as long as anyone holds them."""
        o = self.offsets
        return {k: flat[int(o[i]):int(o[i + 1])].view(shape)
                for i, (k, shape) in enumerate(zip(self.keys, self.shapes))}

    # ---- q8 wire ----

    def _quantize_nores(self, flat: torch.Tensor):
        """(D,) f32 -> int8 (dq,), scales (n_qblocks,)."""
        x = F.pad(flat, (0, self.dq - self.d))
        q, s = ref.quantize_ref(x.view(self.n_qblocks, self.qblock))
        return q.view(self.dq), s

    def _quantize(self, flat: torch.Tensor, residual: torch.Tensor):
        """Error-feedback variant: quantizes input + carried residual and
        also returns the new residual, the quantization error
        x - q*scale rounded once to f32 (the product and the difference
        are exact in f64), which is what the reference's program computes
        once XLA contracts the multiply-subtract into an FMA."""
        x = F.pad(flat, (0, self.dq - self.d)) + residual
        blocks = x.view(self.n_qblocks, self.qblock)
        q, s = ref.quantize_ref(blocks)
        new_res = (blocks.to(torch.float64) - q.to(torch.float64)
                   * s.to(torch.float64)[:, None]).to(torch.float32)
        return q.view(self.dq), s, new_res.view(self.dq)

    def ravel_delta_q8(self, start, end, scale: float,
                       residual: torch.Tensor):
        """Gradient upload on the q8 wire with error feedback -> (q int8
        (dq,), scales (n_qblocks,), new residual (dq,))."""
        return self._quantize(self.ravel_delta(start, end, scale), residual)

    def ravel_delta_q8_nores(self, start, end, scale: float):
        """Gradient upload on the q8 wire, error feedback off."""
        return self._quantize_nores(self.ravel_delta(start, end, scale))

    def ravel_q8_nores(self, tree):
        """Model-weights upload on the q8 wire (no error feedback: weights
        do not accumulate across rounds)."""
        return self._quantize_nores(self.ravel(tree))

    def zero_residual(self, device) -> torch.Tensor:
        """Initial (dq,) error-feedback residual of a client."""
        return torch.zeros(self.dq, dtype=torch.float32, device=device)


def alloc_buffer(k: int, d: int, device) -> torch.Tensor:
    """Preallocate the (K, D) f32 update buffer."""
    return torch.zeros((k, d), dtype=torch.float32, device=device)


def write_slot(buf: torch.Tensor, vec: torch.Tensor, slot: int) -> None:
    """buf[slot] <- vec, in place."""
    buf[slot].copy_(vec)


class AccumBuffer:
    """Double-buffered streaming accumulator: the O(D) replacement for the
    buffered (K, D) channel.

    Holds TWO (1, D) f32 sum banks plus the ingest weights of the horizon
    in flight, in arrival order (the finalize sums them in that order,
    which is the order the buffered kernel sums its (K,) weights in).
    ``fold`` folds one upload into the active bank through the server's
    fold program, which writes the bank row IN PLACE (on CUDA, the
    ``safl_fold`` / ``safl_fold_q8`` kernel with ``out`` = the row), and
    tracks fedasync's survival product P = prod(beta) on the host;
    ``seal`` hands the filled bank to the server round and swaps in the
    spare; ``release`` returns the finalize's zeroed bank as the new
    spare.  Channel memory is 2 * D * 4 bytes (D = dq on the q8 wire),
    flat in the uploads a horizon admits.
    """

    def __init__(self, d: int, fold_fn, device):
        self.d = int(d)
        self.device = device
        self._fold_fn = fold_fn
        self._bank = self._alloc()
        self._spare = self._alloc()
        self._reset_host()

    def _alloc(self) -> torch.Tensor:
        return torch.zeros((1, self.d), dtype=torch.float32,
                           device=self.device)

    def _reset_host(self) -> None:
        self._w: List[np.float32] = []
        self._pprod = np.float32(1.0)
        self.count = 0

    def fold(self, payload: Tuple[torch.Tensor, ...], *, w,
             beta=1.0) -> None:
        """Fold one upload into the active bank: row 0 becomes
        beta*row + w*payload (payload = (vec,) f32 or (q_row, s_row) q8),
        ``w`` the FINAL ingest weight (discount-at-ingest) and ``beta``
        the decay (1.0 except the fedasync mix, where beta = 1 - a_i)."""
        self._bank = self._fold_fn(self._bank, *payload, 0, np.float32(w),
                                   np.float32(beta))
        self._w.append(np.float32(w))
        self._pprod = np.float32(self._pprod * np.float32(beta))
        self.count += 1

    def skip(self) -> None:
        """Count a screened upload without touching the bank: an exact 0.0
        ingest weight keeps ``wvec`` as long as the buffered channel's
        weight vector, so the finalize sums the same weights in the same
        order (adding 0.0 is exact).  Folding with weight 0 instead would
        still poison the bank: 0 x NaN is NaN."""
        self._w.append(np.float32(0.0))
        self.count += 1

    def seal(self):
        """Close the horizon: returns ``(bank, wvec, stats)``, ``wvec`` the
        np.float32 ingest weights in arrival order and ``stats`` the
        horizon's upload count and the survival product ``pprod``, and
        swaps the spare bank in."""
        assert self.count > 0, "seal() on an empty horizon"
        assert self._spare is not None, \
            "seal() before release() of the previous horizon's bank"
        wvec = np.asarray(self._w, np.float32)
        stats = {"count": self.count, "pprod": self._pprod}
        bank = self._bank
        self._bank, self._spare = self._spare, None
        self._reset_host()
        return bank, wvec, stats

    def release(self, zeroed_bank: torch.Tensor) -> None:
        """Return the finalize's zeroed bank as the new spare."""
        self._spare = zeroed_bank


class QuantBuffer:
    """Preallocated q8 update buffer: int8 (K, Dq) rows plus (K, n_qblocks)
    f32 scales, written in place one slot at a time."""

    def __init__(self, k: int, d: int, qblock: int = QBLOCK, *, device):
        self.qblock = int(qblock)
        self.n_qblocks = -(-int(d) // self.qblock)
        self.dq = self.n_qblocks * self.qblock
        self.q = torch.zeros((k, self.dq), dtype=torch.int8, device=device)
        self.scales = torch.zeros((k, self.n_qblocks), dtype=torch.float32,
                                  device=device)

    def write(self, q_vec: torch.Tensor, s_vec: torch.Tensor,
              slot: int) -> None:
        self.q[slot].copy_(q_vec)
        self.scales[slot].copy_(s_vec)

    @property
    def views(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q, scales) as the q8 server step takes them."""
        return self.q, self.scales
