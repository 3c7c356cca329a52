"""Flat (K, D) update-buffer codec and the f32 server channel buffers.

  * :class:`PytreeCodec` fixes the layout of the model's parameter dict
    once: leaves in sorted-key order (the order ``jax.tree_util`` gives a
    dict), each leaf flattened in its own (row-major) layout, so a flat
    row is element for element the reference's.
  * :func:`alloc_buffer` / :func:`write_slot` are the buffered channel's
    resident (K, D) rows and their in-place row write.
  * :class:`AccumBuffer` is the streaming channel: two O(D) sum banks
    and the host-side weights of the horizon in flight.

Only the f32 wire is ported; the q8/q4/topk wires and their buffers
come in a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class PytreeCodec:
    """Flat dict of tensors (the paper CNN's parameters) <-> flat (D,) f32
    vector, leaves in sorted-key order."""

    def __init__(self, template: Dict[str, torch.Tensor]):
        self.keys = sorted(template)
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.d = int(self.offsets[-1])

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
    ``safl_fold`` kernel with ``out`` = the row); ``seal`` hands the
    filled bank to the server round and swaps in the spare; ``release``
    returns the finalize's zeroed bank as the new spare.  Channel memory
    is 2 * D * 4 bytes, flat in the uploads a horizon admits.
    """

    def __init__(self, d: int, fold_fn, device):
        self.d = int(d)
        self.device = device
        self._fold_fn = fold_fn
        self._bank = self._alloc()
        self._spare = self._alloc()
        self._w: List[np.float32] = []

    def _alloc(self) -> torch.Tensor:
        return torch.zeros((1, self.d), dtype=torch.float32,
                           device=self.device)

    def fold(self, payload: Tuple[torch.Tensor, ...], *, w) -> None:
        """Fold one upload into the active bank: row 0 becomes
        row + w*payload, ``w`` the FINAL ingest weight (discount-at-
        ingest)."""
        self._bank = self._fold_fn(self._bank, *payload, 0, np.float32(w))
        self._w.append(np.float32(w))

    def seal(self):
        """Close the horizon: returns ``(bank, wvec)``, ``wvec`` the
        np.float32 ingest weights in arrival order, and swaps the spare
        bank in."""
        assert self._w, "seal() on an empty horizon"
        assert self._spare is not None, \
            "seal() before release() of the previous horizon's bank"
        bank, wvec = self._bank, np.asarray(self._w, np.float32)
        self._bank, self._spare = self._spare, None
        self._w = []
        return bank, wvec

    def release(self, zeroed_bank: torch.Tensor) -> None:
        """Return the finalize's zeroed bank as the new spare."""
        self._spare = zeroed_bank
