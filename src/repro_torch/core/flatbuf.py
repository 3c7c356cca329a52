"""Flat (K, D) update-buffer codec and the server channel buffers.

  * :class:`PytreeCodec` fixes the layout of the model's parameter tree
    once: leaves in sorted-key order at every level (the order
    ``jax.tree_util`` gives nested dicts), each leaf flattened in its
    own (row-major) layout, so a flat row is element for element the
    reference's.  On the q8 wire it also
    emits an upload as int8 blocks: pad to ``dq``, add the client's
    error-feedback residual, quantize each ``qblock`` block
    (:func:`repro_torch.kernels.ref.quantize_ref`), and keep what the
    quantization dropped as the new residual.  On the q4 wire it rounds
    stochastically onto the int4 grid instead
    (:func:`repro_torch.kernels.ref.quantize_q4_ref`), with draws keyed
    by (seed, client, upload counter) and made on the row's device
    (:func:`repro_torch.prng.uniform_torch`), and packs two lanes per
    byte.  On the top-k wire it keeps the ``nk`` largest-|x| coordinates
    of input + residual as (int32 index, int8 value) pairs with one scale
    per ``qblock`` of the compacted values, and carries everything the
    wire dropped in the residual.  The batched engine's row forms
    (``quantize_rows*``) serialize a wave's (K, D) rows, each row bitwise
    the per-upload codec's.
  * :func:`alloc_buffer` / :func:`write_slot` are the buffered f32
    channel's resident (K, D) rows and their in-place row write
    (:func:`write_rows` a wave's rows at once, a slot past K dropped),
    held by :class:`RowBuffer`;
    :class:`QuantBuffer` is its quantized counterpart (int8 (K, Dq) rows,
    or (K, Dq/2) packed bytes on q4, plus (K, Dq/qblock) scales), and
    :class:`TopkBuffer` the sparse one ((K, nk) indices, values and
    (K, nk/qblock) scales); :class:`MeshRows` lays any of the three over
    a mesh's shards, K/N rows each on the shard's device.
  * :class:`AccumBuffer` is the streaming channel: two O(D) sum banks
    a shard and the host-side weights of the horizon in flight.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng, tree
from repro_torch.kernels import ref
from repro_torch.kernels.quantize import BLOCK as QBLOCK


class PytreeCodec:
    """Nested dict of tensors (a model's parameters or its BatchNorm
    state) <-> flat (D,) f32 vector, leaves in sorted-key order at every
    level (:func:`repro_torch.tree.tree_leaves`, ``jax.tree_util``'s
    order), each leaf flattened row-major.  ``keys`` are the leaves'
    ``/``-joined key paths (a flat dict's keys).

    ``qblock`` is the quantization granule (one f32 absmax scale per
    ``qblock`` lanes); ``dq`` is D rounded up to a qblock multiple, the
    padded length of a quantized row, and ``n_qblocks = dq / qblock``.
    ``topk_frac`` sizes the top-k wire: ``nk = ceil(topk_frac * d)``
    rounded up to a qblock multiple (at most ``dq``) kept coordinates per
    upload, ``nk_qblocks = nk / qblock`` value scales."""

    def __init__(self, template, qblock: int = QBLOCK,
                 topk_frac: float = 0.1):
        leaves, self.treedef = tree.tree_flatten(template)
        self.keys = tree.tree_paths(template)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.d = int(self.offsets[-1])
        if qblock < 1:
            raise ValueError(f"qblock={qblock} must be >= 1")
        self.qblock = int(qblock)
        self.n_qblocks = -(-self.d // self.qblock)
        self.dq = self.n_qblocks * self.qblock
        if not 0.0 < topk_frac <= 1.0:
            raise ValueError(f"topk_frac={topk_frac} must be in (0, 1]")
        self.topk_frac = float(topk_frac)
        nk_raw = max(1, math.ceil(self.topk_frac * self.d))
        self.nk = min(-(-nk_raw // self.qblock) * self.qblock, self.dq)
        self.nk_qblocks = self.nk // self.qblock

    def ravel(self, tree_) -> torch.Tensor:
        return torch.cat([leaf.reshape(-1).to(torch.float32)
                          for leaf in tree.tree_leaves(tree_)])

    def ravel_delta(self, start, end, scale: float) -> torch.Tensor:
        """ravel((start - end) / scale): FedSGD's cumulative gradient
        (Eq. 3) fused with the flatten.  ``scale`` divides as an f32
        tensor on the rows' device: a true division, as the reference's
        (PyTorch turns a division by a Python number on CUDA into a
        multiply by its reciprocal, which rounds differently)."""
        diff = torch.cat([a.reshape(-1).to(torch.float32)
                          - b.reshape(-1).to(torch.float32)
                          for a, b in zip(tree.tree_leaves(start),
                                          tree.tree_leaves(end))])
        return diff / torch.tensor(scale, dtype=torch.float32,
                                   device=diff.device)

    def unravel(self, flat: torch.Tensor):
        """(D,) -> tree of VIEWS into ``flat`` (no copies).  The engine
        never writes a flat params row in place, so the views stay valid
        for as long as anyone holds them."""
        o = self.offsets
        return tree.tree_unflatten(self.treedef, [
            flat[int(o[i]):int(o[i + 1])].view(shape)
            for i, shape in enumerate(self.shapes)])

    def roundtrip_q8(self, tree_):
        """quantize -> dequantize -> unravel of the tree on the q8 wire
        (no residual): the server's view of a model-target upload's
        BatchNorm state, which rides the int8 channel beside the weights
        and is consumed as a tree by the state aggregation (the
        reference codec's ``roundtrip_q8``)."""
        rows = self.roundtrip_q8_rows(tree.tree_map(lambda v: v[None],
                                                    tree_))
        return tree.tree_map(lambda v: v[0], rows)

    def roundtrip_q8_rows(self, stacked):
        """K-stacked tree -> K-stacked :meth:`roundtrip_q8`: each row's
        blocks quantized alone (an absmax and elementwise steps), so a
        row is bitwise its tree's roundtrip."""
        rows = self.ravel_rows(stacked)
        x = F.pad(rows, (0, self.dq - self.d))
        q, s = ref.quantize_ref(x.reshape(-1, self.qblock))
        deq = (q.to(torch.float32) * s[:, None]).view(rows.shape[0],
                                                      self.dq)
        return self.unravel_rows(deq[:, :self.d])

    # ---- q8 wire ----

    def _quantize_nores(self, flat: torch.Tensor,
                        quantize=ref.quantize_ref):
        """(D,) f32 -> int8 (dq,), scales (n_qblocks,); ``quantize`` maps
        the (n_qblocks, qblock) blocks to (q, scales)."""
        x = F.pad(flat, (0, self.dq - self.d))
        q, s = quantize(x.view(self.n_qblocks, self.qblock))
        return q.view(self.dq), s

    def _quantize(self, flat: torch.Tensor, residual: torch.Tensor,
                  quantize=ref.quantize_ref):
        """Error-feedback variant: quantizes input + carried residual and
        also returns the new residual, the quantization error
        x - q*scale rounded once to f32 (the product and the difference
        are exact in f64), which is what the reference's program computes
        once XLA contracts the multiply-subtract into an FMA."""
        x = F.pad(flat, (0, self.dq - self.d)) + residual
        blocks = x.view(self.n_qblocks, self.qblock)
        q, s = quantize(blocks)
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

    # ---- q4 wire: stochastic rounding onto [-7, 7], two lanes per byte

    def _q4(self, seed: int, cid: int, counter: int):
        """The (n_qblocks, qblock) blocks -> (q, scales) quantizer of one
        upload, its draws keyed by (seed, client, upload counter) and
        made on the blocks' device."""
        key = prng.fold_in(prng.fold_in(prng.prng_key(seed), cid), counter)

        def quantize(blocks):
            u = prng.uniform_torch(key, blocks.shape, blocks.device)
            return ref.quantize_q4_ref(blocks, u)
        return quantize

    def _quantize_q4(self, flat, residual, seed, cid, counter):
        q, s, new_res = self._quantize(flat, residual,
                                       self._q4(seed, cid, counter))
        return ref.pack_q4_ref(q), s, new_res

    def _quantize_q4_nores(self, flat, seed, cid, counter):
        q, s = self._quantize_nores(flat, self._q4(seed, cid, counter))
        return ref.pack_q4_ref(q), s

    def ravel_delta_q4(self, start, end, scale: float,
                       residual: torch.Tensor, seed: int, cid: int,
                       counter: int):
        """Gradient upload on the q4 wire with error feedback -> (packed
        int8 (dq/2,), scales (n_qblocks,), new residual (dq,))."""
        return self._quantize_q4(self.ravel_delta(start, end, scale),
                                 residual, seed, cid, counter)

    def ravel_delta_q4_nores(self, start, end, scale: float, seed: int,
                             cid: int, counter: int):
        """Gradient upload on the q4 wire, error feedback off."""
        return self._quantize_q4_nores(self.ravel_delta(start, end, scale),
                                       seed, cid, counter)

    def ravel_q4(self, tree, residual: torch.Tensor, seed: int, cid: int,
                 counter: int):
        """Model weights with a carried residual on the q4 wire (the
        reference codec's ``ravel_q4``; the engine does not call it)."""
        return self._quantize_q4(self.ravel(tree), residual, seed, cid,
                                 counter)

    def ravel_q4_nores(self, tree, seed: int, cid: int, counter: int):
        """Model-weights upload on the q4 wire."""
        return self._quantize_q4_nores(self.ravel(tree), seed, cid, counter)

    # ---- top-k wire: compacted (index, int8 value) pairs ----

    def _rank(self, x: torch.Tensor) -> torch.Tensor:
        """The ``nk`` lanes of largest |x|, largest first, ties in index
        order: the indices ``jax.lax.top_k`` gives, in its order (which
        decides the compacted block, and so the scale, of each value).
        ``torch.topk`` breaks ties otherwise."""
        return torch.sort(x.abs(), descending=True,
                          stable=True).indices[:self.nk]

    def _topk_nores(self, flat: torch.Tensor):
        """(D,) f32 -> (idx int32 (nk,), qv int8 (nk,), scales
        (nk_qblocks,)), ranked over the padded (dq,) row."""
        x = F.pad(flat, (0, self.dq - self.d))
        idx = self._rank(x)
        q, s = ref.quantize_ref(x[idx].view(self.nk_qblocks, self.qblock))
        return idx.to(torch.int32), q.view(self.nk), s

    def _topk(self, flat: torch.Tensor, residual: torch.Tensor):
        """Error-feedback variant -> (idx, qv, scales, new residual (dq,)):
        the residual carries the coordinates the wire dropped in full and,
        at the kept ones, x - q*scale with the product rounded to f32
        first, as the reference computes it (two roundings, unlike the q8
        codec's single one)."""
        x = F.pad(flat, (0, self.dq - self.d)) + residual
        idx = self._rank(x)
        vals = x[idx]
        q, s = ref.quantize_ref(vals.view(self.nk_qblocks, self.qblock))
        deq = (q.to(torch.float32) * s[:, None]).view(self.nk)
        new_res = x.index_put((idx,), vals - deq)
        return idx.to(torch.int32), q.view(self.nk), s, new_res

    def ravel_delta_topk(self, start, end, scale: float,
                         residual: torch.Tensor):
        """Gradient upload on the top-k wire with error feedback -> (idx
        int32 (nk,), qv int8 (nk,), scales (nk_qblocks,), new residual
        (dq,))."""
        return self._topk(self.ravel_delta(start, end, scale), residual)

    def ravel_delta_topk_nores(self, start, end, scale: float):
        """Gradient upload on the top-k wire, error feedback off."""
        return self._topk_nores(self.ravel_delta(start, end, scale))

    def ravel_topk(self, tree, residual: torch.Tensor):
        """A tree with a carried residual on the top-k wire (the
        reference codec's ``ravel_topk``; the engine does not call it)."""
        return self._topk(self.ravel(tree), residual)

    def ravel_rows(self, trees) -> torch.Tensor:
        """K-stacked tree (each leaf (K, *shape)) -> (K, D) rows."""
        return torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                          for leaf in tree.tree_leaves(trees)], dim=1)

    def unravel_rows(self, rows: torch.Tensor):
        """(K, D) rows -> tree of (K, *shape) leaves (copies where a leaf's
        columns are not contiguous)."""
        o, k = self.offsets, rows.shape[0]
        return tree.tree_unflatten(self.treedef, [
            rows[:, int(o[i]):int(o[i + 1])].reshape((k,) + shape)
            for i, shape in enumerate(self.shapes)])

    # ---- the row forms of the batched engine: each row is bitwise the
    # per-upload codec's output for that row ----

    @staticmethod
    def _stack_rows(outs) -> tuple:
        """Per-row output tuples -> one stacked tensor per output."""
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def quantize_rows(self, vecs: torch.Tensor, residuals: torch.Tensor):
        """(K, D) rows and (K, dq) residuals on the q8 wire -> (q (K, dq),
        scales (K, n_qblocks), new residuals (K, dq))."""
        return self._stack_rows(self._quantize(v, r)
                                for v, r in zip(vecs, residuals))

    def quantize_rows_nores(self, vecs: torch.Tensor):
        """(K, D) rows on the q8 wire, error feedback off."""
        return self._stack_rows(self._quantize_nores(v) for v in vecs)

    def quantize_rows_q4(self, vecs: torch.Tensor, residuals: torch.Tensor,
                         seed: int, cids: Sequence[int],
                         counters: Sequence[int]):
        """(K, D) rows on the q4 wire with per-lane residuals, client ids
        and upload counters and one seed: row i draws with the key of
        (seed, cids[i], counters[i]), as that upload on the sequential
        path -> (packed (K, dq/2), scales, new residuals)."""
        return self._stack_rows(
            self._quantize_q4(v, r, seed, int(c), int(n))
            for v, r, c, n in zip(vecs, residuals, cids, counters))

    def quantize_rows_q4_nores(self, vecs: torch.Tensor, seed: int,
                               cids: Sequence[int],
                               counters: Sequence[int]):
        """(K, D) rows on the q4 wire, error feedback off."""
        return self._stack_rows(
            self._quantize_q4_nores(v, seed, int(c), int(n))
            for v, c, n in zip(vecs, cids, counters))

    def quantize_rows_topk(self, vecs: torch.Tensor,
                           residuals: torch.Tensor):
        """(K, D) rows on the top-k wire -> (idx (K, nk), qv (K, nk),
        scales (K, nk_qblocks), new residuals (K, dq))."""
        return self._stack_rows(self._topk(v, r)
                                for v, r in zip(vecs, residuals))

    def quantize_rows_topk_nores(self, vecs: torch.Tensor):
        """(K, D) rows on the top-k wire, error feedback off."""
        return self._stack_rows(self._topk_nores(v) for v in vecs)

    def zero_residual(self, device) -> torch.Tensor:
        """Initial (dq,) error-feedback residual of a client."""
        return torch.zeros(self.dq, dtype=torch.float32, device=device)


def alloc_buffer(k: int, d: int, device) -> torch.Tensor:
    """Preallocate the (K, D) f32 update buffer."""
    return torch.zeros((k, d), dtype=torch.float32, device=device)


def write_slot(buf: torch.Tensor, vec: torch.Tensor, slot: int) -> None:
    """buf[slot] <- vec, in place."""
    buf[slot].copy_(vec)


def _scatter_rows(bufs: Sequence[torch.Tensor],
                  rows: Sequence[torch.Tensor], slots) -> None:
    """bufs[j][slots] <- rows[j] for each j, in place; a slot outside the
    buffers' K rows drops its row (the reference's ``mode="drop"``)."""
    slots = np.asarray(slots, np.int64)
    keep = np.flatnonzero((slots >= 0) & (slots < bufs[0].shape[0]))
    if keep.size == 0:
        return
    dev = bufs[0].device
    dst = torch.as_tensor(slots[keep], device=dev)
    src = None if keep.size == slots.size else torch.as_tensor(keep,
                                                               device=dev)
    for buf, r in zip(bufs, rows):
        buf.index_copy_(0, dst, (r if src is None else r.index_select(
            0, src)).to(buf.dtype))


def write_rows(buf: torch.Tensor, rows: torch.Tensor, slots) -> None:
    """buf[slots] <- rows, in place, one wave's (Kw, D) rows at once;
    slots outside the buffer's rows are dropped (:func:`_scatter_rows`)."""
    _scatter_rows((buf,), (rows,), slots)


class RowBuffer:
    """The buffered f32 channel's resident (K, D) rows, with the
    interface of :class:`QuantBuffer`: ``write`` a slot, ``write_rows`` a
    wave, ``set_rows`` a whole round, ``views`` the rows as the server
    step takes them."""

    def __init__(self, k: int, d: int, *, device):
        self.rows = alloc_buffer(k, d, device)

    def write(self, vec: torch.Tensor, slot: int) -> None:
        write_slot(self.rows, vec, slot)

    def write_rows(self, rows: torch.Tensor, slots) -> None:
        write_rows(self.rows, rows, slots)

    def set_rows(self, rows: torch.Tensor) -> None:
        """Adopt a whole round's rows at once (the batched sync round)."""
        if rows.shape != self.rows.shape or rows.dtype != torch.float32:
            raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype} do not "
                             f"fit the buffer's {tuple(self.rows.shape)}")
        self.rows = rows

    @property
    def views(self) -> torch.Tensor:
        return self.rows


class MeshRows:
    """The buffered channel's K rows over a mesh: shard s holds slots
    [s*K/N, (s+1)*K/N) in a buffer of its own on its device (``make(rows,
    device)``: a :class:`RowBuffer`, :class:`QuantBuffer` or
    :class:`TopkBuffer`), with their interface; ``views`` is the list of
    the shards' views, as the mesh's server step takes them."""

    def __init__(self, make, k: int, mesh):
        if k % mesh.size:
            raise ValueError(f"{k} rows do not split over {mesh.size} "
                             "shards")
        self.per = k // mesh.size
        self.devices = list(mesh.devices)
        self.parts = [make(self.per, dev) for dev in self.devices]

    def write(self, *args) -> None:
        """``write(*payload, slot)``: the upload into its slot's shard."""
        *payload, slot = args
        s, i = divmod(int(slot), self.per)
        # the row leaves the controller's device for its shard's
        self.parts[s].write(*(a.to(self.devices[s]) for a in payload), i)

    def write_rows(self, *args) -> None:
        """``write_rows(*rows, slots)``: each shard's rows of one wave into
        its buffer; slots past K are dropped."""
        *rows, slots = args
        slots = np.asarray(slots, np.int64)
        for s, part in enumerate(self.parts):
            lo = s * self.per
            sel = np.flatnonzero((slots >= lo) & (slots < lo + self.per))
            if sel.size == 0:
                continue
            idx = torch.as_tensor(sel, device=rows[0].device)
            part.write_rows(*(r.index_select(0, idx).to(self.devices[s])
                              for r in rows), slots[sel] - lo)

    def set_rows(self, *rows) -> None:
        """Each shard adopts its block of a whole round's rows."""
        for s, part in enumerate(self.parts):
            lo = s * self.per
            part.set_rows(*(r[lo:lo + self.per].to(self.devices[s])
                            for r in rows))

    @property
    def views(self) -> list:
        return [part.views for part in self.parts]


class AccumBuffer:
    """Double-buffered streaming accumulator: the O(D) replacement for the
    buffered (K, D) channel.

    Holds TWO sets of (1, D) f32 sum banks, one bank a shard (``mesh``'s
    shards, each on its device; one bank on ``device`` without a mesh),
    plus each shard's ingest weights of the horizon in flight, in arrival
    order (the finalize sums a shard's weights in that order, which is the
    order the buffered kernel sums its (K,) weights in).  ``fold`` folds
    one upload into its shard's bank through the server's fold program,
    which writes the bank row IN PLACE (on CUDA, the ``safl_fold`` /
    ``safl_fold_q8`` kernel with ``out`` = the row), and tracks fedasync's
    survival product P = prod(beta) on the host; ``seal`` hands the filled
    banks to the server round and swaps in the spares; ``release`` returns
    the finalize's zeroed banks as the new spares.  Channel memory is 2 *
    D * 4 bytes a shard (D = dq on the q8 wire), flat in the uploads a
    horizon admits.  Banks travel as one (1, D) tensor without a mesh and
    as the list of the shards' with one.
    """

    def __init__(self, d: int, fold_fn, device, mesh=None):
        self.d = int(d)
        self.mesh = mesh
        self.devices = (list(mesh.devices) if mesh is not None
                        else [torch.device(device)])
        self.n_rows = len(self.devices)
        self._fold_fn = fold_fn
        self._bank = self._alloc()
        self._spare = self._alloc()
        self._reset_host()

    def _alloc(self) -> List[torch.Tensor]:
        return [torch.zeros((1, self.d), dtype=torch.float32, device=dev)
                for dev in self.devices]

    def _reset_host(self) -> None:
        self._w: List[List[np.float32]] = [[] for _ in self.devices]
        self._pprod = np.float32(1.0)
        self.count = 0

    def fold(self, payload: Tuple[torch.Tensor, ...], *, w, beta=1.0,
             shard: int = 0) -> None:
        """Fold one upload into bank ``shard``: its row becomes
        beta*row + w*payload (payload = (vec,) f32 or (q_row, s_row) q8),
        ``w`` the FINAL ingest weight (discount-at-ingest) and ``beta``
        the decay (1.0 except the fedasync mix, where beta = 1 - a_i)."""
        dev = self.devices[shard]
        # the upload moves to its shard's device (a no-op on one device)
        payload = tuple(a.to(dev) for a in payload)
        self._bank[shard] = self._fold_fn(self._bank[shard], *payload, 0,
                                          np.float32(w), np.float32(beta))
        self._w[shard].append(np.float32(w))
        self._pprod = np.float32(self._pprod * np.float32(beta))
        self.count += 1

    def skip(self, *, shard: int = 0) -> None:
        """Count a screened upload without touching the bank: an exact 0.0
        ingest weight keeps ``wvec`` as long as the buffered channel's
        weight vector, so the finalize sums the same weights in the same
        order (adding 0.0 is exact).  Folding with weight 0 instead would
        still poison the bank: 0 x NaN is NaN."""
        self._w[shard].append(np.float32(0.0))
        self.count += 1

    def seal(self):
        """Close the horizon: returns ``(bank, wvec, stats)``, ``wvec`` the
        np.float32 ingest weights in arrival order (on a mesh each shard's
        list, shard-major, zero-padded to equal length: the buffered
        channel's layout of its rows' weights) and ``stats`` the horizon's
        upload count and the survival product ``pprod``, and swaps the
        spare banks in."""
        assert self.count > 0, "seal() on an empty horizon"
        assert self._spare is not None, \
            "seal() before release() of the previous horizon's bank"
        if self.mesh is None:
            wvec = np.asarray(self._w[0], np.float32)
        else:
            per = max(len(ws) for ws in self._w)
            wvec = np.zeros((self.n_rows * per,), np.float32)
            for s, ws in enumerate(self._w):
                wvec[s * per:s * per + len(ws)] = ws
        stats = {"count": self.count, "pprod": self._pprod}
        bank = self._bank if self.mesh is not None else self._bank[0]
        self._bank, self._spare = self._spare, None
        self._reset_host()
        return bank, wvec, stats

    def release(self, zeroed_bank) -> None:
        """Return the finalize's zeroed bank(s) as the new spare."""
        self._spare = (list(zeroed_bank) if self.mesh is not None
                       else [zeroed_bank])


class QuantBuffer:
    """Preallocated quantized update buffer: (K, Dq) int8 rows, or with
    ``packed=True`` (the q4 wire) (K, Dq/2) bytes of two int4 lanes each,
    plus (K, n_qblocks) f32 scales, written in place one slot at a time."""

    def __init__(self, k: int, d: int, qblock: int = QBLOCK, *, device,
                 packed: bool = False):
        self.qblock = int(qblock)
        self.n_qblocks = -(-int(d) // self.qblock)
        self.dq = self.n_qblocks * self.qblock
        self.packed = bool(packed)
        row_bytes = self.dq // 2 if self.packed else self.dq
        self.q = torch.zeros((k, row_bytes), dtype=torch.int8, device=device)
        self.scales = torch.zeros((k, self.n_qblocks), dtype=torch.float32,
                                  device=device)

    def write(self, q_vec: torch.Tensor, s_vec: torch.Tensor,
              slot: int) -> None:
        self.q[slot].copy_(q_vec)
        self.scales[slot].copy_(s_vec)

    def write_rows(self, q_rows: torch.Tensor, s_rows: torch.Tensor,
                   slots) -> None:
        """Scatter one wave's quantized rows into their slots, in place;
        out-of-range slots dropped."""
        _scatter_rows((self.q, self.scales), (q_rows, s_rows), slots)

    def set_rows(self, q: torch.Tensor, scales: torch.Tensor) -> None:
        """Adopt a whole round's rows at once (the batched sync round)."""
        if q.shape != self.q.shape or q.dtype != torch.int8 or \
                scales.shape != self.scales.shape:
            raise ValueError(f"rows {tuple(q.shape)} {q.dtype} / scales "
                             f"{tuple(scales.shape)} do not fit the buffer's "
                             f"{tuple(self.q.shape)} / "
                             f"{tuple(self.scales.shape)}")
        self.q, self.scales = q, scales

    @property
    def views(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q, scales) as the quantized server step takes them."""
        return self.q, self.scales


class TopkBuffer:
    """Preallocated sparse buffer of the top-k wire: per row ``nk`` int32
    coordinates, their int8 values and one f32 scale per ``qblock`` of
    the compacted values, written in place one slot at a time.  An empty
    row holds index ``d`` everywhere, past the live range, so the scatter
    drops it without a validity mask."""

    def __init__(self, k: int, d: int, nk: int, qblock: int = QBLOCK, *,
                 device):
        if nk % qblock:
            raise ValueError(f"nk={nk} is not a multiple of qblock={qblock}")
        self.d = int(d)
        self.nk = int(nk)
        self.qblock = int(qblock)
        self.nk_qblocks = self.nk // self.qblock
        self.idx = torch.full((k, self.nk), self.d, dtype=torch.int32,
                              device=device)
        self.qv = torch.zeros((k, self.nk), dtype=torch.int8, device=device)
        self.scales = torch.zeros((k, self.nk_qblocks), dtype=torch.float32,
                                  device=device)

    def write(self, idx_vec: torch.Tensor, qv_vec: torch.Tensor,
              s_vec: torch.Tensor, slot: int) -> None:
        self.idx[slot].copy_(idx_vec)
        self.qv[slot].copy_(qv_vec)
        self.scales[slot].copy_(s_vec)

    def write_rows(self, idx_rows: torch.Tensor, qv_rows: torch.Tensor,
                   s_rows: torch.Tensor, slots) -> None:
        """Scatter one wave's sparse rows into their slots, in place;
        out-of-range slots dropped."""
        _scatter_rows((self.idx, self.qv, self.scales),
                      (idx_rows, qv_rows, s_rows), slots)

    def set_rows(self, idx: torch.Tensor, qv: torch.Tensor,
                 scales: torch.Tensor) -> None:
        """Adopt a whole round's rows at once (the batched sync round)."""
        if idx.shape != self.idx.shape or idx.dtype != torch.int32 or \
                qv.shape != self.qv.shape or qv.dtype != torch.int8 or \
                scales.shape != self.scales.shape:
            raise ValueError("top-k rows do not fit the buffer's "
                             f"{tuple(self.idx.shape)} rows")
        self.idx, self.qv, self.scales = idx, qv, scales

    @property
    def views(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(idx, qv, scales) as the top-k server step takes them."""
        return self.idx, self.qv, self.scales
