"""Flat-buffer server round (paper §3, Eq. 4-6, and the study's variants).

:class:`FlatServer` runs the server side of both channels over flat rows
in the :class:`repro_torch.core.flatbuf.PytreeCodec` layout, for every
aggregation scheme of the study on the f32, q8 and q4 wires, and for the
gradient schemes (fedsgd, fedbuff, fedopt, sdga) on the sparse top-k
wire:

  * ``fedsgd`` (Eq. 4-5): p - lr * (weighted gradient mean)
  * ``fedavg`` (Eq. 6): the data-size-weighted model mean
  * ``fedbuff``: fedsgd over staleness-discounted weights
  * ``fedopt``: server Adam over the weighted gradient mean
  * ``sdga``: discounted mean + server momentum + EMA anchor
  * ``fedasync``: K sequential mixes p <- (1 - a_i) p + a_i w_i

:func:`weighted_mean` is fedavg's mean of the uploads' non-trainable
state (BatchNorm statistics), taken over trees of tensors.  The
reference's pytree-level server functions (:func:`fedsgd`,
:func:`fedavg`, :func:`fedasync_mix`, :func:`fedbuff`,
:func:`fedopt_adam`, :func:`sdga` and their :class:`ServerOptState`) run
over the same nested trees, in its f32 arithmetic; they are the
per-leaf oracle of :class:`FlatServer` and are not on the engine's
path.

Two channels:

  * buffered (``step``): the resident (K, D) rows (f32), (K, Dq) int8
    rows + scales (q8) or (K, Dq/2) packed int4 bytes + scales (q4)
    reduced by one kernel with the server step fused
    (:func:`~repro_torch.kernels.safl_agg.safl_aggregate` for fedsgd /
    fedbuff / fedavg and the mean of fedopt, :func:`sdga_aggregate` for
    sdga, their ``_q8`` / ``_q4`` siblings on the quantized wires);
    fedasync runs its K mixes as K folds with beta = 1 - a_i into a
    zeroed row; on top-k the (K, nk) sparse rows are summed by
    :func:`~repro_torch.kernels.safl_agg.safl_aggregate_topk` and every
    mode steps from the sum as the streaming finalize does (sdga too:
    ``sdga_aggregate`` is not on this wire);
  * streaming (``fold_program`` + ``finalize``): each upload folded into
    a running sum bank the moment it lands (``safl_fold``,
    ``safl_fold_q8``, ``safl_fold_q4``, ``safl_fold_topk``), then one
    finalize from the bank's sum and the host's ingest weights (the
    reference's ``_from_sums``).

``screen`` is the defense's per-row sum of squares of the wire payload
(:func:`~repro_torch.kernels.safl_agg.screen_rows`, ``screen_rows_q8`` /
``screen_rows_q4`` on the quantized wires, ``screen_rows_q8`` over the
values and scales on top-k), whose ``isfinite`` is the integrity verdict
and ``sqrt`` the norm.

The engine always hands over the FINAL per-upload weights
(discount-at-ingest, ``external_discount=True, fedasync_rates=True`` in
the reference), so the kernels run with ``discount="none"``.  The two
channels agree bitwise in every mode and on every wire.

On the q8 wire, a buffered round of K >= 32 rows takes the reference's
large-K int8-dot regime when ``REPRO_INT8_DOT=1`` opens its gate
(:func:`repro_torch.kernels.ref.int8dot_auto`; closed by default on both
devices): the weighted mean is one
:func:`~repro_torch.kernels.int8dot.weighted_sum_q8_int8dot` launch over
the normalized weights (the reference's ``q8_mean``), and each mode steps
from it in PyTorch ops; on a mesh each shard's partial is that kernel over
its unnormalized weights, on coefficient scales maxed over every shard.
fedasync keeps its fold program.  The streaming channel never takes the
regime, so there the two channels differ, as the reference's do.

On a mesh (``mesh``, :mod:`repro_torch.sharding.flat`: the 1-D pod mesh
or the 2-D (edge, pod) one) the channel's rows live on their shards:
each shard's partial is the unnormalized weighted sum of its own rows on
its own device (the aggregate kernels in mode ``sum``, the q8 / q4 rows
dequantized per shard, ``safl_aggregate_topk`` on top-k; the streaming
channel's partial is the shard's bank row), the partials and weight
masses add in the mesh's order (:func:`~repro_torch.sharding.flat.
mesh_reduce`), and the one ``_from_sums`` step body takes the server
step from the sums, in every mode but fedasync, whose mixes stay one
chain of folds.  :func:`podwise_aggregate` is the same round over a
K-stacked pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.int8dot import weighted_sum_q8_int8dot
from repro_torch.kernels.quantize import BLOCK as QBLOCK
from repro_torch.kernels.safl_agg import (
    safl_aggregate, safl_aggregate_q4, safl_aggregate_q8,
    safl_aggregate_topk, safl_fold, safl_fold_q4, safl_fold_q8,
    safl_fold_topk, screen_rows, screen_rows_q4, screen_rows_q8,
    sdga_aggregate, sdga_aggregate_q4, sdga_aggregate_q8)
from repro_torch.sharding.flat import (edge_traffic, mesh_max, mesh_size,
                                       podwise_bank_sums, podwise_sums,
                                       shard_weights, sum_in_order,
                                       xla_sum)

Tree = Any


class _QuantKernels(NamedTuple):
    """The kernels of one quantized wire."""
    aggregate: Callable
    sdga: Callable
    fold: Callable
    screen: Callable


_QUANT_KERNELS = {
    "q8": _QuantKernels(safl_aggregate_q8, sdga_aggregate_q8, safl_fold_q8,
                        screen_rows_q8),
    "q4": _QuantKernels(safl_aggregate_q4, sdga_aggregate_q4, safl_fold_q4,
                        screen_rows_q4),
}

# The reference FlatServer's defaults, which its engine never overrides:
# sdga's EMA decay and fedopt's Adam betas and epsilon.
EMA_DECAY = 0.95
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-8


def staleness_poly(tau: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 + tau)^(-alpha), FedAsync's polynomial discount."""
    return torch.pow(1.0 + tau.to(torch.float32), -alpha)


def staleness_hinge(tau: torch.Tensor, a: float = 4.0,
                    b: float = 1.0) -> torch.Tensor:
    """1 up to staleness a, then 1 / (b*(tau - a) + 1)."""
    tau = tau.to(torch.float32)
    return torch.where(tau <= a, torch.ones_like(tau),
                       1.0 / (b * (tau - a) + 1.0))


def staleness_const(tau: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(tau, dtype=torch.float32)


def fedasync_coefficients(staleness: Sequence[int], fedasync_alpha: float,
                          alpha: float, score=None) -> np.ndarray:
    """K sequential fedasync mixes as one linear combination: with
    a_i = fedasync_alpha * (1 + tau_i)^-alpha (times ``score``, clipped to
    [0, 1]) the coefficients are c_i = a_i * prod_{j>i} (1 - a_j), and
    (1 - sum(c)) p + c @ u is the mixed model (the kernels' ``mix``
    mode).  Host numpy, np.float32 (K,)."""
    a = fedasync_alpha * np.power(
        1.0 + np.asarray(staleness, np.float32), -np.float32(alpha))
    if score is not None:
        a = np.clip(a * np.asarray(score, np.float32), 0.0, 1.0)
    one_minus = (1.0 - a).astype(np.float32)
    tail = np.concatenate(
        [np.cumprod(one_minus[::-1])[::-1][1:], [np.float32(1.0)]])
    return np.asarray(a * tail, np.float32)


def weighted_mean(stacked, weights):
    """``sum_k(w_k * leaf[k]) / max(sum w, 1e-12)`` in f32, per leaf of
    the K-stacked tree ``stacked`` (the reference's
    ``aggregation.weighted_mean``; fedavg's mean of the uploads'
    BatchNorm states).  The K terms and the weights sum in k order, and
    the quotient is a true division by an f32 tensor."""
    w = np.asarray(weights, np.float32)
    denom = max(sum_in_order(w), np.float32(1e-12))

    def red(leaf):
        acc = leaf[0].to(torch.float32) * float(w[0])
        for k in range(1, len(w)):
            acc = acc + leaf[k].to(torch.float32) * float(w[k])
        return (acc / torch.tensor(denom, dtype=torch.float32,
                                   device=acc.device)).to(leaf.dtype)

    return tree.tree_map(red, stacked)


# ---------------------------------------------------------------------------
# pytree-level server functions (the reference's aggregators over nested
# trees of tensors, :mod:`repro_torch.tree`; the engine runs FlatServer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServerOptState:
    """Server-side slow state of :func:`fedopt_adam` and :func:`sdga`:
    trees shaped as the params (None until the first step) and the host
    step count."""
    momentum: Tree = None
    adam_m: Tree = None
    adam_v: Tree = None
    ema: Tree = None
    step: int = 0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-dim tensor on ``like``'s device:
    dividing by it is a true division (on CUDA a division by a Python
    number becomes a multiply by its reciprocal)."""
    return torch.tensor(np.float32(x), dtype=torch.float32,
                        device=like.device)


def _poly_host(staleness, alpha: float) -> np.ndarray:
    """(1 + tau)^-alpha of host staleness ints, np.float32 (the engine's
    discount)."""
    return np.power(np.float32(1.0) + np.asarray(staleness, np.float32),
                    -np.float32(alpha))


def _zeros_f32(params: Tree) -> Tree:
    return tree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)


def fedsgd(global_params: Tree, grads_stacked: Tree, weights,
           server_lr: float) -> Tree:
    """Eq. (4)-(5): p - lr * (the weighted gradient mean), per leaf;
    ``weights`` the (K,) host weights."""
    g = weighted_mean(grads_stacked, weights)
    return tree.tree_map(
        lambda p, gl: (p - server_lr * gl.to(p.dtype)).to(p.dtype),
        global_params, g)


def fedavg(params_stacked: Tree, data_sizes) -> Tree:
    """Eq. (6): the data-size-weighted parameter mean."""
    return weighted_mean(params_stacked, np.asarray(data_sizes, np.float32))


def fedasync_mix(global_params: Tree, client_params: Tree,
                 alpha_tau: float) -> Tree:
    """One fedasync mix, ``(1 - a) * g + a * c`` in f32 per leaf."""
    a = float(np.float32(alpha_tau))
    one_minus = float(np.float32(1.0) - np.float32(alpha_tau))
    return tree.tree_map(
        lambda g, c: (one_minus * g.to(torch.float32)
                      + a * c.to(torch.float32)).to(g.dtype),
        global_params, client_params)


def fedbuff(global_params: Tree, grads_stacked: Tree, staleness,
            server_lr: float, alpha: float = 0.5) -> Tree:
    """fedsgd over the (1 + tau)^-alpha discounted weights."""
    return fedsgd(global_params, grads_stacked,
                  _poly_host(staleness, alpha), server_lr)


def fedopt_adam(global_params: Tree, grads_stacked: Tree, weights,
                opt: ServerOptState, server_lr: float,
                b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = ADAM_EPS) -> tuple:
    """Server Adam over the weighted gradient mean -> (new params, new
    opt)."""
    g = weighted_mean(grads_stacked, weights)
    step = opt.step + 1
    m = opt.adam_m if opt.adam_m is not None else _zeros_f32(global_params)
    v = opt.adam_v if opt.adam_v is not None else _zeros_f32(global_params)
    m = tree.tree_map(
        lambda mm, gg: b1 * mm + (1 - b1) * gg.to(torch.float32), m, g)
    v = tree.tree_map(
        lambda vv, gg: b2 * vv + (1 - b2) * torch.square(
            gg.to(torch.float32)), v, g)
    mh = tree.tree_map(lambda mm: mm / _f32(1 - b1 ** step, mm), m)
    vh = tree.tree_map(lambda vv: vv / _f32(1 - b2 ** step, vv), v)
    new = tree.tree_map(
        lambda p, mm, vv: (p.to(torch.float32) - server_lr * mm
                           / (torch.sqrt(vv) + eps)).to(p.dtype),
        global_params, mh, vh)
    return new, dataclasses.replace(opt, adam_m=m, adam_v=v, step=step)


def sdga(global_params: Tree, grads_stacked: Tree, staleness,
         opt: ServerOptState, *, server_lr: float, alpha: float = 0.5,
         momentum: float = 0.8, ema_anchor: float = 0.05,
         ema_decay: float = EMA_DECAY) -> tuple:
    """Staleness-damped gradient aggregation: the discounted gradient
    mean into server momentum, plus a pull of ``ema_anchor`` toward the
    EMA of past global models -> (new params, new opt)."""
    g = weighted_mean(grads_stacked, _poly_host(staleness, alpha))
    mom = (opt.momentum if opt.momentum is not None
           else _zeros_f32(global_params))
    mom = tree.tree_map(
        lambda mm, gg: momentum * mm + gg.to(torch.float32), mom, g)
    ema = opt.ema if opt.ema is not None else tree.tree_map(
        lambda p: p.to(torch.float32), global_params)
    new = tree.tree_map(
        lambda p, mm, e: (p.to(torch.float32) - server_lr * mm
                          + ema_anchor * (e - p.to(torch.float32)))
        .to(p.dtype), global_params, mom, ema)
    ema = tree.tree_map(
        lambda e, p: ema_decay * e + (1 - ema_decay) * p.to(torch.float32),
        ema, new)
    return new, dataclasses.replace(opt, momentum=mom, ema=ema,
                                    step=opt.step + 1)


def podwise_aggregate(stacked: Tree, weights, target: str,
                      global_params: Tree = None,
                      server_lr: float = 1.0) -> Tree:
    """The server round over a K-stacked pytree (the reference's
    ``podwise_aggregate``): ``target="grads"`` is :func:`fedsgd` (needs
    ``global_params``), ``"params"`` the :func:`weighted_mean`.  The
    engine runs the same round over the flat rows, on a mesh through
    ``FlatServer(mesh=...)``."""
    if target == "grads":
        if global_params is None:
            raise ValueError("target='grads' needs global_params")
        return fedsgd(global_params, stacked, weights, server_lr)
    return weighted_mean(stacked, weights)


class FlatServer:
    """Server round over flat rows on one device (the GPU unless the
    caller asks for the CPU), or over a mesh's shards (``mesh``; its
    shard 0's device holds the params and the slow state).

    ``step`` takes the buffered channel's rows: the f32 (K, D) tensor, or
    on the quantized wires the ``(q, scales (K, Dq/qblock))`` pair
    (:class:`repro_torch.core.flatbuf.QuantBuffer` views; q int8 (K, Dq)
    on q8, packed (K, Dq/2) bytes on q4), or on top-k the ``(idx, qv,
    scales)`` triple (:class:`repro_torch.core.flatbuf.TopkBuffer`
    views); on a mesh the list of the shards' row blocks in that form
    (:class:`repro_torch.core.flatbuf.MeshRows` views,
    :func:`repro_torch.sharding.flat.shard_rows`).  The streaming bank is
    (1, D) f32, (1, Dq) on q8 and q4; on a mesh the list of the shards'.
    Slow state (:meth:`init_opt`): sdga's momentum and EMA, fedopt's Adam
    moments, each a (D,) f32 tensor, and a host step count."""

    MODES = ("fedsgd", "fedavg", "fedbuff", "fedopt", "sdga", "fedasync")
    WIRES = ("f32", "q8", "q4", "topk")

    def __init__(self, mode: str, d: int, *, server_lr: float,
                 momentum: float = 0.8, ema_anchor: float = 0.05,
                 wire: str = "f32", qblock: int = QBLOCK,
                 device="cuda", mesh=None):
        if mode not in self.MODES:
            raise ValueError(f"aggregation {mode!r} not in {self.MODES}")
        if wire not in self.WIRES:
            raise ValueError(f"wire {wire!r} not in {self.WIRES}")
        if wire == "topk" and mode in ("fedavg", "fedasync"):
            # a sparse average of weights would zero every coordinate it
            # did not send
            raise ValueError(f"wire='topk' is gradient-only; mode={mode!r} "
                             "uploads weights")
        self.mode = mode
        self.wire = wire
        self.d = int(d)
        self.qblock = int(qblock)
        self.dq = -(-self.d // self.qblock) * self.qblock
        self.server_lr = float(server_lr)
        self.momentum = float(momentum)
        self.ema_anchor = float(ema_anchor)
        self.device = resolve_device(mesh.home if mesh is not None
                                     else device)
        self.mesh = mesh if mesh_size(mesh) > 1 else None
        # the kernels of a quantized wire (None on f32)
        self._qk = _QUANT_KERNELS.get(wire)
        # the unit of exchange: the padded (Dq,) partial on q8 / q4
        self.traffic = edge_traffic(self.mesh, 4 * self.bank_width)
        if self.mesh is not None:
            self._pod_reduce = podwise_sums(self.mesh, self._partial_sums)
            self._bank_reduce = podwise_bank_sums(self.mesh)

    @property
    def bank_width(self) -> int:
        """Lanes of the streaming bank: Dq on q8 / q4 (folds dequantize
        onto the padded grid), D on f32 and top-k (the scatter drops pad
        coordinates)."""
        return self.dq if self._qk is not None else self.d

    def screen(self, payload) -> torch.Tensor:
        """(K,) f32 sums of squares of the K payload rows, on the wire's
        own format (``payload`` = ``(rows,)`` f32 (K, D), ``(q, scales)``
        on q8 / q4, ``(idx, qv, scales)`` on top-k, whose integrity lives
        in the values and scales).  The sums are row-independent, so a row
        screened alone (K = 1, every upload of the sequential engine) and
        inside a stack get the same value bitwise."""
        if self.wire == "topk":
            return screen_rows_q8(*payload[1:], qblock=self.qblock)
        if self._qk is not None:
            return self._qk.screen(*payload, qblock=self.qblock)
        return screen_rows(*payload)

    def init_opt(self, params_flat: torch.Tensor) -> Dict:
        """Mode-matched slow state: sdga's zero momentum and an EMA that
        starts as a copy of the params, fedopt's zero Adam moments."""
        def z():
            return torch.zeros(self.d, dtype=torch.float32,
                               device=self.device)
        if self.mode == "sdga":
            return {"momentum": z(),
                    "ema": params_flat.to(torch.float32).clone(), "step": 0}
        if self.mode == "fedopt":
            return {"m": z(), "v": z(), "step": 0}
        return {}

    def _scalar(self, x) -> torch.Tensor:
        """A 0-dim f32 device tensor: dividing by it is a true division
        (PyTorch turns a division by a Python number on CUDA into a
        multiply by its reciprocal, which rounds differently)."""
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=self.device)

    def _metrics(self, new, p0, wsum) -> Dict:
        upd = new - p0
        return {"update_norm": torch.sqrt(torch.sum(upd * upd)),
                "weight_sum": wsum}

    def _adam(self, p0, g, opt):
        """The reference's ``_adam_step``: bias-corrected Adam, the
        corrections 1 - b^step computed in f32 on the host.  The square
        root is the correctly rounded f32 one on either device: the f64
        root rounded once (exact for an f32 input).  PyTorch's f32
        ``sqrt`` on the CPU left 13,889 of 2,154,730 lanes an ulp off it
        (numpy's), so the CPU's step would not equal the card's."""
        step = opt["step"] + 1
        m = ADAM_B1 * opt["m"] + (1 - ADAM_B1) * g
        v = ADAM_B2 * opt["v"] + (1 - ADAM_B2) * torch.square(g)
        sf = np.float32(step)
        mh = m / self._scalar(1 - np.power(np.float32(ADAM_B1), sf))
        vh = v / self._scalar(1 - np.power(np.float32(ADAM_B2), sf))
        root = torch.sqrt(vh.double()).to(torch.float32)
        new = p0 - self.server_lr * mh / (root + ADAM_EPS)
        return new, {"m": m, "v": v, "step": step}

    def _sdga_opt(self, opt, m, e) -> Dict:
        return {"momentum": m, "ema": e, "step": opt["step"] + 1}

    def _mix(self, p0, s, pprod):
        """fedasync's P*p + S; weight mass 1 - P."""
        return (float(pprod) * p0 + s,
                np.float32(np.float32(1.0) - np.float32(pprod)))

    def _int8dot(self, k: int) -> bool:
        """Whether a buffered round of ``k`` rows (the global K on a mesh)
        takes the q8 wire's int8-dot regime (:func:`ref.int8dot_auto`);
        fedasync keeps its fold program, as in the reference's engine
        form."""
        return (self.wire == "q8" and self.mode != "fedasync"
                and ref.int8dot_auto(k))

    def _mesh_coeff_scale(self, buf, wvec) -> torch.Tensor:
        """The int8-dot regime's coefficient scales on a mesh: each
        shard's :func:`ref.int8dot_coeff_scale` of its unnormalized
        weights, then their elementwise max on the home device (the
        reference's ``pmax`` over both axes), so every shard quantizes its
        coefficients on one grid."""
        return mesh_max([
            ref.int8dot_coeff_scale(
                s, torch.from_numpy(np.ascontiguousarray(w)).to(s.device))
            for (_, s), w in zip(buf, shard_weights(self.mesh, buf, wvec))])

    def _partial_sums(self, rows, w: np.ndarray, coeff_scale=None):
        """One shard's partial on its device: the unnormalized weighted
        sum of its rows (the aggregate kernel of the wire in mode
        ``sum``; the q8 / q4 rows dequantized onto the (Dq,) grid; in the
        int8-dot regime, given ``coeff_scale``, the int8-dot kernel on
        that grid), and its weight mass, the in-order sum of its host
        weights."""
        lead = rows[0] if isinstance(rows, tuple) else rows
        wt = torch.from_numpy(np.ascontiguousarray(w)).to(lead.device)
        if coeff_scale is not None:
            g = weighted_sum_q8_int8dot(
                *rows, wt, self.qblock,
                coeff_scale=coeff_scale.to(lead.device))
        elif self.wire == "topk":
            g = safl_aggregate_topk(*rows, wt, self.d, qblock=self.qblock)
        elif self._qk is not None:
            g = self._qk.aggregate(*rows, wt, mode="sum", qblock=self.qblock)
        else:
            g = safl_aggregate(rows, wt, mode="sum")
        return g, sum_in_order(w)

    def _row_payloads(self, buf) -> list:
        """Each buffered row's payload tuple in slot order, on the
        server's device."""
        out = []
        for part in (buf if self.mesh is not None else [buf]):
            arrays = part if isinstance(part, tuple) else (part,)
            for i in range(arrays[0].shape[0]):
                # a shard's row leaves its device for the server's
                out.append(tuple(a[i].to(self.device) for a in arrays))
        return out

    def step(self, params_flat: torch.Tensor, buf, wvec: np.ndarray,
             opt: Dict):
        """Buffered round: (D,) params, the channel's rows, (K,)
        np.float32 final weights (fedasync: the raw mix rates a_i) ->
        (new params, new opt, {update_norm, weight_sum})."""
        wvec = np.asarray(wvec, np.float32)
        quant = self._qk is not None
        if self.mode == "fedasync":
            # the K sequential mixes as K folds into a zeroed row, the
            # same fold program the streaming channel runs
            bank = torch.zeros((1, self.bank_width), dtype=torch.float32,
                               device=self.device)
            pprod = np.float32(1.0)
            for a, row in zip(wvec, self._row_payloads(buf)):
                beta = np.float32(1.0) - a
                bank = self.fold_program(bank, *row, 0, a, beta)
                pprod = np.float32(pprod * beta)
            new, wsum = self._mix(params_flat, bank[0][:self.d], pprod)
            return new, opt, self._metrics(new, params_flat, wsum)
        if self.mesh is not None:
            # per-shard partials, the mesh's tree, one step body; the
            # int8-dot regime keys on the global K
            kw = ({"coeff_scale": self._mesh_coeff_scale(buf, wvec)}
                  if self._int8dot(len(wvec)) else {})
            gsum, wsum = self._pod_reduce(buf, wvec, **kw)
            new, opt = self._from_sums(params_flat, gsum[:self.d], wsum,
                                       opt)
            return new, opt, self._metrics(new, params_flat,
                                           sum_in_order(wvec))
        if self._int8dot(len(wvec)):
            new, opt = self._int8dot_step(params_flat, buf, wvec, opt)
            return new, opt, self._metrics(new, params_flat,
                                           sum_in_order(wvec))
        w = torch.from_numpy(wvec).to(self.device)
        lr, d = self.server_lr, self.d
        if self.wire == "topk":
            # every mode steps from the scatter-sum, as the finalize does
            gsum = safl_aggregate_topk(*buf, w, d, qblock=self.qblock)
            new, opt = self._from_sums(params_flat, gsum,
                                       sum_in_order(wvec), opt)
        elif self.mode == "sdga":
            kw = dict(server_lr=lr, momentum=self.momentum,
                      ema_anchor=self.ema_anchor, ema_decay=EMA_DECAY,
                      discount="none")
            if quant:
                new, m, e = self._qk.sdga(
                    *buf, w, params_flat, opt["momentum"], opt["ema"],
                    qblock=self.qblock, **kw)
            else:
                new, m, e = sdga_aggregate(buf, w, params_flat,
                                           opt["momentum"], opt["ema"], **kw)
            opt = self._sdga_opt(opt, m, e)
        elif self.mode in ("fedsgd", "fedbuff"):
            if quant:
                new = self._qk.aggregate(*buf, w, params_flat, server_lr=lr,
                                         mode="fedsgd", qblock=self.qblock)
            else:
                new = safl_aggregate(buf, w, params_flat, server_lr=lr,
                                     mode="fedsgd")
        else:  # fedavg's model mean, fedopt's gradient mean
            if quant:
                g = self._qk.aggregate(*buf, w, mode="avg",
                                       qblock=self.qblock)[:d]
            else:
                g = safl_aggregate(buf, w, mode="avg")
            if self.mode == "fedopt":
                new, opt = self._adam(params_flat, g, opt)
            else:
                new = g
        return new, opt, self._metrics(new, params_flat, sum_in_order(wvec))

    def _int8dot_step(self, p0, buf, wvec: np.ndarray, opt):
        """The single device's round in the int8-dot regime, as the
        reference's ``q8_mean`` and step: the weights normalized on the
        host, ``w / max(sum w, 1e-12)`` (the sum in the reference's jitted
        order, :func:`~repro_torch.sharding.flat.xla_sum`), one int8-dot
        launch for the mean,
        then each mode's step in PyTorch ops in the reference's op order
        (the fused q8 aggregate is not launched)."""
        wn = wvec / max(xla_sum(wvec), np.float32(1e-12))
        g = weighted_sum_q8_int8dot(
            *buf, torch.from_numpy(wn).to(self.device), self.qblock)
        return self._step_from_mean(p0, g[:self.d], opt)

    def fold_program(self, bank: torch.Tensor, *args) -> torch.Tensor:
        """``fold_program(bank, *payload, ridx, w, beta)``: bank[ridx] <-
        beta*bank[ridx] + w*payload, in place (payload = (vec,) f32,
        (q_row, s_row) on q8 / q4, (idx_row, qv_row, s_row) on top-k).
        Only fedasync folds with a live beta; every other mode folds with
        beta = 1."""
        *payload, ridx, w, beta = args
        if self.mode != "fedasync":
            beta = 1.0
        row = bank[ridx]
        if self.wire == "topk":
            safl_fold_topk(row, *payload, w, beta, qblock=self.qblock,
                           out=row)
        elif self._qk is not None:
            self._qk.fold(row, *payload, w, beta, qblock=self.qblock, out=row)
        else:
            safl_fold(row, *payload, w, beta, out=row)
        return bank

    def _from_sums(self, p0, gsum, wsum, opt):
        """The reference's ``_from_sums`` in its op order
        (``p0 - lr * (gsum / wsafe)``), so the result equals the buffered
        ``step`` bitwise."""
        return self._step_from_mean(
            p0, gsum / self._scalar(max(wsum, np.float32(1e-12))), opt)

    def _step_from_mean(self, p0, g, opt):
        """Each mode's server step from the weighted mean ``g`` (fedasync
        aside), in the reference's op order."""
        if self.mode == "fedavg":
            return g, opt
        if self.mode in ("fedsgd", "fedbuff"):
            return p0 - self.server_lr * g, opt
        if self.mode == "sdga":
            new, m, e = ref.sdga_step_from_mean(
                g, p0, opt["momentum"], opt["ema"],
                server_lr=self.server_lr, momentum=self.momentum,
                ema_anchor=self.ema_anchor, ema_decay=EMA_DECAY)
            return new, self._sdga_opt(opt, m, e)
        return self._adam(p0, g, opt)

    def finalize(self, params_flat: torch.Tensor, bank, wvec: np.ndarray,
                 opt: Dict, pprod=1.0):
        """Streaming round from a sealed bank (on a mesh the shards'
        banks, ``wvec`` their weights shard-major; fedasync folds into
        shard 0's alone), ``pprod`` fedasync's host-tracked survival
        product.  Returns (new params, opt, metrics, the bank zeroed for
        reuse)."""
        banks = bank if self.mesh is not None else [bank]
        if self.mode == "fedasync":
            new, wsum = self._mix(params_flat, banks[0][0][:self.d], pprod)
        else:
            if self.mesh is not None:
                gsum, wsum = self._bank_reduce(banks, wvec)
            else:
                gsum, wsum = bank[0], sum_in_order(wvec)
            new, opt = self._from_sums(params_flat, gsum[:self.d], wsum,
                                       opt)
        zeroed = [b.zero_() for b in banks]
        return (new, opt, self._metrics(new, params_flat, wsum),
                zeroed if self.mesh is not None else zeroed[0])
