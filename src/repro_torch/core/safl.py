"""SFL / SAFL engine (paper §2.2, Fig. 1): discrete-event simulation.

Only *simulated* wall-clock (per-client compute speeds + communication
latency) is event-driven; simulated time orders the events and defers no
computation.

Synchronous (SFL, Fig. 1a): each round the server activates K random
clients, waits for all of them (round time = slowest active client, the
straggler effect), aggregates, broadcasts.  The K clients train (one
after another on the sequential engine, as one wave on the batched one)
into the (K, D) buffer (int8 (K, Dq) rows on the q8 wire, packed
int4 (K, Dq/2) bytes on q4, (K, nk) sparse index / value rows on top-k),
and the round is one aggregate kernel
(:func:`repro_torch.kernels.safl_agg.safl_aggregate`, ``sdga_aggregate``
or their ``_q8`` / ``_q4`` siblings, ``safl_aggregate_topk``; fedasync
folds its K rows).

Semi-asynchronous (SAFL, Fig. 1b): clients train continuously at their
own pace and upload after each local epoch; every upload is folded into
an O(D) running sum the moment it lands (``safl_fold``,
``safl_fold_q8``, ``safl_fold_q4``, ``safl_fold_topk``: the streaming
channel), and the
server aggregates as
soon as K uploads are in.  A
client adopts the newest global model at its next upload boundary,
otherwise it continues training its local one, so uploads carry
staleness tau = t_now - t_client_version.

Faults and defense (semi-async only, as in the reference): the
scheduler's counter-keyed fault plan crashes uploads (the client resyncs
and retries after a backoff) and stretches stragglers; a corrupt or
Byzantine draw poisons the serialized payload after the error-feedback
residual update (:mod:`repro_torch.faults.payload`).  With ``defense``
on, each upload is screened as it lands (``FlatServer.screen``, the
``screen_rows`` kernel or its ``_q8`` / ``_q4`` sibling (``_q8`` over a
top-k upload's values), then
:func:`repro_torch.faults.defense_factors`): a screened row is skipped
by the streaming channel and zeroed on the buffered one, a clipped row
keeps its payload at a reduced weight.

Scheduling (:mod:`repro_torch.sched`): the timing model (static,
lognormal, Markov) sets when each upload lands, the policy gives each a
verdict (admit; reject and crash, which resync the client to the global
model; idle, which leaves its chain alone) and FedQS's scores enter the
weights (:meth:`FLEngine._weight_vector`).  A horizon closes on K admitted
uploads (``k``), on ``horizon_queue`` of them (``queue``), on the first
event ``horizon_timeout_s`` simulated seconds after the last aggregation
(``timeout``; streaming channel only), or on whichever of the two comes
first (``hybrid``), checked on every popped event's clock.
:meth:`FLEngine.save_snapshot` / :meth:`FLEngine.load_snapshot` carry a
semi-async engine across a kill at a ``run()`` boundary bit for bit.

Horizon-batched execution (``batch_clients=True``, the default, as in
the reference): between two aggregation boundaries the K uploads of a
horizon depend only on state fixed at the previous boundary, so the
engine pops the scheduler to the next horizon up front, groups its
events into *waves* (a client's j-th event of the horizon is wave j) and
trains each wave as one call over K flat parameter rows
(:func:`repro_torch.core.client.make_batched_hetero_train`; the sync
round's K lanes start from one global model).  A wave's rows are
quantized by the codec's row forms, faulted, screened in one launch with
one host fetch, and folded in slot order (the streaming channel: the
sequential engine's order, since fedasync's mix does not commute and a
float sum depends on its order) or scattered into their slots
(buffered).  Clients carry flat (D,) rows; eval and update-norm scalars
stay in a device ring
(:class:`repro_torch.core.metrics.DeviceMetricsRing`) until the run ends.
``batch_clients=False`` runs the sequential per-upload engine, the
parity oracle; with ``wave_impl="map"`` (what ``auto`` picks for the
conv models) the batched engine equals it bit for bit.  ``wave_buckets``
is accepted for the reference's configs and changes nothing: the
reference pads a wave to a power of two so XLA compiles few shapes, and
PyTorch compiles nothing per shape, so every wave runs at its own size.

The non-trainable model state (ResNet-18's BatchNorm statistics) rides
beside the flat rows as a tree (:mod:`repro_torch.tree`): each upload
carries its client's new state, fedavg's server round takes the uploads'
sample-weighted mean and every other mode adopts the newest upload's; a
model target on the q8 / q4 wire ships the state on the q8 wire, so the
server sees its quantize -> dequantize roundtrip and the upload's bytes
count ``dq + 4 * n_qblocks`` of the state codec (the clients keep their
exact state).  Token inputs (the LSTM's) stay int64 on the device.

Both engines copy the reference's host arithmetic exactly: np.float32
weight vectors, the simulated-time model, the byte envelopes, the
``rng.choice`` of the sync round, and the q4 wire's per-client upload
counters, which key its stochastic-rounding draws.  So bytes, staleness
and participation match the reference bit for bit.  Parameters live on
``device`` (CUDA unless the caller asks for the CPU); the global model is
a flat (D,) row in the reference's layout.

Multi-device (``devices > 1`` or ``mesh_shape=(E, P)``), on one
controller: the engine builds the 1-D pod mesh or the 2-D (edge, pod)
mesh (:mod:`repro_torch.sharding.flat`) over ``device`` (a list of the
shards' devices, ``"cpu"`` for N shards on the CPU, or the first N GPUs,
which must be visible).  The buffered channel's K rows live K/N a shard
on the shards' devices (:class:`repro_torch.core.flatbuf.MeshRows`), the
streaming channel keeps one bank a shard (upload i folds into the shard
whose rows hold slot i: :meth:`FLEngine._fold_shard`), a wave's lanes
train on the device of the shard that owns their row, and the server
round reduces per-shard ``sum`` partials in the mesh's order before the
one step body (:class:`repro_torch.core.aggregation.FlatServer`).  The
schedule, the weights and every other host decision are made once, so
bytes, staleness and simulated times are the single-device run's.

Tracing (``trace_level`` ``round`` or ``upload``): a
:class:`repro_torch.obs.trace.SpanTracer` on the simulated clock, fed by
the three run paths and the scheduler's pops with values the engine
already holds on the host, so a traced run launches the same kernels
and ends bitwise where the untraced one ends; ``wall_run_s`` sums the
wall seconds inside :meth:`FLEngine.run`.

Ported: the settings in :data:`FLEngine.PORTED`.  Anything else raises
``NotImplementedError`` rather than running something else.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import faults as faultsmod
from repro_torch import sched as schedmod
from repro_torch import tree
from repro_torch.checkpoint import io as ckptio
from repro_torch.core import flatbuf
from repro_torch.core.aggregation import FlatServer, weighted_mean
from repro_torch.core.client import (ClientState, evaluate, local_epoch,
                                     make_batched_hetero_train,
                                     make_batched_local_train,
                                     make_flat_eval_fn, make_loss_fn,
                                     pytree_bytes, resolve_wave_impl)
from repro_torch.core.metrics import (DeviceMetricsRing, MetricsLog,
                                      RoundRecord)
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import payload_nbytes
from repro_torch.obs.trace import SpanTracer
from repro_torch.sharding import flat as shflat

# width of the ``staleness_bins`` histogram (last bin = overflow; filled
# by the horizon-batched semi-async path only, as in the reference)
_STALE_BINS = 32

# simulated samples/second at speed 1.0
_BASE_RATE = 500.0
# serialization envelope: full-model upload (FedAvg) carries the layer
# structure; gradient upload (FedSGD) is a bare tensor list (paper §5.1.2)
_MODEL_ENVELOPE = 0.010
_GRAD_ENVELOPE = 0.002

# aggregation targets that upload model weights (vs cumulative gradients)
_MODEL_TARGETS = ("fedavg", "fedasync")


def _inputs(x) -> np.ndarray:
    """A dataset's inputs as the models take them: integer tokens (the
    LSTM's embedding indices) as int64, images as float32."""
    x = np.asarray(x)
    return x.astype(np.int64 if np.issubdtype(x.dtype, np.integer)
                    else np.float32)


@dataclasses.dataclass
class FLResult:
    metrics: MetricsLog
    final_params: Dict
    staleness_hist: Dict[int, int]
    idle_time: float  # SFL: total simulated idle seconds across clients
    participation: Optional[np.ndarray] = None
    sched_stats: Optional[Dict] = None


class FLEngine:
    """One experiment = FLEngine(...).run(n_rounds)."""

    #: FLConfig fields this slice runs, with the values it takes.  The
    #: engine refuses any other value with "not ported yet".
    PORTED = {
        "aggregation": ("fedsgd", "fedavg", "fedbuff", "fedasync", "fedopt",
                        "sdga"),
        "wire": ("f32", "q8", "q4", "topk"),
        "compress_updates": (False, True),
        "horizon": ("k", "queue", "timeout", "hybrid"),
        "sched_timing": ("static", "lognormal", "markov"),
        "sched_policy": ("full", "uniform", "seafl", "fedqs", "ratelimit"),
        "batch_clients": (False, True),
        "trace_level": ("off", "round", "upload"),
    }

    def __init__(self, fl_cfg, apply_fn: Callable, kind: str,
                 init_params: Dict, init_state,
                 client_shards: Sequence[Dict[str, np.ndarray]],
                 test_x: np.ndarray, test_y: np.ndarray, *,
                 device="cuda"):
        fl_cfg.validate()
        for field, ok in self.PORTED.items():
            val = getattr(fl_cfg, field)
            if val not in ok:
                raise NotImplementedError(
                    f"FLConfig.{field}={val!r} is not ported yet "
                    f"(ported: {ok})")
        # the mesh: devices=N -> the 1-D pod mesh, mesh_shape=(E, P) ->
        # the 2-D (edge, pod) mesh (E = 1 builds the 1-D mesh, so the
        # alias is the devices=P path bit for bit) over ``device`` (a
        # device list, "cpu", or the first E*P GPUs); shard 0's device is
        # the engine's own.  A 1-D mesh adds its partials in shard order,
        # so N need not be a power of two (the reference's engine builds
        # it through make_hier_mesh, which asserts one)
        self._mesh = None
        if fl_cfg.mesh_devices > 1:
            self._mesh = (
                shflat.make_hier_mesh(*fl_cfg.mesh_shape, devices=device)
                if fl_cfg.mesh_shape is not None
                else shflat.make_pod_mesh(fl_cfg.devices, devices=device))
            device = self._mesh.home
        elif isinstance(device, (list, tuple)):
            device = device[0]
        self.device = dev = resolve_device(device)
        self.cfg = fl_cfg
        self.kind = kind
        self.apply_fn = apply_fn
        self.loss_fn = make_loss_fn(apply_fn, kind)
        self.test_x = torch.as_tensor(_inputs(test_x), device=dev)
        self.test_y = torch.as_tensor(np.asarray(test_y, np.int64),
                                      device=dev)
        init_params = tree.tree_map(lambda v: v.to(dev), init_params)
        init_state = tree.tree_map(lambda v: v.to(dev), init_state)

        rng = np.random.default_rng(fl_cfg.seed)
        self.clients: List[ClientState] = []
        for cid, shard in enumerate(client_shards):
            speed = float(np.exp(rng.normal(0.0, fl_cfg.speed_sigma)))
            comm = float(fl_cfg.comm_mean_s
                         * np.exp(rng.normal(0.0, 0.3)))
            self.clients.append(ClientState(
                cid=cid, params=init_params, model_state=init_state,
                version=0, n_samples=int(shard["n"]), speed=speed,
                comm_time=comm, rng=np.random.default_rng(
                    fl_cfg.seed * 7919 + cid)))
        # shards move to the device once; which batches hold a real
        # sample is kept on the host
        self.shards = [{
            "xs": torch.as_tensor(_inputs(s["xs"]), device=dev),
            "ys": torch.as_tensor(np.asarray(s["ys"], np.int64), device=dev),
            "mask": torch.as_tensor(np.asarray(s["mask"], np.float32),
                                    device=dev),
            "valid": np.asarray(s["mask"]).max(axis=1) > 0,
        } for s in client_shards]
        self.global_params = init_params
        self.global_state = init_state
        self.t_global = 0
        self.rng = rng

        self.sched = schedmod.build_scheduler(fl_cfg, self.clients,
                                              self._base_compute)
        self.metrics = MetricsLog(fl_cfg.target_accuracy,
                                  fl_cfg.oscillation_thresholds)
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.staleness_hist: Dict[int, int] = {}
        self.idle_time = 0.0
        self._params_bytes = pytree_bytes(init_params)
        self._state_bytes = pytree_bytes(init_state)
        self._last_update_norm = 0.0

        self.codec = flatbuf.PytreeCodec(init_params,
                                         qblock=fl_cfg.quant_block,
                                         topk_frac=fl_cfg.topk_frac)
        self._flat_params = self.codec.ravel(init_params)
        # wire of the upload channel; compress_updates is the legacy q8
        # alias
        self._wire = fl_cfg.wire
        if self._wire == "f32" and fl_cfg.compress_updates:
            self._wire = "q8"
        self._lossy = self._wire != "f32"
        # per-client error-feedback residuals (dq,), made at first upload
        self._residuals: Dict[int, torch.Tensor] = {}
        # q4 stochastic rounding: per-client upload counters; upload n of
        # client c draws with the key fold_in(fold_in(key(seed), c), n)
        self._sr_counter: Dict[int, int] = {}
        # a 0.0 momentum / anchor in the config means the default, as in
        # the reference
        self._server = FlatServer(
            fl_cfg.aggregation, self.codec.d, server_lr=fl_cfg.server_lr,
            momentum=fl_cfg.server_momentum or 0.8,
            ema_anchor=fl_cfg.ema_anchor or 0.05, wire=self._wire,
            qblock=fl_cfg.quant_block, device=dev, mesh=self._mesh)
        self._opt = self._server.init_opt(self._flat_params)
        # model targets on the q8 / q4 wire: the non-trainable state
        # (BatchNorm statistics) ships on the q8 wire beside the weights
        # (q4 too: the state is tiny next to D); the server sees its
        # quantize -> dequantize roundtrip, the clients keep their exact
        # state
        self._state_codec = None
        if (self._wire in ("q8", "q4")
                and fl_cfg.aggregation in _MODEL_TARGETS
                and not tree.is_empty(init_state)):
            self._state_codec = flatbuf.PytreeCodec(
                init_state, qblock=fl_cfg.quant_block)
        # server channel: "auto" is streaming for semi-async (uploads
        # trickle in) and buffered for sync (a round's rows come together)
        self._channel = fl_cfg.server_channel
        if self._channel == "auto":
            self._channel = ("streaming" if fl_cfg.mode == "semi_async"
                             else "buffered")
        self._streaming = self._channel == "streaming"
        # per-horizon upload target: the k and queue horizons close on a
        # count, timeout / hybrid on the clock (None: streaming only,
        # validate() refuses the buffered channel there)
        if fl_cfg.horizon == "queue":
            self._horizon_target: Optional[int] = (fl_cfg.horizon_queue
                                                   or fl_cfg.k)
        elif fl_cfg.horizon in ("timeout", "hybrid"):
            self._horizon_target = None
        else:
            self._horizon_target = fl_cfg.k
        # simulated time of the last aggregation (the clock horizons)
        self._last_agg_time = 0.0
        # defense layer (none | screen | clip) and the fault / defense
        # counts of the run
        self._defense = fl_cfg.defense
        self.screened_uploads = 0
        self.clipped_uploads = 0
        self.corrupted_uploads = 0
        self.byzantine_uploads = 0
        # the batched engine's state: the staleness histogram of
        # ``staleness_bins``, summed over run() calls; the lane execution
        # (resolved at first use); the histogram of wave sizes; the
        # (n_clients, ...) shard bank on each device that trains lanes;
        # each client's flat row
        self._staleness_bins = np.zeros(_STALE_BINS, np.int64)
        self.wave_impl_resolved: Optional[str] = None
        self.wave_size_hist: Dict[int, int] = {}
        self._shard_banks: Dict[torch.device, Dict] = {}
        self._client_flats: Optional[List[torch.Tensor]] = None
        # the server channel: the streaming banks (one a mesh shard, each
        # on its device), or the buffered rows (K / N a shard on a mesh)
        self._accum = None
        self._rows = None
        if self._streaming:
            self._accum = flatbuf.AccumBuffer(
                self._server.bank_width, self._server.fold_program, dev,
                mesh=self._mesh)
        else:
            codec, qb = self.codec, fl_cfg.quant_block

            def make(k, on):
                if self._wire == "topk":
                    return flatbuf.TopkBuffer(k, codec.d, codec.nk, qb,
                                              device=on)
                if self._lossy:
                    return flatbuf.QuantBuffer(k, codec.d, qb, device=on,
                                               packed=self._wire == "q4")
                return flatbuf.RowBuffer(k, codec.d, device=on)

            self._rows = (make(self._horizon_target, dev)
                          if self._mesh is None else
                          flatbuf.MeshRows(make, self._horizon_target,
                                           self._mesh))
        # wall seconds inside run() (the folds-per-second gauge)
        self.wall_run_s = 0.0
        # the span tracer (repro_torch.obs.trace), none with tracing off;
        # every site is gated on it and records host values only
        self.tracer: Optional[SpanTracer] = None
        if fl_cfg.trace_level != "off":
            self.tracer = SpanTracer(
                fl_cfg.trace_dir, fl_cfg.trace_level,
                meta=dict(mode=fl_cfg.mode, aggregation=fl_cfg.aggregation,
                          wire=self._wire, channel=self._channel,
                          horizon=fl_cfg.horizon, defense=self._defense,
                          n_clients=len(self.clients), k=fl_cfg.k,
                          d=self.codec.d, seed=fl_cfg.seed))
            self.sched.tracer = self.tracer

    # ------------------------------------------------------------------
    def _base_compute(self, c: ClientState) -> float:
        """Deterministic simulated compute seconds for one upload period
        (local_epochs) of c."""
        per_epoch = c.n_samples / (_BASE_RATE * c.speed)
        return per_epoch * self.cfg.local_epochs

    def _agg_overhead(self) -> float:
        # weighted aggregation bookkeeping costs 0.05 simulated seconds per
        # buffered update; FedSGD's unweighted mean a flat 0.01 s
        return 0.05 * self.cfg.k if self.cfg.aggregation != "fedsgd" else 0.01

    def _fold_shard(self, slot: int) -> int:
        """The bank the streaming fold of upload ``slot`` goes into.  With
        a count horizon whose target splits over the N shards, slot i
        folds into the shard whose block of the buffered channel's rows
        holds slot i (on the 2-D mesh shard e*P + p of edge e), so each
        shard's bank sums exactly the rows the buffered channel puts
        there, in the same order, and the mesh rounds of the two channels
        agree bitwise; clock horizons deal the slots round-robin.
        fedasync always folds into bank 0: its mixes are one chain that
        does not commute."""
        if self._mesh is None or self.cfg.aggregation == "fedasync":
            return 0
        n = self._mesh.size
        t = self._horizon_target
        if t is not None and t % n == 0:
            return min(slot // (t // n), n - 1)
        return slot % n

    def _row_shard(self, slot: int) -> int:
        """The shard that owns upload ``slot``'s row: its bank on the
        streaming channel, its block of K/N rows on the buffered one."""
        if self._mesh is None:
            return 0
        if self._streaming:
            return self._fold_shard(slot)
        return slot // (self._horizon_target // self._mesh.size)

    def _horizon_due(self, count: int, now: float) -> bool:
        """Aggregation-horizon trigger (``FLConfig.horizon``), the
        reference's rule: close on the paper's K count or an explicit
        queue length, on a simulated-clock timeout since the last
        aggregation (at least one upload buffered), or on whichever of
        queue / timeout comes first (hybrid)."""
        if count <= 0:
            return False
        cfg = self.cfg
        if cfg.horizon in ("k", "queue"):
            return count >= self._horizon_target
        timed = now >= self._last_agg_time + cfg.horizon_timeout_s
        if cfg.horizon == "timeout":
            return timed
        return timed or count >= (cfg.horizon_queue or cfg.k)  # hybrid

    def _run_local(self, c: ClientState):
        """Run one local upload period (local_epochs) for client c.  The
        returned loss is a device scalar, never fetched in the loop."""
        shard = self.shards[c.cid]
        params, state = c.params, c.model_state
        loss = torch.zeros((), device=self.device)
        for _ in range(self.cfg.local_epochs):
            params, state, loss = local_epoch(
                self.loss_fn, params, state, shard["xs"], shard["ys"],
                shard["mask"], shard["valid"], self.cfg.client_lr)
        return params, state, loss

    # ------------------------------------------------------------------
    def _upload_nbytes(self) -> int:
        """Channel cost of one upload: the wire's payload
        (:func:`repro_torch.kernels.quantize.payload_nbytes`; q8: int8
        values + block scales; q4: two lanes per byte + the same scales;
        topk: index + value per kept coordinate + the compacted values'
        scales) plus the serialization envelope of its target (model
        weights carry the state and the layer structure; the state at its
        q8 bytes, ``dq + 4 * n_qblocks`` of the state codec, where it
        rides the lossy wire, else its raw bytes)."""
        if self._lossy:
            payload = payload_nbytes(self._wire, d=self.codec.d,
                                     dq=self.codec.dq,
                                     n_qblocks=self.codec.n_qblocks,
                                     nk=self.codec.nk,
                                     nk_qblocks=self.codec.nk_qblocks)
        else:
            payload = self._params_bytes
        if self.cfg.aggregation in _MODEL_TARGETS:
            sc = self._state_codec
            state = (self._state_bytes if sc is None
                     else sc.dq + sc.n_qblocks * 4)
            return int((payload + state) * (1 + _MODEL_ENVELOPE))
        return int(payload * (1 + _GRAD_ENVELOPE))

    def _state_q8(self, state):
        """The server's view of a model-target upload's state: its q8
        roundtrip where the state rides the lossy wire, else itself."""
        if self._state_codec is None:
            return state
        return self._state_codec.roundtrip_q8(state)

    def _state_q8_rows(self, states):
        """:meth:`_state_q8` of K-stacked states."""
        if self._state_codec is None:
            return states
        return self._state_codec.roundtrip_q8_rows(states)

    def _residual(self, cid: int) -> torch.Tensor:
        """Client-side error-feedback residual (zeros before the client's
        first upload)."""
        res = self._residuals.get(cid)
        if res is None:
            res = self.codec.zero_residual(self.device)
        return res

    def _next_counter(self, cid: int) -> int:
        """q4 stochastic-rounding upload counter of client ``cid``: how
        many q4 uploads the client made before this one."""
        n = self._sr_counter.get(cid, 0)
        self._sr_counter[cid] = n + 1
        return n

    def _payload(self, c: ClientState, w_end) -> tuple:
        """The upload's wire payload: ``(vec,)`` f32, ``(q, scales)`` on
        q8 / q4, ``(idx, qv, scales)`` on top-k (gradient targets only),
        where gradient targets quantize with the client's error-feedback
        residual (kept client-side) and model targets without; q4 draws
        with the key of (seed, client, upload counter)."""
        cfg, codec = self.cfg, self.codec
        if self._wire == "f32":
            if cfg.aggregation in _MODEL_TARGETS:
                return (codec.ravel(w_end),)
            return (codec.ravel_delta(c.params, w_end, cfg.client_lr),)
        if self._wire == "topk":
            if not cfg.error_feedback:
                return codec.ravel_delta_topk_nores(c.params, w_end,
                                                    cfg.client_lr)
            *payload, self._residuals[c.cid] = codec.ravel_delta_topk(
                c.params, w_end, cfg.client_lr, self._residual(c.cid))
            return tuple(payload)
        if self._wire == "q4":
            key = (cfg.seed, c.cid, self._next_counter(c.cid))
            model, grad, grad_nores = (codec.ravel_q4_nores,
                                       codec.ravel_delta_q4,
                                       codec.ravel_delta_q4_nores)
        else:
            key = ()
            model, grad, grad_nores = (codec.ravel_q8_nores,
                                       codec.ravel_delta_q8,
                                       codec.ravel_delta_q8_nores)
        if cfg.aggregation in _MODEL_TARGETS:
            return model(w_end, *key)
        if not cfg.error_feedback:
            return grad_nores(c.params, w_end, cfg.client_lr, *key)
        q, s, self._residuals[c.cid] = grad(
            c.params, w_end, cfg.client_lr, self._residual(c.cid), *key)
        return q, s

    def _apply_payload_faults(self, rows: tuple, faults: List) -> tuple:
        """Corrupt / byzantine draws (None: no fault) applied to a K-stack
        of payload rows (K = 1 on the sequential path).  Untouched lanes
        come back bitwise; a top-k upload's indices are never touched.
        No-op without a fault in the stack."""
        if not any(f is not None for f in faults):
            return rows
        corrupt = [f is not None and f.kind == "corrupt" for f in faults]
        byz = [f is not None and f.kind == "byzantine" for f in faults]
        locs = [f.loc if f is not None else 0.0 for f in faults]
        self.corrupted_uploads += sum(corrupt)
        self.byzantine_uploads += sum(byz)
        resc = self.cfg.fault_byzantine_rescale
        if self._wire == "topk":
            return rows[:1] + faultsmod.apply_faults_q(*rows[1:], corrupt,
                                                       byz, locs, resc)
        if self._lossy:
            return faultsmod.apply_faults_q(*rows, corrupt, byz, locs, resc)
        return (faultsmod.apply_faults_flat(rows[0], corrupt, byz, locs,
                                            resc),)

    def _screen_factors(self, rows: tuple) -> np.ndarray:
        """The defense's weight factors of a K-stack of payload rows (K = 1
        on the sequential path): one screen launch and one host fetch for
        the stack, then the host's screen / clip composition."""
        sumsq = self._server.screen(rows).cpu().numpy()
        fac, ns, ncl = faultsmod.defense_factors(
            sumsq, self._defense, self.cfg.defense_norm_cap)
        self.screened_uploads += ns
        self.clipped_uploads += ncl
        return fac

    def _zero_screened_rows(self, rows: tuple, mask: np.ndarray) -> tuple:
        """Zero the payload of the screened rows of a K-stack before the
        buffered scatter: the f32 row, or on a lossy wire the scales (a
        zero scale dequantizes any row to 0).  Unmasked rows come back
        bitwise."""
        m = torch.as_tensor(mask, device=rows[-1].device)[:, None]
        return rows[:-1] + (torch.where(m, 0.0, rows[-1]),)

    def _enqueue_upload(self, buffer: List[Dict], c: ClientState,
                        w_end, s_end, staleness: int, fault=None) -> None:
        """Serialize one upload.  Streaming channel: fold it into the
        running O(D) sum with its FINAL weight (discount-at-ingest) and,
        for fedasync, its survival factor beta = 1 - a_i.  Buffered
        channel: write it into the next free row.  Must run before
        ``c.params`` is refreshed (gradient targets diff against the
        client's round-start weights).  ``fault`` is a corrupt / byzantine
        draw applied to the serialized payload; with a defense on, the
        row is screened before it touches the channel: a row with factor
        0 is skipped (streaming) or zeroed (buffered: the f32 row, or the
        q8 / q4 / top-k scales, since a zero scale dequantizes any row to
        0)."""
        cfg = self.cfg
        entry: Dict = {"staleness": staleness, "cid": c.cid,
                       "n": c.n_samples}
        payload = self._payload(c, w_end)
        if fault is not None:
            payload = tuple(a[0] for a in self._apply_payload_faults(
                tuple(a[None] for a in payload), [fault]))
        fac = None
        if self._defense != "none":
            fac = entry["fac"] = self._screen_factors(
                tuple(a[None] for a in payload))[0]
        dropped = fac is not None and fac == np.float32(0.0)
        slot = len(buffer)
        if self._streaming:
            shard = self._fold_shard(slot)
            if dropped:
                self._accum.skip(shard=shard)
            else:
                w = self._weight_vector([staleness], [c.n_samples])[0]
                if fac is not None:
                    w = np.float32(w * fac)
                beta = (np.float32(1.0) - w
                        if cfg.aggregation == "fedasync" else 1.0)
                self._accum.fold(payload, w=w, beta=beta, shard=shard)
        else:
            if dropped:
                payload = payload[:-1] + (torch.zeros_like(payload[-1]),)
            self._rows.write(*payload, slot)
        if cfg.aggregation in _MODEL_TARGETS:
            s_end = self._state_q8(s_end)
        entry["state"] = s_end
        self.tx_bytes += self._upload_nbytes()
        buffer.append(entry)

    # ------------------------------------------------------------------
    def _weight_vector(self, staleness: Sequence[int],
                       sizes: Sequence[int]) -> np.ndarray:
        """FINAL per-upload aggregation weights, np.float32 on host
        (discount-at-ingest): fedavg data sizes, fedsgd units, the
        (1+tau)^-alpha discount of fedbuff / fedopt / sdga, fedasync's raw
        mix rates a_i = clip(fedasync_alpha * (1+tau)^-alpha * score, 0,
        1), each times a reweighting policy's score (fedqs).  The
        streaming channel folds weight i when upload i lands, the buffered
        one applies the whole vector in its reduction (numpy's scalar and
        vector kernels agree bitwise)."""
        cfg = self.cfg
        policy = self.sched.policy
        score = (policy.score(staleness, sizes)
                 if policy.reweights else None)
        stal = np.asarray(staleness, np.float32)
        if cfg.aggregation == "fedasync":
            a = cfg.fedasync_alpha * np.power(
                stal + 1.0, -np.float32(cfg.staleness_alpha))
            if score is not None:
                a = np.clip(a * np.asarray(score, np.float32), 0.0, 1.0)
            return np.asarray(a, np.float32)
        if cfg.aggregation == "fedavg":
            base = np.asarray(sizes, np.float32)
        elif cfg.aggregation == "fedsgd":
            base = np.ones((len(staleness),), np.float32)
        else:  # fedbuff / fedopt / sdga: the poly discount
            base = np.power(stal + 1.0, -np.float32(cfg.staleness_alpha))
        if score is not None:
            base = base * np.asarray(score, np.float32)
        return np.asarray(base, np.float32)

    def _record_staleness(self, staleness: Sequence[int]) -> None:
        for s in staleness:
            s = int(s)
            self.staleness_hist[s] = self.staleness_hist.get(s, 0) + 1

    def _broadcast_bytes(self) -> None:
        # broadcast of the new global model to all clients
        self.rx_bytes += int((self._params_bytes + self._state_bytes)
                             * len(self.clients))

    def _server_round(self, staleness: Sequence[int], sizes: Sequence[int],
                      facs: Optional[Sequence[np.float32]] = None) -> Dict:
        """Buffered-channel round: one aggregate kernel over the rows.
        ``facs`` are the defense's per-row factors, multiplied into the
        weights in f32 as the streaming channel does per upload, so both
        channels reduce the same final weights."""
        self._record_staleness(staleness)
        w = self._weight_vector(staleness, sizes)
        if facs is not None:
            w = w * np.asarray(facs, np.float32)
        self._flat_params, self._opt, m = self._server.step(
            self._flat_params, self._rows.views, w, self._opt)
        self.t_global += 1
        self._broadcast_bytes()
        return m

    def _server_round_streaming(self, staleness: Sequence[int]) -> Dict:
        """Streaming-channel round: seal the bank (swap in the spare),
        finalize from the partial sum, release the zeroed bank."""
        self._record_staleness(staleness)
        bank, wvec, stats = self._accum.seal()
        self._flat_params, self._opt, m, zeroed = self._server.finalize(
            self._flat_params, bank, wvec, self._opt, pprod=stats["pprod"])
        self._accum.release(zeroed)
        self.t_global += 1
        self._broadcast_bytes()
        return m

    def _aggregate(self, buffer: List[Dict], states_stacked=None) -> Dict:
        """Server round + unravel of the global model (views into the new
        flat row) + the non-trainable state: fedavg takes the uploads'
        sample-weighted mean (:func:`~repro_torch.core.aggregation.
        weighted_mean`), every other mode adopts the newest buffered
        state.  The states are ``states_stacked`` (K-stacked, the batched
        sync round's) or the entries' ``"state"``; entries without one
        (the batched semi-async path, which closes the state itself)
        leave the global state as it is."""
        stal = [b["staleness"] for b in buffer]
        if self._streaming:
            m = self._server_round_streaming(stal)
        else:
            facs = ([b["fac"] for b in buffer]
                    if self._defense != "none" else None)
            m = self._server_round(stal, [b["n"] for b in buffer], facs)
        self.global_params = self.codec.unravel(self._flat_params)
        self._last_update_norm = m["update_norm"]
        if self.cfg.aggregation == "fedavg":
            if states_stacked is None and buffer and "state" in buffer[0]:
                states_stacked = tree.tree_stack(
                    [b["state"] for b in buffer])
            if states_stacked is not None and \
                    not tree.is_empty(states_stacked):
                self.global_state = weighted_mean(
                    states_stacked, [b["n"] for b in buffer])
        elif states_stacked is not None:
            self.global_state = tree.tree_map(lambda leaf: leaf[-1],
                                              states_stacked)
        else:
            self.global_state = buffer[-1].get("state", self.global_state)
        return m

    def _eval_due(self, rnd: int, n_rounds: int) -> bool:
        """Evaluate every eval_every-th aggregation + always the last."""
        return rnd % self.cfg.eval_every == 0 or rnd == n_rounds

    def _eval_and_record(self, now: float, stale_vals: Sequence[int]) -> None:
        acc, loss = evaluate(self.apply_fn, self.kind, self.global_params,
                             self.global_state, self.test_x, self.test_y)
        acc, loss = float(acc), float(loss)
        self.metrics.record(
            round=self.t_global, sim_time=now, accuracy=acc, loss=loss,
            tx_bytes=self.tx_bytes, rx_bytes=self.rx_bytes,
            mean_staleness=float(np.mean(stale_vals)) if stale_vals else 0.0,
            max_staleness=int(max(stale_vals)) if stale_vals else 0,
            nan_event=not np.isfinite(loss),
            update_norm=float(self._last_update_norm),
            screened_uploads=self.screened_uploads,
            clipped_uploads=self.clipped_uploads)

    def _trace_round(self, stal: Sequence[int], sizes: Sequence[int],
                     facs, t0: float, t1: float) -> None:
        """Close the tracer's horizon: its aggregate and round spans, the
        ingest records' final weights (the ``_weight_vector`` x defense
        factor product both channels fold) and the counters."""
        w = self._weight_vector(stal, sizes)
        if facs is not None:
            w = w * np.asarray(
                [np.float32(1.0) if f is None else f for f in facs],
                np.float32)
        self.tracer.round(
            self.t_global, t0=t0, t1=t1, agg_s=self._agg_overhead(),
            k=len(stal), staleness=stal, weights=[float(x) for x in w],
            counts=dict(tx_bytes=int(self.tx_bytes),
                        rx_bytes=int(self.rx_bytes),
                        screened=int(self.screened_uploads),
                        clipped=int(self.clipped_uploads),
                        corrupted=int(self.corrupted_uploads),
                        byzantine=int(self.byzantine_uploads)))

    # ------------------------------------------------------------------
    def run(self, n_rounds: int, log_every: int = 0) -> FLResult:
        wall0 = time.perf_counter()
        if self.cfg.mode == "sync":
            self._run_sync(n_rounds, log_every)
        elif self.cfg.batch_clients:
            self._run_semi_async_batched(n_rounds, log_every)
        else:
            self._run_semi_async(n_rounds, log_every)
        self.wall_run_s += time.perf_counter() - wall0
        if self.tracer is not None:
            # a horizon left open at the run's end (it would stay pending
            # across run() calls otherwise)
            self.tracer.tail()
        stats = self.sched.stats()
        stats["staleness_bins"] = self._staleness_bins.copy()
        stats["screened_uploads"] = self.screened_uploads
        stats["clipped_uploads"] = self.clipped_uploads
        stats["corrupted_uploads"] = self.corrupted_uploads
        stats["byzantine_uploads"] = self.byzantine_uploads
        return FLResult(self.metrics, self.global_params,
                        self.staleness_hist, self.idle_time,
                        participation=self.sched.participation.copy(),
                        sched_stats=stats)

    # ----- crash-consistent snapshots -----
    def _snapshot_tree(self) -> Dict:
        """The snapshot's tensor tree, the reference's keys: the global
        flat row, the server's optimizer state (fedopt's moments, sdga's
        momentum and EMA, their step count), the global model state, the
        clients' error-feedback residuals and model states, and each
        client's carried model (flat rows on the batched engine, param
        trees on the sequential one)."""
        snap: Dict = {
            "flat_params": self._flat_params,
            "opt": self._opt_leaves(self._opt),
            "global_state": self.global_state,
            "residuals": {str(k): v for k, v in self._residuals.items()},
            "client_state": {str(c.cid): c.model_state
                             for c in self.clients},
        }
        if self.cfg.batch_clients:
            flats = (self._client_flats
                     or [self._flat_params] * len(self.clients))
            snap["client_rows"] = {str(c.cid): flats[c.cid]
                                   for c in self.clients}
        else:
            snap["client_params"] = {str(c.cid): c.params
                                     for c in self.clients}
        return snap

    @staticmethod
    def _opt_leaves(opt: Dict) -> Dict:
        """The server optimizer state as the snapshot stores it: the step
        count an int32 scalar, the reference's dtype."""
        if "step" not in opt:
            return opt
        return {**opt, "step": np.int32(opt["step"])}

    def save_snapshot(self, ckpt_dir: str, keep: int = 3) -> int:
        """Snapshot the semi-async engine at a ``run()`` boundary (the
        channel is then empty and the streaming bank sealed) as step
        ``t_global``: the tensors through
        :func:`repro_torch.checkpoint.io.save_checkpoint`, the host state
        into the ``engine_{step}.json`` sidecar.  The sidecar is written
        first and the checkpoint's own ``.json`` last (the commit record
        ``latest_step`` reads), so a kill between the two leaves no
        resumable-looking step.  The sidecar carries the reference's keys:
        clocks, bytes, counters, the q4 upload counters, the residuals'
        owners, client versions, ``Scheduler.state()`` (with the fault
        plan's and timing stream's counters) and the metric records;
        ``dev_stale_hist`` is the batched engine's ``staleness_bins`` and
        ``dev_participation`` its admitted uploads per client (the
        scheduler's participation; zeros on the sequential engine, as the
        reference's), and nothing else: each package resumes the other's
        snapshot (``wave_size_hist`` restarts at a resume, as the
        reference's).  A resumed run replays the uninterrupted one bit
        for bit."""
        if self.cfg.mode != "semi_async":
            raise ValueError("snapshots cover the semi-async engines")
        step = int(self.t_global)
        state = {
            "t_global": step,
            "batched": bool(self.cfg.batch_clients),
            "last_agg_time": float(self._last_agg_time),
            "tx_bytes": int(self.tx_bytes),
            "rx_bytes": int(self.rx_bytes),
            "idle_time": float(self.idle_time),
            "last_update_norm": float(self._last_update_norm),
            "staleness_hist": {str(k): int(v)
                               for k, v in self.staleness_hist.items()},
            "sr_counter": {str(k): int(v)
                           for k, v in self._sr_counter.items()},
            "residual_cids": sorted(self._residuals),
            "client_versions": [int(c.version) for c in self.clients],
            "screened_uploads": int(self.screened_uploads),
            "clipped_uploads": int(self.clipped_uploads),
            "corrupted_uploads": int(self.corrupted_uploads),
            "byzantine_uploads": int(self.byzantine_uploads),
            "dev_stale_hist": self._staleness_bins.tolist(),
            "dev_participation": (
                self.sched.participation.tolist() if self.cfg.batch_clients
                else [0] * len(self.clients)),
            "sched": self.sched.state(),
            "metrics": [dataclasses.asdict(rec)
                        for rec in self.metrics.records],
        }
        ckptio.save_state_json(ckpt_dir, step, state)
        ckptio.save_checkpoint(ckpt_dir, step, self._snapshot_tree(),
                               keep=keep)
        return step

    def load_snapshot(self, ckpt_dir: str,
                      step: Optional[int] = None) -> int:
        """Restore a :meth:`save_snapshot` state into this freshly built,
        identically configured engine (the latest step by default).  The
        tensor template is the engine's own structures plus the sidecar's
        residual owners, so every leaf's shape and dtype is checked; each
        leaf lands on the engine's device.  A snapshot of the other
        engine (batched or sequential) is refused; the reference's
        snapshot of the same engine loads as the port's own."""
        if step is None:
            step = ckptio.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no snapshots in {ckpt_dir}")
        state = ckptio.load_state_json(ckpt_dir, step)
        if state["batched"] != bool(self.cfg.batch_clients):
            raise ValueError("snapshot was taken on the other engine path")
        tpl: Dict = {
            "flat_params": self._flat_params,
            "opt": self._opt_leaves(self._opt),
            "global_state": self.global_state,
            "residuals": {str(cid): self.codec.zero_residual(self.device)
                          for cid in state["residual_cids"]},
            "client_state": {str(c.cid): c.model_state
                             for c in self.clients},
        }
        if state["batched"]:
            tpl["client_rows"] = {str(c.cid): self._flat_params
                                  for c in self.clients}
        else:
            tpl["client_params"] = {str(c.cid): c.params
                                    for c in self.clients}
        snap, _ = ckptio.load_checkpoint(ckpt_dir, tpl, step=step)
        self._flat_params = snap["flat_params"]
        self._opt = dict(snap["opt"])
        if "step" in self._opt:
            self._opt["step"] = int(self._opt["step"])
        self.global_state = snap["global_state"]
        self.global_params = self.codec.unravel(self._flat_params)
        self._residuals = {int(k): v for k, v in snap["residuals"].items()}
        for c in self.clients:
            c.model_state = snap["client_state"][str(c.cid)]
            c.version = int(state["client_versions"][c.cid])
        if state["batched"]:
            self._client_flats = [snap["client_rows"][str(c.cid)]
                                  for c in self.clients]
        else:
            for c in self.clients:
                c.params = snap["client_params"][str(c.cid)]
        self.t_global = int(state["t_global"])
        self._last_agg_time = float(state["last_agg_time"])
        self.tx_bytes = int(state["tx_bytes"])
        self.rx_bytes = int(state["rx_bytes"])
        self.idle_time = float(state["idle_time"])
        self._last_update_norm = float(state["last_update_norm"])
        self.staleness_hist = {int(k): int(v)
                               for k, v in state["staleness_hist"].items()}
        self._sr_counter = {int(k): int(v)
                            for k, v in state["sr_counter"].items()}
        self.screened_uploads = int(state["screened_uploads"])
        self.clipped_uploads = int(state["clipped_uploads"])
        self.corrupted_uploads = int(state["corrupted_uploads"])
        self.byzantine_uploads = int(state["byzantine_uploads"])
        self._staleness_bins = np.asarray(state["dev_stale_hist"], np.int64)
        self.sched.load_state(state["sched"])
        self.metrics.records = [RoundRecord(**rec)
                                for rec in state["metrics"]]
        return step

    # ----- the batched engine's parts -----
    def _wave_program(self, sync: bool = False):
        """The wave training call of this engine's target and lane
        execution (``wave_impl``, resolved once per engine): the
        heterogeneous wave, or with ``sync`` the SFL round's."""
        cfg = self.cfg
        target = "params" if cfg.aggregation in _MODEL_TARGETS else "grad"
        if self.wave_impl_resolved is None:
            self.wave_impl_resolved = resolve_wave_impl(
                cfg.wave_impl, self.apply_fn, self.global_params,
                self.global_state, self.test_x[:1])
        make = make_batched_local_train if sync else \
            make_batched_hetero_train
        return make(self.apply_fn, self.kind, target, cfg.local_epochs,
                    self.codec, self.wave_impl_resolved)

    def _bank(self, device=None) -> Dict:
        """The (n_clients, n_batches, B, ...) shard bank on ``device``
        (the engine's by default) and its host validity bools, made once
        per engine and device."""
        dev = self.device if device is None else device
        if dev not in self._shard_banks:
            bank = {f: torch.stack([s[f] for s in self.shards]).to(dev)
                    for f in ("xs", "ys", "mask")}
            bank["valid"] = np.stack([s["valid"] for s in self.shards])
            self._shard_banks[dev] = bank
        return self._shard_banks[dev]

    def _train_wave(self, wave_fn, starts: torch.Tensor, states,
                    cids: List[int], slots: Sequence[int]):
        """Client training of one wave from its (K, D) start rows and
        K-stacked start states, or of the sync round from the global (D,)
        row and state: the wave call's outputs.  Each lane trains on the
        device of the shard that owns its upload slot's row (one call
        when they share one, as every shard on one card does); lanes on
        other devices run there as a wave of their own, and their outputs
        come back to the engine's device in lane order."""
        lr = self.cfg.client_lr
        groups = (None if self._mesh is None else shflat.lane_groups(
            self._mesh, [self._row_shard(s) for s in slots]))
        if groups is None or (len(groups) == 1
                              and groups[0][0] == self.device):
            return wave_fn(starts, states, self._bank(), cids, lr)
        outs = []
        for on, lanes in groups:
            sub = [cids[i] for i in lanes]
            if starts.dim() == 1:  # the sync round: one broadcast row
                outs.append(wave_fn(
                    starts.to(on), tree.tree_map(lambda v: v.to(on), states),
                    self._bank(on), sub, lr))
                continue
            idx = torch.as_tensor(lanes, device=starts.device)
            outs.append(wave_fn(
                starts.index_select(0, idx).to(on),
                tree.tree_map(lambda v: v.index_select(0, idx).to(on),
                              states), self._bank(on), sub, lr))
        order = [i for _, lanes in groups for i in lanes]
        inv = torch.as_tensor(np.argsort(order), device=self.device)

        def gather(*parts):
            # each device's lanes come back to the engine's device
            return torch.cat([p.to(self.device) for p in parts])[inv]

        return tuple(tree.tree_map(gather, *out) for out in zip(*outs))

    def _payload_rows(self, vecs: torch.Tensor, cids: List[int]) -> tuple:
        """A wave's (K, D) upload rows serialized on the wire by the
        codec's row forms, each row bitwise its sequential upload:
        ``(vecs,)`` f32, ``(q, scales)`` q8 / q4, ``(idx, qv, scales)``
        top-k.  Gradient targets thread the clients' error-feedback
        residuals; q4 lanes draw with their clients' next upload
        counters."""
        cfg, codec = self.cfg, self.codec
        if not self._lossy:
            return (vecs,)
        model = cfg.aggregation in _MODEL_TARGETS
        use_ef = cfg.error_feedback and not model
        res = (torch.stack([self._residual(cid) for cid in cids])
               if use_ef else None)
        if self._wire == "q4":
            ctrs = [self._next_counter(cid) for cid in cids]
            out = (codec.quantize_rows_q4(vecs, res, cfg.seed, cids, ctrs)
                   if use_ef else
                   codec.quantize_rows_q4_nores(vecs, cfg.seed, cids, ctrs))
        elif self._wire == "topk":
            out = (codec.quantize_rows_topk(vecs, res) if use_ef
                   else codec.quantize_rows_topk_nores(vecs))
        else:
            out = (codec.quantize_rows(vecs, res) if use_ef
                   else codec.quantize_rows_nores(vecs))
        if use_ef:
            *out, new_res = out
            for row, cid in enumerate(cids):
                self._residuals[cid] = new_res[row]
        return tuple(out)

    def _ingest_wave(self, h: Dict, members: List, prows: tuple) -> None:
        """Serialize one wave's payload rows into the server channel:
        faults, then the defense screen (one launch and one host fetch for
        the wave), then the streaming channel's folds in slot order
        (``h["pend"]`` holds rows that arrive ahead of their turn: waves
        surface slots out of order, and the sequential engine folds in
        arrival order) or the buffered channel's scatter into the wave's
        slots."""
        prows = self._apply_payload_faults(
            prows, [h["faults"][slot] for slot, _ in members])
        hfac = h["fac"]
        if hfac is not None:
            fac = self._screen_factors(prows)
            for row, (slot, _) in enumerate(members):
                hfac[slot] = fac[row]
            if not self._streaming and bool((fac == 0.0).any()):
                prows = self._zero_screened_rows(prows,
                                                 fac == np.float32(0.0))
        if not self._streaming:
            self._rows.write_rows(*prows, [slot for slot, _ in members])
            return
        for row, (slot, _) in enumerate(members):
            h["pend"][slot] = tuple(a[row] for a in prows)
        while h["next"] in h["pend"]:
            i = h["next"]
            payload = h["pend"].pop(i)
            h["next"] += 1
            w = h["w"][i]
            shard = self._fold_shard(i)
            if hfac is not None:
                if hfac[i] == np.float32(0.0):
                    # screened: the fold is skipped outright (0 x NaN is
                    # NaN); skip() records the arrival at weight 0.0
                    self._accum.skip(shard=shard)
                    continue
                w = np.float32(w * hfac[i])
            beta = (np.float32(1.0) - w
                    if self.cfg.aggregation == "fedasync" else 1.0)
            self._accum.fold(payload, w=w, beta=beta, shard=shard)

    def _eval_round(self, eval_fn, ring: DeviceMetricsRing,
                    m: Dict) -> tuple:
        """Eval of the flat global row into the device ring (no host
        fetch) -> the (acc, loss) device scalars."""
        acc, loss = eval_fn(self._flat_params, self.global_state,
                            self.test_x, self.test_y)
        ring.append(acc, loss, m["update_norm"],
                    np.float32(self.screened_uploads),
                    np.float32(self.clipped_uploads))
        return acc, loss

    # ----- SFL -----
    def _run_sync(self, n_rounds: int, log_every: int) -> None:
        cfg = self.cfg
        batched = cfg.batch_clients
        round_fn = self._wave_program(sync=True) if batched else None
        now = 0.0
        for _ in range(n_rounds):
            active = self.rng.choice(len(self.clients), cfg.k,
                                     replace=False)
            buffer: List[Dict] = []
            durations = []
            states_k = None
            if batched:
                # the K clients as one round from the global row, their
                # rows serialized at once into the buffer
                cids = [int(cid) for cid in active]
                vecs, states_k, _ = self._train_wave(
                    round_fn, self._flat_params, self.global_state, cids,
                    range(len(cids)))
                if cfg.aggregation in _MODEL_TARGETS:
                    # the server sees the q8-shipped state's roundtrip
                    states_k = self._state_q8_rows(states_k)
                self._rows.set_rows(*self._payload_rows(vecs, cids))
                for cid in cids:
                    c = self.clients[cid]
                    c.params, c.model_state = (self.global_params,
                                               self.global_state)
                    c.version = self.t_global
                    self.tx_bytes += self._upload_nbytes()
                    buffer.append({"staleness": 0, "cid": cid,
                                   "n": c.n_samples})
                    durations.append(self.sched.timing.sync_duration(c))
                    self.sched.participation[cid] += 1
            else:
                for cid in active:
                    c = self.clients[cid]
                    c.params, c.model_state = (self.global_params,
                                               self.global_state)
                    c.version = self.t_global
                    w_end, s_end, _ = self._run_local(c)
                    self._enqueue_upload(buffer, c, w_end, s_end, 0)
                    durations.append(self.sched.timing.sync_duration(c))
                    self.sched.participation[cid] += 1
            round_t = max(durations) + self._agg_overhead()
            self.idle_time += sum(round_t - d for d in durations)
            t_open = now
            now += round_t
            self._aggregate(buffer, states_stacked=states_k)
            if self.tracer is not None:
                # every active client trains from t_open; a sync duration
                # is its compute plus its comm
                nb = self._upload_nbytes()
                for slot, cid in enumerate(active):
                    d = durations[slot]
                    comm = min(self.clients[cid].comm_time, d)
                    self.tracer.upload(
                        slot=slot, cid=int(cid), t=t_open + d,
                        compute_s=d - comm, comm_s=comm, staleness=0,
                        nbytes=nb, wire=self._wire, fac=None)
                self._trace_round([0] * len(buffer),
                                  [b["n"] for b in buffer], None,
                                  t_open, now - self._agg_overhead())
            if self._eval_due(self.t_global, n_rounds):
                self._eval_and_record(now, [0] * len(buffer))
                if log_every and self.t_global % log_every == 0:
                    r = self.metrics.records[-1]
                    print(f"  [SFL-{cfg.aggregation}] round {r.round} "
                          f"acc={r.accuracy:.4f} loss={r.loss:.4f}")

    # ----- SAFL: sequential per-upload path -----
    def _run_semi_async(self, n_rounds: int, log_every: int) -> None:
        """Per-upload loop over the scheduler's event stream (every pop
        schedules the client's successor event and carries a verdict: a
        rejected or crashed upload discards the client's local progress
        and resyncs it, an idled one leaves its chain untouched)."""
        self.sched.resume()
        buffer: List[Dict] = []
        now = 0.0
        while self.t_global < n_rounds:
            ev = self.sched.pop(self.t_global)
            if ev is None:
                break
            now, c = ev.time, self.clients[ev.cid]
            if not ev.admitted:
                # reject (selective training) and crash (the rebooted
                # client) discard the local progress and resync; idle is
                # back-pressure only
                if ev.verdict != "idle":
                    c.params, c.model_state = (self.global_params,
                                               self.global_state)
                    c.version = self.t_global
            else:
                w_end, s_end, _ = self._run_local(c)
                self._enqueue_upload(buffer, c, w_end, s_end, ev.staleness,
                                     fault=ev.fault)
                if self.tracer is not None:
                    self.tracer.upload(
                        slot=len(buffer) - 1, cid=c.cid, t=ev.time,
                        compute_s=ev.compute_s, comm_s=c.comm_time,
                        staleness=ev.staleness,
                        nbytes=self._upload_nbytes(), wire=self._wire,
                        fac=buffer[-1].get("fac"))
                # client-side refresh (paper §2.2.2): adopt the newest
                # global model if one arrived since this client's
                # version, else continue local
                if c.version < self.t_global:
                    c.params, c.model_state = (self.global_params,
                                               self.global_state)
                    c.version = self.t_global
                else:
                    c.params, c.model_state = w_end, s_end

            # the horizon is checked on every popped event's clock,
            # admitted or not: under rate control the deadline of a
            # timeout horizon is typically crossed by an idled upload (a
            # no-op for the count horizons: the buffer did not grow)
            if self._horizon_due(len(buffer), now):
                stale_vals = [b["staleness"] for b in buffer]
                t_open = self._last_agg_time
                self._aggregate(buffer)
                self._last_agg_time = now
                if self.tracer is not None:
                    self._trace_round(
                        stale_vals, [b["n"] for b in buffer],
                        ([b["fac"] for b in buffer]
                         if self._defense != "none" else None), t_open, now)
                if self._eval_due(self.t_global, n_rounds):
                    self._eval_and_record(now + self._agg_overhead(),
                                          stale_vals)
                    if log_every and self.t_global % log_every == 0:
                        r = self.metrics.records[-1]
                        print(f"  [SAFL-{self.cfg.aggregation}] "
                              f"round {r.round} acc={r.accuracy:.4f} "
                              f"loss={r.loss:.4f} "
                              f"stale={r.mean_staleness:.2f}")
                buffer = []

    # ----- SAFL: horizon-batched path -----
    def _run_semi_async_batched(self, n_rounds: int, log_every: int) -> None:
        """Pop the scheduler to each aggregation horizon (its admitted
        uploads; refused ones act on the clients' chains at once), train
        the horizon's uploads as one wave call per wave (a
        client's j-th event of the horizon is wave j), serialize each
        wave into the channel, then the server round; eval every
        ``eval_every`` rounds into the device ring, flushed at the end."""
        cfg = self.cfg
        wave_fn = self._wave_program()
        eval_fn = make_flat_eval_fn(self.apply_fn, self.kind, self.codec)
        if self._client_flats is None:
            self._client_flats = [self._flat_params] * len(self.clients)
        flats = self._client_flats
        # acc, loss, update_norm, cumulative screened and clipped counts
        ring = DeviceMetricsRing(n_rounds + 1, channels=5,
                                 device=self.device)
        pending: List[Dict] = []  # the host fields of each recorded round
        self.sched.resume()
        while self.t_global < n_rounds:
            r = self.t_global
            # ---- pop to the horizon; the scheduler pushes each client's
            # successor at pop time from schedule data only, so the heap
            # evolves as on the sequential path.  A reject or crash
            # before the client's first admitted event of the horizon
            # resyncs it at once; one after it cannot (its earlier
            # training still runs): the client's next lane restarts from
            # the round-r global row (force_global), and a reset after its
            # last lane leaves it on the global row when the horizon
            # closes (resync_after), where the sequential engine puts it;
            # an idle changes nothing ----
            events: List[tuple] = []  # (time, cid) per admitted slot
            evcomp: List[float] = []  # their compute seconds (the tracer)
            stal: List[int] = []
            faults: List = []
            n_adm: Dict[int, int] = {}
            force_global: set = set()
            resync_after: set = set()
            # the horizon clock advances on every popped event, admitted
            # or not, as on the sequential engine
            t_pop = 0.0
            while not (events and self._horizon_due(len(events), t_pop)):
                ev = self.sched.pop(r)
                if ev is None:
                    break
                t_pop = ev.time
                if not ev.admitted:
                    if ev.verdict == "idle":
                        # back-pressure: the client's wave chain and
                        # version stay; only the horizon clock moved
                        continue
                    # reject and crash resync the client
                    k_adm = n_adm.get(ev.cid, 0)
                    if k_adm == 0:
                        flats[ev.cid] = self._flat_params
                        c = self.clients[ev.cid]
                        c.model_state = self.global_state
                        c.version = r
                    else:
                        force_global.add((ev.cid, k_adm))
                        resync_after.add(ev.cid)
                    continue
                n_adm[ev.cid] = n_adm.get(ev.cid, 0) + 1
                resync_after.discard(ev.cid)
                stal.append(ev.staleness)
                faults.append(ev.fault)
                events.append((ev.time, ev.cid))
                evcomp.append(ev.compute_s)
            if not events:
                break
            now = t_pop
            kh = len(events)
            sizes = [self.clients[cid].n_samples for _, cid in events]
            # the horizon's channel state: slot-ordered ingest weights
            # (the sequential engine's per-upload values: numpy's scalar
            # and vector kernels agree bitwise), the defense factors by
            # slot, the rows held for their turn to fold
            h = {"w": self._weight_vector(stal, sizes), "faults": faults,
                 "fac": {} if self._defense != "none" else None,
                 "pend": {}, "next": 0}

            waves: List[List[tuple]] = []  # per wave: (slot, cid)
            n_events: Dict[int, int] = {}
            for slot, (_, cid) in enumerate(events):
                w = n_events.get(cid, 0)
                n_events[cid] = w + 1
                if w == len(waves):
                    waves.append([])
                waves[w].append((slot, cid))

            g_flat, g_state = self._flat_params, self.global_state
            nbytes = self._upload_nbytes()
            prev_new_flat = prev_states = None
            # a client with further events this horizon: None = it adopted
            # the round-r global row, int = its row in the previous wave's
            # outputs (it continues its local chain)
            carry: Dict[int, Optional[int]] = {}
            # the horizon's state close: the uploads' server-side states
            # and sizes in wave order (fedavg's mean), or the state of the
            # upload in the last slot (every other mode)
            state_parts: List = []
            size_parts: List[int] = []
            last_slot_state = None
            for w, members in enumerate(waves):
                kw = len(members)
                self.wave_size_hist[kw] = self.wave_size_hist.get(kw, 0) + 1
                cids = [cid for _, cid in members]
                if w == 0:
                    starts = torch.stack([flats[cid] for cid in cids])
                    states = tree.tree_stack(
                        [self.clients[cid].model_state for cid in cids])
                else:
                    rows = [None if (cid, w) in force_global
                            else carry.get(cid) for cid in cids]
                    if all(rv is None for rv in rows):
                        starts = g_flat.expand(kw, self.codec.d)
                        states = tree.tree_map(
                            lambda leaf: leaf.expand(
                                (kw,) + tuple(leaf.shape)), g_state)
                    elif all(rv is not None for rv in rows):
                        ridx = torch.as_tensor(rows, device=self.device)
                        starts = prev_new_flat[ridx]
                        states = tree.tree_map(lambda leaf: leaf[ridx],
                                               prev_states)
                    else:
                        starts = torch.stack(
                            [g_flat if rv is None else prev_new_flat[rv]
                             for rv in rows])
                        states = tree.tree_stack([
                            g_state if rv is None else tree.tree_map(
                                lambda leaf, rv=rv: leaf[rv], prev_states)
                            for rv in rows])
                vecs, new_flat, new_states, _ = self._train_wave(
                    wave_fn, starts, states, cids,
                    [slot for slot, _ in members])
                self._ingest_wave(h, members, self._payload_rows(vecs, cids))
                # the server's view of the uploaded states (the q8
                # roundtrip for a model target on a lossy wire)
                up_states = (self._state_q8_rows(new_states)
                             if cfg.aggregation in _MODEL_TARGETS
                             else new_states)
                state_parts.append(up_states)
                for row, (slot, cid) in enumerate(members):
                    c = self.clients[cid]
                    self.tx_bytes += nbytes
                    size_parts.append(c.n_samples)
                    if slot == kh - 1:
                        last_slot_state = tree.tree_map(
                            lambda leaf, row=row: leaf[row], up_states)
                    # refresh rule (paper §2.2.2): adopt the round-r
                    # global row iff one arrived since the client's
                    # version, else continue from its final local row
                    adopt = c.version < r
                    c.version = r
                    if n_events[cid] > w + 1:
                        carry[cid] = None if adopt else row
                    elif adopt:
                        flats[cid] = g_flat
                        c.model_state = g_state
                    else:
                        flats[cid] = new_flat[row]
                        c.model_state = tree.tree_map(
                            lambda leaf, row=row: leaf[row], new_states)
                prev_new_flat, prev_states = new_flat, new_states
            for cid in resync_after:
                flats[cid] = g_flat
                c = self.clients[cid]
                c.model_state = g_state
                c.version = r

            if self._streaming and h["next"] != kh:
                raise RuntimeError(f"{h['next']} of {kh} uploads folded")
            facs = (None if h["fac"] is None
                    else [h["fac"][i] for i in range(kh)])
            m = self._aggregate([
                {"staleness": stal[i], "n": sizes[i],
                 "fac": None if facs is None else facs[i]}
                for i in range(kh)])
            t_open = self._last_agg_time
            self._last_agg_time = now
            if self.tracer is not None:
                # the sequential engine's per-slot values; the tracer's
                # sorted flush makes the order of the records irrelevant
                for slot, (t_ev, cid) in enumerate(events):
                    self.tracer.upload(
                        slot=slot, cid=cid, t=t_ev, compute_s=evcomp[slot],
                        comm_s=self.clients[cid].comm_time,
                        staleness=stal[slot], nbytes=nbytes,
                        wire=self._wire,
                        fac=None if facs is None else facs[slot])
                self._trace_round(stal, sizes, facs, t_open, now)
            if cfg.aggregation == "fedavg":
                stacked = tree.tree_map(lambda *ls: torch.cat(ls),
                                        *state_parts)
                if not tree.is_empty(stacked):
                    self.global_state = weighted_mean(stacked, size_parts)
            else:
                self.global_state = last_slot_state
            self._staleness_bins += np.bincount(
                np.minimum(stal, _STALE_BINS - 1), minlength=_STALE_BINS)
            rnd = self.t_global
            if self._eval_due(rnd, n_rounds):
                acc, loss = self._eval_round(eval_fn, ring, m)
                pending.append(dict(
                    round=rnd, sim_time=now + self._agg_overhead(),
                    tx_bytes=self.tx_bytes, rx_bytes=self.rx_bytes,
                    mean_staleness=float(np.mean(stal)),
                    max_staleness=int(max(stal))))
                if log_every and rnd % log_every == 0:
                    # opt-in logging is the one place a fetch is allowed
                    print(f"  [SAFL-{cfg.aggregation}] round {rnd} "
                          f"acc={float(acc):.4f} loss={float(loss):.4f} "
                          f"stale={np.mean(stal):.2f}")

        # ---- the run's one device-to-host copy of the metrics ----
        for fields, (acc, loss, unorm, nscr, nclip) in zip(pending,
                                                           ring.flush()):
            self.metrics.record(
                accuracy=float(acc), loss=float(loss),
                nan_event=not np.isfinite(loss), update_norm=float(unorm),
                screened_uploads=int(nscr), clipped_uploads=int(nclip),
                **fields)
