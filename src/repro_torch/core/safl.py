"""SFL / SAFL engine (paper §2.2, Fig. 1): discrete-event simulation.

Only *simulated* wall-clock (per-client compute speeds + communication
latency) is event-driven; simulated time orders the events and defers no
computation.

Synchronous (SFL, Fig. 1a): each round the server activates K random
clients, waits for all of them (round time = slowest active client, the
straggler effect), aggregates, broadcasts.  The K clients train one after
another into the (K, D) buffer (int8 (K, Dq) rows on the q8 wire, packed
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

This is the reference's sequential per-upload engine (its parity oracle),
with its host arithmetic copied exactly: np.float32 weight vectors, the
simulated-time model, the byte envelopes, the ``rng.choice`` of the sync
round, and the q4 wire's per-client upload counters, which key its
stochastic-rounding draws.  So bytes, staleness and participation match
the reference bit for bit.  Parameters live on ``device`` (CUDA unless the caller asks for the
CPU); the global model is a flat (D,) row in the reference's layout.

Ported: the settings in :data:`FLEngine.PORTED`.  Anything else raises
``NotImplementedError`` rather than running something else.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import faults as faultsmod
from repro_torch import sched as schedmod
from repro_torch.core import flatbuf
from repro_torch.core.aggregation import FlatServer
from repro_torch.core.client import (ClientState, evaluate, local_epoch,
                                     make_loss_fn, pytree_bytes)
from repro_torch.core.metrics import MetricsLog
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import payload_nbytes

# width of the reference's device-resident staleness histogram (filled
# only by its horizon-batched path; zeros here, as on its sequential path)
_STALE_BINS = 32

# simulated samples/second at speed 1.0
_BASE_RATE = 500.0
# serialization envelope: full-model upload (FedAvg) carries the layer
# structure; gradient upload (FedSGD) is a bare tensor list (paper §5.1.2)
_MODEL_ENVELOPE = 0.010
_GRAD_ENVELOPE = 0.002

# aggregation targets that upload model weights (vs cumulative gradients)
_MODEL_TARGETS = ("fedavg", "fedasync")


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
        "horizon": ("k",),
        "sched_timing": ("static",),
        "sched_policy": ("full",),
        "batch_clients": (False,),
        "devices": (1,),
        "mesh_shape": (None,),
        "trace_level": ("off",),
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
        if init_state:
            raise NotImplementedError(
                "non-trainable model state (BatchNorm) is not ported yet")
        self.device = dev = resolve_device(device)
        self.cfg = fl_cfg
        self.kind = kind
        self.apply_fn = apply_fn
        self.loss_fn = make_loss_fn(apply_fn, kind)
        self.test_x = torch.as_tensor(np.asarray(test_x, np.float32),
                                      device=dev)
        self.test_y = torch.as_tensor(np.asarray(test_y, np.int64),
                                      device=dev)
        init_params = {k: v.to(dev) for k, v in init_params.items()}

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
            "xs": torch.as_tensor(np.asarray(s["xs"], np.float32),
                                  device=dev),
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
            qblock=fl_cfg.quant_block, device=dev)
        self._opt = self._server.init_opt(self._flat_params)
        # server channel: "auto" is streaming for semi-async (uploads
        # trickle in) and buffered for sync (a round's rows come together)
        self._channel = fl_cfg.server_channel
        if self._channel == "auto":
            self._channel = ("streaming" if fl_cfg.mode == "semi_async"
                             else "buffered")
        self._streaming = self._channel == "streaming"
        self._horizon_target = fl_cfg.k
        # defense layer (none | screen | clip) and the fault / defense
        # counts of the run
        self._defense = fl_cfg.defense
        self.screened_uploads = 0
        self.clipped_uploads = 0
        self.corrupted_uploads = 0
        self.byzantine_uploads = 0
        self._accum = None
        self._buf = None
        self._qbuf = None
        if self._streaming:
            self._accum = flatbuf.AccumBuffer(
                self._server.bank_width, self._server.fold_program, dev)
        elif self._wire == "topk":
            self._qbuf = flatbuf.TopkBuffer(self._horizon_target,
                                            self.codec.d, self.codec.nk,
                                            fl_cfg.quant_block, device=dev)
        elif self._lossy:
            self._qbuf = flatbuf.QuantBuffer(self._horizon_target,
                                             self.codec.d,
                                             fl_cfg.quant_block, device=dev,
                                             packed=self._wire == "q4")
        else:
            self._buf = flatbuf.alloc_buffer(self._horizon_target,
                                             self.codec.d, dev)

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

    def _horizon_due(self, count: int) -> bool:
        """The ``k`` horizon: close after exactly K admitted uploads
        (clock-triggered horizons are not ported yet)."""
        return count >= self._horizon_target

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
        weights carry the state and the layer structure)."""
        if self._lossy:
            payload = payload_nbytes(self._wire, d=self.codec.d,
                                     dq=self.codec.dq,
                                     n_qblocks=self.codec.n_qblocks,
                                     nk=self.codec.nk,
                                     nk_qblocks=self.codec.nk_qblocks)
        else:
            payload = self._params_bytes
        if self.cfg.aggregation in _MODEL_TARGETS:
            return int((payload + self._state_bytes)
                       * (1 + _MODEL_ENVELOPE))
        return int(payload * (1 + _GRAD_ENVELOPE))

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

    def _apply_payload_fault(self, payload: tuple, fault) -> tuple:
        """A corrupt / byzantine draw applied to one upload's payload,
        lifted to the appliers' K = 1 stack and back.  Untouched lanes
        come back bitwise; a top-k upload's indices are never touched."""
        corrupt = [fault.kind == "corrupt"]
        byz = [fault.kind == "byzantine"]
        self.corrupted_uploads += corrupt[0]
        self.byzantine_uploads += byz[0]
        rows = tuple(a[None] for a in payload)
        resc = self.cfg.fault_byzantine_rescale
        if self._wire == "topk":
            rows = rows[:1] + faultsmod.apply_faults_q(
                *rows[1:], corrupt, byz, [fault.loc], resc)
        elif self._lossy:
            rows = faultsmod.apply_faults_q(*rows, corrupt, byz, [fault.loc],
                                            resc)
        else:
            rows = (faultsmod.apply_faults_flat(rows[0], corrupt, byz,
                                                [fault.loc], resc),)
        return tuple(a[0] for a in rows)

    def _screen_factor(self, payload: tuple) -> np.float32:
        """The defense's weight factor of one upload: the server's sum of
        squares over the payload screened as a K = 1 stack (one host
        fetch), then the host's screen / clip composition."""
        sumsq = self._server.screen(tuple(a[None] for a in payload))
        fac, ns, ncl = faultsmod.defense_factors(
            sumsq.cpu().numpy(), self._defense, self.cfg.defense_norm_cap)
        self.screened_uploads += ns
        self.clipped_uploads += ncl
        return fac[0]

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
            payload = self._apply_payload_fault(payload, fault)
        fac = None
        if self._defense != "none":
            fac = entry["fac"] = self._screen_factor(payload)
        dropped = fac is not None and fac == np.float32(0.0)
        if self._streaming:
            if dropped:
                self._accum.skip()
            else:
                w = self._weight_vector([staleness], [c.n_samples])[0]
                if fac is not None:
                    w = np.float32(w * fac)
                beta = (np.float32(1.0) - w
                        if cfg.aggregation == "fedasync" else 1.0)
                self._accum.fold(payload, w=w, beta=beta)
        else:
            if dropped:
                payload = payload[:-1] + (torch.zeros_like(payload[-1]),)
            if self._lossy:
                self._qbuf.write(*payload, len(buffer))
            else:
                flatbuf.write_slot(self._buf, payload[0], len(buffer))
        entry["state"] = s_end
        self.tx_bytes += self._upload_nbytes()
        buffer.append(entry)

    # ------------------------------------------------------------------
    def _weight_vector(self, staleness: Sequence[int],
                       sizes: Sequence[int]) -> np.ndarray:
        """FINAL per-upload aggregation weights, np.float32 on host
        (discount-at-ingest): fedavg data sizes, fedsgd units, the
        (1+tau)^-alpha discount of fedbuff / fedopt / sdga, fedasync's raw
        mix rates a_i = fedasync_alpha * (1+tau)^-alpha.  The streaming
        channel folds weight i when upload i lands, the buffered one
        applies the whole vector in its reduction (numpy's scalar and
        vector kernels agree bitwise)."""
        cfg = self.cfg
        stal = np.asarray(staleness, np.float32)
        if cfg.aggregation == "fedasync":
            a = cfg.fedasync_alpha * np.power(
                stal + 1.0, -np.float32(cfg.staleness_alpha))
            return np.asarray(a, np.float32)
        if cfg.aggregation == "fedavg":
            return np.asarray(sizes, np.float32)
        if cfg.aggregation == "fedsgd":
            return np.ones((len(staleness),), np.float32)
        # fedbuff / fedopt / sdga: the poly discount
        return np.asarray(
            np.power(stal + 1.0, -np.float32(cfg.staleness_alpha)),
            np.float32)

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
        buf = self._qbuf.views if self._lossy else self._buf
        self._flat_params, self._opt, m = self._server.step(
            self._flat_params, buf, w, self._opt)
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

    def _aggregate(self, buffer: List[Dict]) -> Dict:
        """Server round + unravel of the global model (views into the new
        flat row).  The paper CNN has no non-trainable state to merge."""
        stal = [b["staleness"] for b in buffer]
        if self._streaming:
            m = self._server_round_streaming(stal)
        else:
            facs = ([b["fac"] for b in buffer]
                    if self._defense != "none" else None)
            m = self._server_round(stal, [b["n"] for b in buffer], facs)
        self.global_params = self.codec.unravel(self._flat_params)
        self._last_update_norm = m["update_norm"]
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

    # ------------------------------------------------------------------
    def run(self, n_rounds: int, log_every: int = 0) -> FLResult:
        if self.cfg.mode == "sync":
            self._run_sync(n_rounds, log_every)
        else:
            self._run_semi_async(n_rounds, log_every)
        stats = self.sched.stats()
        stats["staleness_bins"] = np.zeros(_STALE_BINS, np.int64)
        stats["screened_uploads"] = self.screened_uploads
        stats["clipped_uploads"] = self.clipped_uploads
        stats["corrupted_uploads"] = self.corrupted_uploads
        stats["byzantine_uploads"] = self.byzantine_uploads
        return FLResult(self.metrics, self.global_params,
                        self.staleness_hist, self.idle_time,
                        participation=self.sched.participation.copy(),
                        sched_stats=stats)

    # ----- SFL -----
    def _run_sync(self, n_rounds: int, log_every: int) -> None:
        cfg = self.cfg
        now = 0.0
        for _ in range(n_rounds):
            active = self.rng.choice(len(self.clients), cfg.k,
                                     replace=False)
            buffer: List[Dict] = []
            durations = []
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
            now += round_t
            self._aggregate(buffer)
            if self._eval_due(self.t_global, n_rounds):
                self._eval_and_record(now, [0] * len(buffer))
                if log_every and self.t_global % log_every == 0:
                    r = self.metrics.records[-1]
                    print(f"  [SFL-{cfg.aggregation}] round {r.round} "
                          f"acc={r.accuracy:.4f} loss={r.loss:.4f}")

    # ----- SAFL: sequential per-upload path -----
    def _run_semi_async(self, n_rounds: int, log_every: int) -> None:
        """Per-upload loop over the scheduler's event stream (every pop
        schedules the client's successor event; the full policy admits
        every upload the fault plan does not crash)."""
        self.sched.resume()
        buffer: List[Dict] = []
        now = 0.0
        while self.t_global < n_rounds:
            ev = self.sched.pop(self.t_global)
            if ev is None:
                break
            now, c = ev.time, self.clients[ev.cid]
            if not ev.admitted:
                # a crash: the upload is lost, the rebooted client
                # discards its local progress and resyncs
                c.params, c.model_state = (self.global_params,
                                           self.global_state)
                c.version = self.t_global
                continue
            w_end, s_end, _ = self._run_local(c)
            self._enqueue_upload(buffer, c, w_end, s_end, ev.staleness,
                                 fault=ev.fault)
            # client-side refresh (paper §2.2.2): adopt the newest global
            # model if one arrived since this client's version, else
            # continue local
            if c.version < self.t_global:
                c.params, c.model_state = (self.global_params,
                                           self.global_state)
                c.version = self.t_global
            else:
                c.params, c.model_state = w_end, s_end

            if self._horizon_due(len(buffer)):
                stale_vals = [b["staleness"] for b in buffer]
                self._aggregate(buffer)
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
