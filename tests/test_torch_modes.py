"""Every aggregation scheme of the study in the port (fedsgd, fedavg,
fedbuff, fedopt, sdga, fedasync), on the CPU:

  * repro_torch's FlatServer against repro's as the engine builds it
    (``backend="xla", external_discount=True, fedasync_rates=True``), on
    the f32 and q8 wires (q4 in ``test_torch_q4.py``), through both
    channels, for two rounds (so the slow state of sdga and fedopt is
    carried);
  * the port's streaming channel against its buffered one, bitwise;
  * the server's helpers and slow state against the reference's;
  * the engine in SS and AS with each new mode against the reference's
    sequential engine.

Tolerances.  Server, against the reference: ``rtol=1e-5, atol=1e-5`` in
every mode on both wires (the K-way sums run in other orders; the
reference's q8 mean folds 1/sum(w) into each row's coefficient, the port
divides the sum; the largest difference seen is 2.4e-7).  Engine, against the reference: bytes, staleness, participation and
simulated time exact; accuracy within 2 test samples; params within
``rtol=1e-5, atol=1e-6``, fedopt within ``atol=1e-5`` (float32 training
drifts a few ulp per step, and Adam's per-coordinate normalisation turns
an ulp of a mean gradient near zero into up to lr = 0.005 of step; over
4 rounds the largest difference seen is 1.8e-6).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import paper as jpaper  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import fl_sim as jfl_sim  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.flatbuf import AccumBuffer, QuantBuffer, alloc_buffer, write_slot  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from repro_torch import prng  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D, K, QB = 3001, 4, 512
DQ = -(-D // QB) * QB
MODES = ["fedsgd", "fedavg", "fedbuff", "fedopt", "sdga", "fedasync"]
SLR = {"fedsgd": 0.05, "sdga": 0.05, "fedbuff": 0.05, "fedopt": 0.005}


def _weights(mode, rng):
    """The engine's FINAL per-upload weights for mode (host np.float32)."""
    tau = rng.integers(0, 5, K).astype(np.float32)
    if mode == "fedavg":
        return rng.integers(5, 200, K).astype(np.float32)
    if mode == "fedsgd":
        return np.ones(K, np.float32)
    if mode == "fedasync":
        return np.asarray(0.6 * np.power(tau + 1.0, -np.float32(0.5)),
                          np.float32)
    return np.asarray(np.power(tau + 1.0, -np.float32(0.5)), np.float32)


def _rows(wire, rng):
    """K upload payloads: f32 rows, or the q8 (q, scales) or q4 (packed
    bytes, scales) of the same rows, quantized by the reference."""
    u = (rng.normal(size=(K, D)) * 0.1).astype(np.float32)
    if wire == "f32":
        return u, [(u[i],) for i in range(K)]
    x = np.zeros((K, DQ), np.float32)
    x[:, :D] = u
    blocks = jnp.asarray(x.reshape(-1, QB))
    if wire == "q8":
        q, s = jref.quantize_ref(blocks)
    else:
        draws = rng.uniform(size=blocks.shape).astype(np.float32)
        q, s = jax.jit(jref.quantize_q4_ref)(blocks, jnp.asarray(draws))
        q = jref.pack_q4_ref(q.reshape(K, DQ))
    q = np.asarray(q).reshape(K, -1)
    s = np.asarray(s).reshape(K, DQ // QB)
    return (q, s), [(q[i], s[i]) for i in range(K)]


def _servers(mode, wire):
    kw = dict(server_lr=SLR.get(mode, 1.0), momentum=0.8, ema_anchor=0.05)
    j = jagg.FlatServer(mode, D, backend="xla", external_discount=True,
                        fedasync_rates=True, wire=wire, qblock=QB, **kw)
    t = tagg.FlatServer(mode, D, wire=wire, qblock=QB, device="cpu", **kw)
    return j, t


def _t(x):
    return torch.from_numpy(np.array(x))


def _opt_np(opt):
    return {k: (np.asarray(v) if k != "step" else int(v))
            for k, v in opt.items()}


def _port_buffered(ts, wire, buf, p, w, opt):
    if wire != "f32":
        qb = QuantBuffer(K, D, QB, device="cpu", packed=wire == "q4")
        for i in range(K):
            qb.write(_t(buf[0][i]), _t(buf[1][i]), i)
        rows = qb.views
    else:
        rows = alloc_buffer(K, D, "cpu")
        for i in range(K):
            write_slot(rows, _t(buf[i]), i)
    return ts.step(p, rows, w, opt)


def _port_streaming(ts, mode, payloads, p, w, opt):
    acc = AccumBuffer(ts.bank_width, ts.fold_program, "cpu")
    for i, pl in enumerate(payloads):
        beta = np.float32(1.0) - w[i] if mode == "fedasync" else 1.0
        acc.fold(tuple(_t(a) for a in pl), w=w[i], beta=beta)
    bank, wvec, stats = acc.seal()
    new, opt, m, zeroed = ts.finalize(p, bank, wvec, opt,
                                      pprod=stats["pprod"])
    assert float(zeroed.abs().sum()) == 0.0
    return new, opt, m


def _ref_streaming(js, mode, payloads, p, w, opt):
    bank = jnp.zeros((1, D if js.wire == "f32" else DQ), jnp.float32)
    pprod = np.float32(1.0)
    for i, pl in enumerate(payloads):
        beta = np.float32(1.0) - w[i] if mode == "fedasync" else 1.0
        bank = js.fold_program(bank, *[jnp.asarray(a) for a in pl],
                               jnp.int32(0), jnp.float32(w[i]),
                               jnp.float32(beta))
        pprod = np.float32(pprod * np.float32(beta))
    new, opt, m, _ = js.finalize(p, bank, w, opt, pprod=pprod)
    return new, opt, m


@pytest.mark.parametrize("wire", ["f32", "q8"])
@pytest.mark.parametrize("mode", MODES)
def test_server_matches_reference_both_channels(mode, wire):
    check_server_both_channels(mode, wire)


def check_server_both_channels(mode, wire):
    """Two rounds through each channel of both servers: the port against
    the reference to tolerance, the port's two channels bitwise."""
    rng = np.random.default_rng(MODES.index(mode))
    params = rng.normal(size=(D,)).astype(np.float32)
    js, ts = _servers(mode, wire)
    jp = {"buf": jnp.asarray(params), "str": jnp.asarray(params)}
    tp = {"buf": _t(params), "str": _t(params)}
    jo = {c: js.init_opt(jp[c]) for c in jp}
    to = {c: ts.init_opt(tp[c]) for c in tp}
    for _ in range(2):
        buf, payloads = _rows(wire, rng)
        w = _weights(mode, rng)
        jbuf = jnp.asarray(buf) if wire == "f32" \
            else tuple(jnp.asarray(a) for a in buf)
        jp["buf"], jo["buf"], jmb = js.step(jp["buf"], jbuf, jnp.asarray(w),
                                            jo["buf"])
        jp["str"], jo["str"], jms = _ref_streaming(js, mode, payloads,
                                                   jp["str"], w, jo["str"])
        tp["buf"], to["buf"], tmb = _port_buffered(ts, wire, buf, tp["buf"],
                                                   w, to["buf"])
        tp["str"], to["str"], tms = _port_streaming(ts, mode, payloads,
                                                    tp["str"], w, to["str"])
        # the port's channels: bitwise, slow state included
        assert torch.equal(tp["buf"], tp["str"])
        assert to["buf"].keys() == to["str"].keys()
        for key in to["buf"]:
            if key == "step":
                assert to["buf"][key] == to["str"][key]
            else:
                assert torch.equal(to["buf"][key], to["str"][key])
        assert float(tmb["weight_sum"]) == float(tms["weight_sum"])
        assert float(tmb["update_norm"]) == float(tms["update_norm"])
        # the port against the reference, channel by channel
        for c, jm, tm in (("buf", jmb, tmb), ("str", jms, tms)):
            np.testing.assert_allclose(tp[c].numpy(), np.asarray(jp[c]),
                                       **TOL)
            np.testing.assert_allclose(float(tm["weight_sum"]),
                                       float(jm["weight_sum"]), rtol=1e-6)
            np.testing.assert_allclose(float(tm["update_norm"]),
                                       float(jm["update_norm"]), rtol=2e-3)
            jopt, topt = _opt_np(jo[c]), _opt_np(to[c])
            assert jopt.keys() == topt.keys()
            for key in jopt:
                if key == "step":
                    assert topt[key] == jopt[key]
                else:
                    np.testing.assert_allclose(topt[key], jopt[key], **TOL)
    assert tp["buf"].shape == (D,) and tp["buf"].dtype == torch.float32


@pytest.mark.parametrize("mode", MODES)
def test_slow_state_starts_the_same(mode):
    """sdga: zero momentum and an EMA that copies the params; fedopt: zero
    Adam moments and step 0; the other modes: none."""
    params = np.random.default_rng(1).normal(size=(D,)).astype(np.float32)
    js, ts = _servers(mode, "f32")
    jo = _opt_np(js.init_opt(jnp.asarray(params)))
    tp = _t(params)
    to = ts.init_opt(tp)
    assert to.keys() == jo.keys()
    for key, val in jo.items():
        if key == "step":
            assert to[key] == val == 0
        else:
            np.testing.assert_array_equal(to[key].numpy(), val)
    if mode == "sdga":
        assert to["ema"].data_ptr() != tp.data_ptr()  # a copy, not a view
        np.testing.assert_array_equal(to["ema"].numpy(), params)


def test_fedasync_rates_fold_matches_oracles():
    """The buffered fedasync round (K folds with beta = 1 - a_i) against
    the reference's (S, P) oracles on f32 and q8, and the port's plain
    copies of them bitwise."""
    rng = np.random.default_rng(3)
    params = rng.normal(size=(D,)).astype(np.float32)
    a = _weights("fedasync", rng)
    for wire in ("f32", "q8"):
        buf, _ = _rows(wire, rng)
        _, ts = _servers("fedasync", wire)
        if wire == "q8":
            want, wmass = jref.fedasync_rates_flat_q8_ref(
                jnp.asarray(buf[0]), jnp.asarray(buf[1]), jnp.asarray(a),
                jnp.asarray(params), QB)
            plain, pmass = tref.fedasync_rates_flat_q8_ref(
                _t(buf[0]), _t(buf[1]), a, _t(params), QB)
        else:
            want, wmass = jref.fedasync_rates_flat_ref(
                jnp.asarray(buf), jnp.asarray(a), jnp.asarray(params))
            plain, pmass = tref.fedasync_rates_flat_ref(_t(buf), a,
                                                        _t(params))
        new, _, m = _port_buffered(ts, wire, buf, _t(params), a, {})
        np.testing.assert_allclose(new.numpy(), np.asarray(want), **TOL)
        assert torch.equal(new, plain)
        assert float(m["weight_sum"]) == float(pmass) == float(wmass)


def test_sdga_step_and_dequant_copies_match_reference():
    rng = np.random.default_rng(4)
    g, p, m, e = (rng.normal(size=(D,)).astype(np.float32) for _ in range(4))
    kw = dict(server_lr=0.05, momentum=0.8, ema_anchor=0.05, ema_decay=0.95)
    want = jref.sdga_step_from_mean(*(jnp.asarray(x) for x in (g, p, m, e)),
                                    **kw)
    got = tref.sdga_step_from_mean(*(_t(x) for x in (g, p, m, e)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    (q, s), _ = _rows("q8", rng)
    np.testing.assert_array_equal(
        tref.dequant_flat_ref(_t(q), _t(s), QB).numpy(),
        np.asarray(jref.dequant_flat_ref(jnp.asarray(q), jnp.asarray(s),
                                         QB)))


def test_staleness_functions_and_coefficients_match_reference():
    tau = np.array([0, 1, 2, 4, 5, 9, 17], np.int32)
    np.testing.assert_allclose(
        tagg.staleness_hinge(_t(tau)).numpy(),
        np.asarray(jagg.staleness_hinge(jnp.asarray(tau))), rtol=1e-7)
    np.testing.assert_array_equal(
        tagg.staleness_const(_t(tau)).numpy(),
        np.asarray(jagg.staleness_const(jnp.asarray(tau))))
    for score in (None, np.float32([1.0, 2.0, 0.5, 3.0, 1.0, 0.1, 1.0])):
        np.testing.assert_array_equal(
            tagg.fedasync_coefficients(tau, 0.6, 0.5, score),
            np.asarray(jagg.fedasync_coefficients(tau, 0.6, 0.5, score)))


def test_fedasync_coefficients_fold_the_sequential_mix():
    """(1 - sum c) p + c @ u equals the K sequential mixes."""
    rng = np.random.default_rng(5)
    u, _ = _rows("f32", rng)
    params = rng.normal(size=(D,)).astype(np.float32)
    tau = [0, 3, 1, 2]
    c = tagg.fedasync_coefficients(tau, 0.6, 0.5)
    a = np.asarray(0.6 * np.power(np.float32(tau) + 1.0, -np.float32(0.5)),
                   np.float32)
    mixed, _ = tref.fedasync_rates_flat_ref(_t(u), a, _t(params))
    from repro_torch.kernels.safl_agg import safl_aggregate
    got = safl_aggregate(_t(u), _t(c), _t(params), mode="mix")
    np.testing.assert_allclose(got.numpy(), mixed.numpy(), **TOL)


def test_cuda_default_without_gpu_raises():
    """FlatServer and build_paper_model run on the card unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA path runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagg.FlatServer("sdga", D, server_lr=0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcnn.build_paper_model("cnn", prng.prng_key(0), width=4,
                               image_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcnn.cnn_init(prng.prng_key(0), width=4, image_size=8)


# ---------------------------------------------------------------------------
# the engine, against the reference's sequential engine
# ---------------------------------------------------------------------------

ROUNDS = 4
N_TEST = 150
KW = dict(n_clients=6, k=3, client_lr=0.05, speed_sigma=0.8,
          target_accuracy=0.3)


@pytest.fixture(scope="module")
def setup():
    ds = make_dataset("cifar10", n=300, seed=0, hw=8)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", 6, 16, seed=0,
                                 alpha=0.3)
    p_j, s_j = jcnn.cnn_init(jax.random.PRNGKey(0), width=4, image_size=8)
    return shards, te, p_j, s_j


def run_pair(setup, setting, rounds=ROUNDS, **cfg_kw):
    """The reference's sequential engine and the port's on the CPU, from
    the same data and weights, in paper setting ``setting`` with
    ``cfg_kw`` on top (server lr from the launcher's table)."""
    shards, te, p_j, s_j = setup
    agg = cfg_kw.get("aggregation", jpaper.MODES[setting].aggregation)
    kw = dict(KW, server_lr=SLR.get(agg, 1.0), **cfg_kw)
    jcfg = dataclasses.replace(jpaper.MODES[setting], batch_clients=False,
                               **kw)
    tcfg = dataclasses.replace(tpaper.MODES[setting], batch_clients=False,
                               **kw)
    x, y = te.x[:N_TEST], te.y[:N_TEST]
    jeng = JEngine(jcfg, jcnn.cnn_apply, "image", p_j, s_j, shards, x, y)
    jres = jeng.run(rounds)
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    teng = TEngine(tcfg, tcnn.cnn_apply, "image",
                   params_from_jax(p_np, "cpu"), {}, shards, x, y,
                   device="cpu")
    tres = teng.run(rounds)
    return jeng, jres, teng, tres


def assert_host_exact(jeng, jres, teng, tres, rounds=ROUNDS):
    """Bytes, staleness, participation and simulated time: exact."""
    assert teng.tx_bytes == jeng.tx_bytes
    assert teng.rx_bytes == jeng.rx_bytes
    assert tres.staleness_hist == jres.staleness_hist
    np.testing.assert_array_equal(tres.participation, jres.participation)
    assert tres.idle_time == jres.idle_time
    js, ts = dict(jres.sched_stats), dict(tres.sched_stats)
    np.testing.assert_array_equal(ts.pop("staleness_bins"),
                                  js.pop("staleness_bins"))
    assert ts == js
    assert len(tres.metrics.records) == len(jres.metrics.records) == rounds
    for rt, rj in zip(tres.metrics.records, jres.metrics.records):
        assert (rt.round, rt.sim_time, rt.mean_staleness, rt.max_staleness,
                rt.tx_bytes, rt.rx_bytes) == \
            (rj.round, rj.sim_time, rj.mean_staleness, rj.max_staleness,
             rj.tx_bytes, rj.rx_bytes)
        assert abs(rt.accuracy - rj.accuracy) * N_TEST <= 2 + 1e-6
        assert not rt.nan_event


def flat_reference(jres):
    return np.asarray(jflatbuf.PytreeCodec(jres.final_params).ravel(
        jres.final_params))


@pytest.mark.parametrize("agg", ["fedbuff", "fedasync", "fedopt", "sdga"])
@pytest.mark.parametrize("setting", ["SS", "AS"])
def test_engine_matches_reference(setup, setting, agg):
    jeng, jres, teng, tres = run_pair(setup, setting, aggregation=agg)
    assert_host_exact(jeng, jres, teng, tres)
    if setting == "AS":
        assert max(tres.staleness_hist) > 0
    tol = dict(rtol=1e-5, atol=1e-5 if agg == "fedopt" else 1e-6)
    np.testing.assert_allclose(teng._flat_params.numpy(),
                               flat_reference(jres), **tol)


@pytest.mark.parametrize("agg", ["fedasync", "sdga", "fedopt"])
def test_engine_streaming_equals_buffered_bitwise(setup, agg):
    """The port's two channels give the same AS run bit for bit."""
    shards, te, p_j, _ = setup
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    flats = []
    for channel in ("streaming", "buffered"):
        cfg = dataclasses.replace(tpaper.MODES["AS"], aggregation=agg,
                                  server_lr=SLR.get(agg, 1.0),
                                  server_channel=channel,
                                  batch_clients=False, **KW)
        eng = TEngine(cfg, tcnn.cnn_apply, "image",
                      params_from_jax(p_np, "cpu"), {}, shards,
                      te.x[:N_TEST], te.y[:N_TEST], device="cpu")
        eng.run(3)
        flats.append(eng._flat_params)
    assert torch.equal(flats[0], flats[1])


def fl_sim_pair(tmp_path, monkeypatch, capsys, args):
    """The reference's launcher and the port's (on the CPU), both
    ``--sequential``, with the same flags: their --json-out summaries."""
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["fl_sim", *args, "--sequential",
                                     "--json-out", str(jout)])
    jfl_sim.main()
    tfl_sim.main([*args, "--sequential", "--device", "cpu", "--json-out",
                  str(tout)])
    capsys.readouterr()
    return json.loads(jout.read_text()), json.loads(tout.read_text())


def assert_same_summary(j, t):
    """Same keys; bytes, schedule, traffic and simulated time equal
    (accuracy differs: the two launchers draw different initial
    weights)."""
    assert t.keys() == j.keys()
    for k in ("schema", "rounds", "tx_bytes", "rx_bytes", "tx_GB", "rx_GB",
              "duration_s", "mean_staleness", "sched", "traffic"):
        assert t[k] == j[k], k


@pytest.mark.parametrize("agg", ["fedbuff", "fedasync", "fedopt", "sdga"])
def test_fl_sim_runs_every_mode_with_reference_schema(tmp_path, monkeypatch,
                                                      capsys, agg):
    """The launcher takes each new --aggregation, with the reference's
    server lr, and its --json-out matches the reference's."""
    j, t = fl_sim_pair(tmp_path, monkeypatch, capsys,
                       ["--rounds", "2", "--samples", "240", "--clients",
                        "5", "--k", "2", "--aggregation", agg])
    assert_same_summary(j, t)
    assert tfl_sim.SERVER_LR.get(agg, 1.0) == SLR.get(agg, 1.0)
