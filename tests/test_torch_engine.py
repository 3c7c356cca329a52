"""repro_torch's FLEngine (device="cpu") against repro's sequential engine
(``batch_clients=False``) in the paper's four settings SS/SA/AS/AA, from
the same data and the same weights carried across from JAX.

Exact: bytes, staleness, participation, simulated time, and per record
round / sim_time / mean and max staleness (host arithmetic copied).
Within tolerance: the flat global model after 4 rounds
(``rtol=1e-5, atol=1e-6``: float32 training summed in other orders
drifts a few ulp per SGD step; the largest difference seen here is
1.2e-7) and the accuracy of every evaluated
round (within 2 of the test samples).
"""
import dataclasses
import json
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import paper as jpaper  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.launch import fl_sim as jfl_sim  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from repro_torch.sharding import flat  # noqa: E402

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


def _run_pair(setup, setting):
    shards, te, p_j, s_j = setup
    slr = 0.05 if jpaper.MODES[setting].aggregation == "fedsgd" else 1.0
    jcfg = dataclasses.replace(jpaper.MODES[setting], server_lr=slr,
                               batch_clients=False, **KW)
    tcfg = dataclasses.replace(tpaper.MODES[setting], server_lr=slr,
                               batch_clients=False, **KW)
    x, y = te.x[:N_TEST], te.y[:N_TEST]
    jeng = JEngine(jcfg, jcnn.cnn_apply, "image", p_j, s_j, shards, x, y)
    jres = jeng.run(ROUNDS)
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    teng = TEngine(tcfg, tcnn.cnn_apply, "image",
                   params_from_jax(p_np, "cpu"), {}, shards, x, y,
                   device="cpu")
    tres = teng.run(ROUNDS)
    return jeng, jres, teng, tres


@pytest.mark.parametrize("setting", ["SS", "SA", "AS", "AA"])
def test_engine_matches_reference(setup, setting):
    jeng, jres, teng, tres = _run_pair(setup, setting)
    # host accounting: exact
    assert teng.tx_bytes == jeng.tx_bytes
    assert teng.rx_bytes == jeng.rx_bytes
    assert tres.staleness_hist == jres.staleness_hist
    np.testing.assert_array_equal(tres.participation, jres.participation)
    assert tres.idle_time == jres.idle_time
    js, ts = dict(jres.sched_stats), dict(tres.sched_stats)
    np.testing.assert_array_equal(ts.pop("staleness_bins"),
                                  js.pop("staleness_bins"))
    assert ts == js
    assert len(tres.metrics.records) == len(jres.metrics.records) == ROUNDS
    for rt, rj in zip(tres.metrics.records, jres.metrics.records):
        assert (rt.round, rt.sim_time, rt.mean_staleness, rt.max_staleness,
                rt.tx_bytes, rt.rx_bytes) == \
            (rj.round, rj.sim_time, rj.mean_staleness, rj.max_staleness,
             rj.tx_bytes, rj.rx_bytes)
        assert abs(rt.accuracy - rj.accuracy) * N_TEST <= 2 + 1e-6
        assert not rt.nan_event
        np.testing.assert_allclose(rt.update_norm, rj.update_norm,
                                   rtol=1e-3)
    if setting in ("AS", "AA"):
        assert max(tres.staleness_hist) > 0
    # the global model, flat, element by element
    jflat = np.asarray(jflatbuf.PytreeCodec(jres.final_params).ravel(
        jres.final_params))
    np.testing.assert_allclose(teng._flat_params.numpy(), jflat,
                               rtol=1e-5, atol=1e-6)


def test_streaming_equals_buffered_bitwise(setup):
    """The port's two channels give the same run bit for bit (AS)."""
    shards, te, p_j, _ = setup
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    flats = []
    for channel in ("streaming", "buffered"):
        cfg = dataclasses.replace(tpaper.MODES["AS"], server_lr=0.05,
                                  server_channel=channel,
                                  batch_clients=False, **KW)
        eng = TEngine(cfg, tcnn.cnn_apply, "image",
                      params_from_jax(p_np, "cpu"), {}, shards,
                      te.x[:N_TEST], te.y[:N_TEST], device="cpu")
        eng.run(3)
        flats.append(eng._flat_params)
    assert torch.equal(flats[0], flats[1])


@pytest.mark.parametrize("field,value", [
    ("devices", 3), ("mesh_shape", (1, 1)), ("mesh_shape", (3, 1))])
def test_unported_settings_raise(setup, field, value):
    """The mesh settings, refused until the mesh was ported: on the CUDA
    default they need their GPUs and raise on a host without them; on the
    CPU the engine builds the mesh."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA mesh runs in chip_smoke.py")
    shards, te, p_j, _ = setup
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j), "cpu")
    cfg = dataclasses.replace(tpaper.MODES["AS"], **KW,
                              **{field: value})
    with pytest.raises(RuntimeError):
        TEngine(cfg, tcnn.cnn_apply, "image", p, {}, shards, te.x, te.y)
    eng = TEngine(cfg, tcnn.cnn_apply, "image", p, {}, shards, te.x, te.y,
                  device="cpu")
    assert flat.mesh_size(eng._mesh) == cfg.mesh_devices


def test_cuda_without_gpu_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA path runs in chip_smoke.py")
    shards, te, p_j, _ = setup
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(dataclasses.replace(tpaper.MODES["AS"], **KW),
                tcnn.cnn_apply, "image", p, {}, shards, te.x, te.y)


_FL_SIM_ARGS = ["--rounds", "2", "--samples", "240", "--clients", "5",
                "--k", "2"]


@pytest.mark.parametrize("mode,agg", [("semi_async", "fedsgd"),
                                      ("sync", "fedavg")])
def test_fl_sim_summary_matches_reference(tmp_path, monkeypatch, capsys,
                                          mode, agg):
    """Same --json-out keys; bytes, schedule, traffic and simulated time
    equal; both draw the CNN from PRNGKey(0), so the accuracy of every
    evaluated round is within 2 test samples of the reference's."""
    args = _FL_SIM_ARGS + ["--mode", mode, "--aggregation", agg]
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["fl_sim", *args, "--sequential",
                                     "--json-out", str(jout)])
    jfl_sim.main()
    j_log = capsys.readouterr().out
    tfl_sim.main([*args, "--sequential", "--device", "cpu", "--json-out",
                  str(tout)])
    t_log = capsys.readouterr().out
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    acc_j = [float(a) for a in re.findall(r" acc=([0-9.]+)", j_log)]
    acc_t = [float(a) for a in re.findall(r" acc=([0-9.]+)", t_log)]
    n_test = int(240 * 0.15)  # train_test_split's default share
    assert len(acc_t) == len(acc_j) == 2
    for a, b in zip(acc_t, acc_j):
        assert abs(a - b) * n_test <= 2 + 1e-6, (acc_t, acc_j)

    def keys(d, pre=""):
        out = set()
        for k, v in d.items():
            out.add(pre + k)
            if isinstance(v, dict):
                out |= keys(v, pre + k + ".")
        return out

    assert keys(t) == keys(j)
    for k in ("schema", "rounds", "tx_bytes", "rx_bytes", "tx_GB", "rx_GB",
              "duration_s", "mean_staleness", "sched", "traffic"):
        assert t[k] == j[k], k


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--mesh", "2", "2"]])
def test_fl_sim_refuses_unported_flags(flag):
    """``--devices`` and ``--mesh``, refused until the mesh was ported,
    parse now; on ``--device cuda`` without the mesh's GPUs the run
    raises."""
    args = tfl_sim.parse_args(flag)
    assert (args.devices, args.mesh) == ((2, None) if flag[0] == "--devices"
                                         else (1, [2, 2]))
    if torch.cuda.device_count() >= 4:
        pytest.skip("the mesh's GPUs are visible")
    with pytest.raises(RuntimeError):
        tfl_sim.main([*flag, "--device", "cuda", "--rounds", "1",
                      "--samples", "240", "--clients", "4", "--k", "4"])
