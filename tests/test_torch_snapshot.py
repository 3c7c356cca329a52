"""Crash-consistent snapshots: repro_torch.checkpoint.io and the engine's
save_snapshot / load_snapshot, and ``fl_sim --ckpt-dir / --ckpt-every /
--resume``, on the CPU.

  * the io layer: the reference's file names and format (``leaf_{i}``
    in sorted-key order, the treedef / dtype JSON, ``engine_{step}``),
    its retention (``keep=3``, sidecars removed with their step), shape
    and dtype checks, and the commit order (a step without its
    checkpoint ``.json`` is not a step);
  * kill and resume on both engines, f32, q8 and q4, under the
    scheduler's timings, policies and horizons, with faults, and with
    ResNet-18's BatchNorm state: snapshot at round 2 of 5, load in a fresh
    engine, run on; the final flat params, state, every record, the
    counters and the staleness bins bitwise the uninterrupted run's;
  * the port's sidecar against the reference's on the same run: the same
    keys, key by key where both keep the value, and the same checkpoint
    leaves (dtypes and shapes);
  * each package's snapshot resumed by the other's engine of the same
    kind (q8 under Markov + seafl with crashes, so the residuals' owners
    cross; sdga, so its optimizer state crosses): bytes, staleness,
    verdict counts, every record's host fields and the simulated clock
    equal to the reference's uninterrupted run, params within
    ``PERF.md`` §2's bounds;
  * ``fl_sim`` killed after its first snapshot and run again with
    ``--resume``: the summary and the last snapshot's tensors equal the
    uninterrupted run's.
"""
import collections
import dataclasses
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

ROUNDS, CUT = 5, 2
STOCHASTIC = dict(sched_jitter_sigma=0.5, sched_drop_p=0.3,
                  sched_off_mean_s=2.0)
#: name -> (model, FLConfig overrides)
SETTINGS = {
    "f32-markov-seafl": ("lstm", dict(sched_timing="markov",
                                      sched_policy="seafl",
                                      sched_stale_cap=1, **STOCHASTIC)),
    "q8-markov-seafl": ("lstm", dict(wire="q8", sched_timing="markov",
                                     sched_policy="seafl",
                                     sched_stale_cap=1, **STOCHASTIC)),
    "q4-lognormal": ("lstm", dict(wire="q4", sched_timing="lognormal",
                                  **STOCHASTIC)),
    "fedopt-timeout-ratelimit": ("lstm", dict(
        aggregation="fedopt", server_lr=0.005, horizon="timeout",
        horizon_timeout_s=0.3, sched_policy="ratelimit",
        sched_rate_limit=2)),
    "sdga-q8-chaos-fedqs": ("lstm", dict(
        aggregation="sdga", wire="q8", sched_policy="fedqs",
        fault_crash_p=0.2, fault_straggler_p=0.2, fault_corrupt_p=0.1,
        defense="screen")),
    "cnn-q4-uniform": ("cnn", dict(wire="q4", sched_policy="uniform",
                                   sched_c=4)),
    "resnet-fedavg-q8": ("resnet18", dict(aggregation="fedavg",
                                          server_lr=1.0, wire="q8")),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are tiny: a thread pool beside other test processes
    only slows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(model):
    if model == "lstm":
        ds = make_dataset("sentiment140", n=400, seed=0)
        tr, te = train_test_split(ds)
        shards = build_client_shards(tr, "iid", n_clients=8, batch_size=8)
        p, s, fn = tlstm.build_lstm(prng_key(0), "sentiment", device="cpu",
                                    embed=2, hidden=4)
        return dict(shards=shards, x=te.x[:32], y=te.y[:32], kind=ds.kind,
                    model=(p, s, fn), n=8, k=4)
    hw = 8 if model == "cnn" else 16
    ds = make_dataset("cifar10", n=200 if model == "cnn" else 120, seed=0,
                      hw=hw)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "iid", 4, 16, seed=0)
    kw = (dict(width=4, image_size=8) if model == "cnn"
          else dict(width=2))
    p, s, fn = tcnn.build_paper_model(model, prng_key(0), device="cpu",
                                      n_classes=10, in_ch=3, **kw)
    return dict(shards=shards, x=te.x[:40], y=te.y[:40], kind="image",
                model=(p, s, fn), n=4, k=2)


def _engine(name, batched):
    model, kw = SETTINGS[name]
    su = _setup(model)
    p, s, fn = su["model"]
    cfg = TConfig(**{**dict(n_clients=su["n"], k=su["k"],
                            aggregation="fedsgd", client_lr=0.05,
                            server_lr=0.05, target_accuracy=0.9,
                            speed_sigma=0.8, batch_clients=batched), **kw})
    return TEngine(cfg, fn, su["kind"], p, s, su["shards"], su["x"],
                   su["y"], device="cpu")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_leaf(x, y):
    if not isinstance(x, torch.Tensor):  # the optimizer's step count
        return type(x) is type(y) and x == y
    return x.shape == y.shape and torch.equal(_bits(x), _bits(y))


def _same_tree(a, b):
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    return len(la) == len(lb) and all(map(_same_leaf, la, lb))


def _outcome(eng, res):
    st = dict(res.sched_stats)
    bins = st.pop("staleness_bins").tolist()
    return dict(records=[dataclasses.asdict(r) for r in res.metrics.records],
                stats=st, bins=bins, hist=dict(res.staleness_hist),
                tx=eng.tx_bytes, rx=eng.rx_bytes,
                waves=dict(eng.wave_size_hist), t=eng.t_global,
                sim=eng._last_agg_time)


# ------------------------------- io -------------------------------


def test_io_roundtrip_and_format(tmp_path):
    snap = {"b": {"w": torch.randn(3, 4), "q": torch.arange(6,
                                                            dtype=torch.int8)},
            "a": torch.randn(5).to(torch.bfloat16), "n": 7,
            "empty": {}}
    tio.save_checkpoint(str(tmp_path), 3, snap)
    files = sorted(os.listdir(tmp_path))
    assert files == ["ckpt_00000003.json", "ckpt_00000003.npz"]
    with np.load(tmp_path / "ckpt_00000003.npz") as data:
        assert sorted(data.files) == ["leaf_0", "leaf_1", "leaf_2",
                                      "leaf_3"]
        # sorted keys: a, b/q, b/w, n
        assert data["leaf_0"].dtype == np.float32
        np.testing.assert_array_equal(data["leaf_1"], np.arange(6))
        np.testing.assert_array_equal(data["leaf_2"], snap["b"]["w"].numpy())
        assert data["leaf_3"] == 7
    meta = json.loads((tmp_path / "ckpt_00000003.json").read_text())
    assert meta["step"] == 3 and meta["n_leaves"] == 4
    assert meta["dtypes"] == ["bfloat16", "int8", "float32", "int64"]
    back, step = tio.load_checkpoint(str(tmp_path), snap)
    assert step == 3 and back["n"] == 7 and isinstance(back["n"], int)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], snap["a"])
    assert _same_tree(back["b"], snap["b"]) and back["empty"] == {}
    # the reference's loader reads the port's file (same leaf order)
    jtpl = {"a": np.zeros(5, np.float32),
            "b": {"q": np.zeros(6, np.int8), "w": np.zeros((3, 4),
                                                           np.float32)},
            "n": np.zeros((), np.int64)}
    jback, _ = jio.load_checkpoint(str(tmp_path), jtpl)
    np.testing.assert_array_equal(np.asarray(jback["b"]["w"]),
                                  snap["b"]["w"].numpy())


def test_io_refuses_other_shapes_and_dtypes(tmp_path):
    tio.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaf 0"):
        tio.load_checkpoint(str(tmp_path), {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="dtypes"):
        tio.load_checkpoint(str(tmp_path),
                            {"w": torch.zeros(4, dtype=torch.float64)})
    with pytest.raises(ValueError, match="leaf count"):
        tio.load_checkpoint(str(tmp_path), {"w": torch.zeros(4),
                                            "v": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        tio.load_checkpoint(str(tmp_path / "none"), {"w": torch.zeros(4)})


def test_io_retention_and_commit_order(tmp_path):
    d = str(tmp_path)
    for step in (2, 4, 6, 8, 10):
        tio.save_state_json(d, step, {"step": step})
        tio.save_checkpoint(d, step, {"w": torch.full((2,), float(step))})
    assert tio.latest_steps(d) == [6, 8, 10]
    assert sorted(os.listdir(d)) == sorted(
        f"{p}_{s:08d}.{e}" for s in (6, 8, 10)
        for p, e in (("ckpt", "json"), ("ckpt", "npz"), ("engine", "json")))
    # a kill after the sidecar and before the checkpoint leaves no step
    tio.save_state_json(d, 12, {"step": 12})
    assert tio.latest_step(d) == 10
    assert tio.load_state_json(d, 10) == {"step": 10}
    back, step = tio.load_checkpoint(d, {"w": torch.zeros(2)})
    assert step == 10 and back["w"].tolist() == [10.0, 10.0]
    assert tio.latest_step(str(tmp_path / "none")) is None


# ------------------------------ engine ------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_kill_and_resume_is_bitwise(tmp_path, name, batched):
    full = _engine(name, batched)
    want = _outcome(full, full.run(ROUNDS))
    first = _engine(name, batched)
    first.run(CUT)
    assert first.save_snapshot(str(tmp_path)) == CUT
    first_waves = collections.Counter(first.wave_size_hist)
    del first  # the kill
    again = _engine(name, batched)
    assert again.load_snapshot(str(tmp_path)) == CUT
    got = _outcome(again, again.run(ROUNDS))
    # the wave histogram is not in the snapshot (as the reference's): the
    # resumed engine counts the waves after the cut
    got["waves"] = dict(first_waves + collections.Counter(got["waves"]))
    assert got == want
    assert torch.equal(_bits(again._flat_params), _bits(full._flat_params))
    assert _same_tree(again.global_state, full.global_state)
    assert _same_tree(again._opt, full._opt)
    assert again._sr_counter == full._sr_counter
    assert sorted(again._residuals) == sorted(full._residuals)
    for cid, r in full._residuals.items():
        assert torch.equal(_bits(again._residuals[cid]), _bits(r))
    for a, b in zip(again.clients, full.clients):
        assert a.version == b.version
        assert _same_tree(a.model_state, b.model_state)
    if SETTINGS[name][0] == "resnet18":
        assert not tree.is_empty(full.global_state)
    if SETTINGS[name][1].get("sched_policy") == "seafl":
        assert want["stats"]["rejected_uploads"] > 0


def test_load_refuses_the_other_engine(tmp_path):
    eng = _engine("f32-markov-seafl", False)
    eng.run(1)
    eng.save_snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="other engine"):
        _engine("f32-markov-seafl", True).load_snapshot(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _engine("f32-markov-seafl", False).load_snapshot(
            str(tmp_path / "none"))


#: sidecar keys the port and the reference both keep with equal values;
#: the metric records and the heap are compared apart
_EXACT = ("t_global", "batched", "last_agg_time", "tx_bytes", "rx_bytes",
          "idle_time", "staleness_hist", "sr_counter", "residual_cids",
          "client_versions", "screened_uploads", "clipped_uploads",
          "corrupted_uploads", "byzantine_uploads")


@pytest.mark.parametrize("batched", [False, True])
def test_sidecar_matches_reference(tmp_path, batched):
    """The same run (q8, Markov + seafl, crashes) on the reference's and
    the port's engine of one kind: the sidecars have the same keys, their
    host state equal key by key (the batched engines' staleness bins and
    participation, the sequential engines' zeros), and the checkpoints
    the same leaves: dtypes, shapes and the treedef's leaf count."""
    kw = dict(n_clients=8, k=4, aggregation="fedsgd", client_lr=0.05,
              server_lr=0.05, target_accuracy=0.9, speed_sigma=0.8,
              batch_clients=batched, wire="q8", sched_timing="markov",
              sched_policy="seafl", sched_stale_cap=1, fault_crash_p=0.2,
              **STOCHASTIC)
    su = _setup("lstm")
    p_j, s_j, f_j = jlstm.build_lstm(jax.random.PRNGKey(0), "sentiment",
                                     embed=2, hidden=4)
    je = JEngine(JConfig(**kw), f_j, su["kind"], p_j, s_j, su["shards"],
                 su["x"], su["y"])
    je.run(3)
    je.save_snapshot(str(tmp_path / "j"))
    te = TEngine(TConfig(**kw), su["model"][2], su["kind"],
                 params_from_jax(jax.tree_util.tree_map(np.asarray, p_j),
                                 "cpu"), {}, su["shards"], su["x"], su["y"],
                 device="cpu")
    te.run(3)
    te.save_snapshot(str(tmp_path / "t"))
    j = jio.load_state_json(str(tmp_path / "j"), 3)
    t = tio.load_state_json(str(tmp_path / "t"), 3)
    assert set(t) == set(j)
    for key in _EXACT + ("dev_participation",):
        assert t[key] == j[key], key
    if batched:
        assert t["dev_stale_hist"] == j["dev_stale_hist"]
        assert sum(t["dev_stale_hist"]) == sum(j["dev_participation"]) > 0
    else:
        assert not any(t["dev_participation"])
        # the reference's batched engine keeps its update norms in the
        # device ring only (its sidecar holds 0.0)
        np.testing.assert_allclose(t["last_update_norm"],
                                   j["last_update_norm"], rtol=1e-3)
    js, ts = dict(j["sched"]), dict(t["sched"])
    assert ts == js
    assert js["timing_counters"] and js["faults"]
    assert sum(js["rejected"]) > 0 and sum(js["crashed"]) > 0
    assert len(t["metrics"]) == len(j["metrics"]) == 3
    for a, b in zip(t["metrics"], j["metrics"]):
        assert set(a) == set(b)
        for key in ("round", "sim_time", "tx_bytes", "rx_bytes",
                    "mean_staleness", "max_staleness", "nan_event",
                    "screened_uploads", "clipped_uploads"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    jm = json.loads((tmp_path / "j" / "ckpt_00000003.json").read_text())
    tm = json.loads((tmp_path / "t" / "ckpt_00000003.json").read_text())
    assert tm["dtypes"] == jm["dtypes"] and tm["n_leaves"] == jm["n_leaves"]
    with np.load(tmp_path / "j" / "ckpt_00000003.npz") as a, \
            np.load(tmp_path / "t" / "ckpt_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].shape == b[f].shape and a[f].dtype == b[f].dtype, f


# --------------------------- across packages ---------------------------

#: runs resumed across the packages (the LSTM of ``_setup``, 8 clients,
#: k = 4): q8 with error feedback under Markov + seafl and crashes, whose
#: residuals' owners cross; sdga under lognormal timing, whose optimizer
#: state (momentum, EMA, int32 step) crosses
_CROSS = {
    "q8-markov-seafl-crash": dict(wire="q8", sched_timing="markov",
                                  sched_policy="seafl", sched_stale_cap=1,
                                  fault_crash_p=0.2, **STOCHASTIC),
    "sdga-lognormal": dict(aggregation="sdga", sched_timing="lognormal",
                           **STOCHASTIC),
}


def _cross_cfg(name, batched):
    return {**dict(n_clients=8, k=4, aggregation="fedsgd", client_lr=0.05,
                   server_lr=0.05, target_accuracy=0.9, speed_sigma=0.8,
                   batch_clients=batched), **_CROSS[name]}


@functools.lru_cache(maxsize=None)
def _jax_lstm():
    return jlstm.build_lstm(jax.random.PRNGKey(0), "sentiment", embed=2,
                            hidden=4)


def _cross_engine(pkg, name, batched):
    su = _setup("lstm")
    p_j, s_j, f_j = _jax_lstm()
    if pkg == "ref":
        return JEngine(JConfig(**_cross_cfg(name, batched)), f_j,
                       su["kind"], p_j, s_j, su["shards"], su["x"], su["y"])
    return TEngine(TConfig(**_cross_cfg(name, batched)), su["model"][2],
                   su["kind"], params_from_jax(
                       jax.tree_util.tree_map(np.asarray, p_j), "cpu"), {},
                   su["shards"], su["x"], su["y"], device="cpu")


def _accounts(eng, res):
    """A run's host accounting, as plain lists and numbers."""
    st = res.sched_stats
    return dict(
        records=[(r.round, r.sim_time, r.tx_bytes, r.rx_bytes,
                  r.mean_staleness, r.max_staleness, r.screened_uploads,
                  r.clipped_uploads) for r in res.metrics.records],
        stats={k: np.asarray(st[k]).tolist() for k in (
            "participation", "rejected_uploads", "idle_requests",
            "no_shows", "crashed_uploads", "staleness_bins")},
        hist=dict(res.staleness_hist), tx=int(eng.tx_bytes),
        rx=int(eng.rx_bytes), t=int(eng.t_global),
        sim=float(eng._last_agg_time))


@functools.lru_cache(maxsize=None)
def _ref_full(name, batched):
    """The reference's uninterrupted run: its accounting, final flat row
    and initial flat row."""
    eng = _cross_engine("ref", name, batched)
    p0 = np.asarray(eng._flat_params)
    res = eng.run(ROUNDS)
    return _accounts(eng, res), np.asarray(eng._flat_params), p0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
@pytest.mark.parametrize("name", list(_CROSS))
def test_snapshot_resumes_across_packages(tmp_path, name, direction,
                                          batched):
    """One package runs 2 rounds and snapshots; a fresh engine of the
    other package (same kind) loads it and runs to round 5.  Against the
    reference's uninterrupted run: the accounting exactly, the params at
    ``PERF.md`` §2's bounds (q8, a gradient target with error feedback:
    1e-3 of the run's movement; f32 sdga: ``rtol=1e-5, atol=1e-6``)."""
    src, dst = direction.split("->")
    first = _cross_engine(src, name, batched)
    first.run(CUT)
    first.save_snapshot(str(tmp_path))
    del first  # the kill
    again = _cross_engine(dst, name, batched)
    assert again.load_snapshot(str(tmp_path)) == CUT
    res = again.run(ROUNDS)
    want, jflat, p0 = _ref_full(name, batched)
    assert _accounts(again, res) == want
    got = (again._flat_params.numpy() if dst == "port"
           else np.asarray(again._flat_params))
    if _CROSS[name].get("wire") == "q8":
        rel = np.linalg.norm(got - jflat) / np.linalg.norm(jflat - p0)
        assert rel <= 1e-3, rel
        assert sorted(again._residuals)
    else:
        np.testing.assert_allclose(got, jflat, rtol=1e-5, atol=1e-6)
        assert int(again._opt["step"]) == ROUNDS
    assert not np.array_equal(got, p0)
    if name.startswith("q8"):
        assert want["stats"]["rejected_uploads"] > 0
        assert want["stats"]["crashed_uploads"] > 0


# ------------------------------ fl_sim ------------------------------

_FL_SIM_ARGS = ["--device", "cpu", "--rounds", "4", "--samples", "200",
                "--clients", "5", "--k", "2", "--wire", "q4",
                "--sched-timing", "lognormal", "--sched-policy", "seafl",
                "--sched-stale-cap", "1", "--ckpt-every", "2"]


def test_fl_sim_kill_and_resume(tmp_path, monkeypatch, capsys):
    """``fl_sim --ckpt-dir D --ckpt-every 2`` killed after its first
    snapshot, then run again with ``--resume``, ends where the
    uninterrupted run ends: the same summary and last snapshot."""
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    want = tfl_sim.main([*_FL_SIM_ARGS, "--ckpt-dir", full_dir])
    save = TEngine.save_snapshot

    def save_then_die(self, ckpt_dir, keep=3):
        step = save(self, ckpt_dir, keep)
        raise KeyboardInterrupt(f"killed after the snapshot of {step}")

    monkeypatch.setattr(TEngine, "save_snapshot", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        tfl_sim.main([*_FL_SIM_ARGS, "--ckpt-dir", cut_dir])
    monkeypatch.setattr(TEngine, "save_snapshot", save)
    assert tio.latest_steps(cut_dir) == [2]
    capsys.readouterr()
    got = tfl_sim.main([*_FL_SIM_ARGS, "--ckpt-dir", cut_dir, "--resume"])
    assert "# resumed from snapshot at round 2" in capsys.readouterr().out
    assert got == want
    assert tio.latest_steps(cut_dir) == tio.latest_steps(full_dir) == [2, 4]
    with np.load(os.path.join(full_dir, "ckpt_00000004.npz")) as a, \
            np.load(os.path.join(cut_dir, "ckpt_00000004.npz")) as b:
        assert a.files == b.files
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    for d in (full_dir, cut_dir):
        state = tio.load_state_json(d, 4)
        assert state["t_global"] == 4 and state["batched"]
    assert tio.load_state_json(full_dir, 4) == tio.load_state_json(cut_dir, 4)
