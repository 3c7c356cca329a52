"""The port's engines under the scheduler's timings, policies and
horizons, against repro's sequential engine (``batch_clients=False``), on
the reference test's tiny setup (``tests/test_sched.py``: the sentiment
LSTM at embed 2, hidden 4, 400 samples, 8 iid clients, k = 4, 4 rounds)
and one paper-CNN run on the q8 wire.

Every timing x {seafl, fedqs, uniform} on the ``k`` horizon, every
horizon (queue on both channels, timeout with ratelimit, hybrid),
fedasync with fedqs against the reference's streaming channel (its
buffered fedasync is faulty, ROADMAP queue 3), and the sync round under
lognormal and Markov timing (its durations) and fedqs, each on both of
the port's engines:

  * exact: the order of popped ``(cid, verdict)`` pairs, the staleness
    histogram, participation, bytes, and the rejected, idle, no-show and
    crash counts;
  * every popped event's time and every record's ``sim_time`` bitwise
    under every timing model (the timing stream's normal lanes are
    ``jax.random.normal``'s bit for bit);
  * params at ``PERF.md`` §2's bounds: ``rtol=1e-5, atol=1e-6`` on f32
    (fedopt ``atol=1e-5``), 1e-3 of the run's movement on q8 for a
    gradient target with error feedback.

Each reference run is made once (a module-scoped cache).  The LSTM runs
on one torch thread, the CNN on torch's default pool (on one thread its
q8 run leaves the reference by 5.6e-3 of its movement: ROADMAP queue
3).
"""
import contextlib
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.launch import fl_sim as jfl_sim  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402

ROUNDS = 4
STOCHASTIC = dict(sched_jitter_sigma=0.5, sched_drop_p=0.3,
                  sched_off_mean_s=2.0)
POLICIES = {"seafl": dict(sched_policy="seafl", sched_stale_cap=1),
            "fedqs": dict(sched_policy="fedqs"),
            "uniform": dict(sched_policy="uniform", sched_c=5)}
#: name -> (aggregation, FLConfig overrides)
SETTINGS = {f"{timing}-{pol}": ("fedsgd", dict(sched_timing=timing,
                                               **STOCHASTIC, **kw))
            for timing in ("static", "lognormal", "markov")
            for pol, kw in POLICIES.items()}
SETTINGS.update({
    "queue": ("fedbuff", dict(horizon="queue", horizon_queue=3)),
    "queue-buffered": ("fedavg", dict(horizon="queue", horizon_queue=3,
                                      server_channel="buffered")),
    "timeout-ratelimit": ("fedopt", dict(horizon="timeout",
                                         horizon_timeout_s=0.3,
                                         sched_policy="ratelimit",
                                         sched_rate_limit=2)),
    "hybrid-markov": ("sdga", dict(horizon="hybrid", horizon_timeout_s=0.3,
                                   horizon_queue=5, sched_timing="markov",
                                   **STOCHASTIC)),
    "timeout-lognormal-chaos": ("fedsgd", dict(
        horizon="timeout", horizon_timeout_s=0.4, sched_timing="lognormal",
        fault_crash_p=0.3, fault_straggler_p=0.2, **STOCHASTIC)),
    "fedasync-fedqs": ("fedasync", dict(sched_policy="fedqs",
                                        sched_timing="lognormal",
                                        **STOCHASTIC)),
    # the sync round's durations (timing.sync_duration) and FedQS's
    # scores in its buffered weights
    "sync-lognormal": ("fedsgd", dict(mode="sync", sched_timing="lognormal",
                                      **STOCHASTIC)),
    "sync-markov-fedqs": ("fedavg", dict(mode="sync", sched_timing="markov",
                                         sched_policy="fedqs",
                                         **STOCHASTIC)),
})
CNN_SETTING = ("cnn-q8-markov-seafl", "fedsgd",
               dict(wire="q8", sched_timing="markov",
                    sched_policy="seafl", sched_stale_cap=1, **STOCHASTIC))
SLR = {"fedsgd": 0.05, "sdga": 0.05, "fedbuff": 0.05, "fedopt": 0.005}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _record_pops(eng):
    """Wrap the engine's scheduler to log each pop's (time, cid, verdict,
    staleness)."""
    log, inner = [], eng.sched.pop

    def pop(rnd):
        ev = inner(rnd)
        if ev is not None:
            log.append((ev.time, ev.cid, ev.verdict, ev.staleness))
        return ev

    eng.sched.pop = pop
    return log


class Runs:
    """One reference run and one port run per (setting, engine), made at
    first use and shared by the checks."""

    def __init__(self):
        self._cache = {}
        ds = make_dataset("sentiment140", n=400, seed=0)
        tr, te = train_test_split(ds)
        self.lstm = dict(
            shards=build_client_shards(tr, "iid", n_clients=8,
                                       batch_size=8),
            x=te.x[:32], y=te.y[:32], kind=ds.kind,
            jmodel=jlstm.build_lstm(jax.random.PRNGKey(0), "sentiment",
                                    embed=2, hidden=4),
            tfn=functools.partial(tlstm.lstm_apply, task="sentiment"))
        ds = make_dataset("cifar10", n=300, seed=0, hw=8)
        tr, te = train_test_split(ds)
        p_j, s_j = jcnn.cnn_init(jax.random.PRNGKey(0), width=4,
                                 image_size=8)
        self.cnn = dict(
            shards=build_client_shards(tr, "hetero_dirichlet", 6, 16,
                                       seed=0, alpha=0.3),
            x=te.x[:150], y=te.y[:150], kind="image",
            jmodel=(p_j, s_j, jcnn.cnn_apply), tfn=tcnn.cnn_apply)

    def _kw(self, name):
        if name == CNN_SETTING[0]:
            agg, kw, n = CNN_SETTING[1], CNN_SETTING[2], 6
        else:
            (agg, kw), n = SETTINGS[name], 8
        return dict(n_clients=n, k=4 if n == 8 else 3, aggregation=agg,
                    client_lr=0.05, server_lr=SLR.get(agg, 1.0),
                    target_accuracy=0.9, speed_sigma=0.8, **kw)

    def _setup(self, name):
        return self.cnn if name == CNN_SETTING[0] else self.lstm

    def ref(self, name):
        key = ("ref", name)
        if key not in self._cache:
            su = self._setup(name)
            p, s, fn = su["jmodel"]
            eng = JEngine(JConfig(batch_clients=False, **self._kw(name)),
                          fn, su["kind"], p, s, su["shards"], su["x"],
                          su["y"])
            log = _record_pops(eng)
            self._cache[key] = (eng, eng.run(ROUNDS), log,
                                np.asarray(eng._flat_params).copy())
        return self._cache[key]

    def port(self, name, batched):
        key = ("port", name, batched)
        if key not in self._cache:
            su = self._setup(name)
            p, _, _ = su["jmodel"]
            # the CNN's q8 run on torch's default thread pool: on one
            # thread its convolutions sum in another order and q8 levels
            # flip (ROADMAP queue 3)
            with torch_threads(POOL if su is self.cnn else 1):
                eng = TEngine(TConfig(batch_clients=batched,
                                      **self._kw(name)),
                              su["tfn"], su["kind"],
                              params_from_jax(_np(p), "cpu"), {},
                              su["shards"], su["x"], su["y"], device="cpu")
                p0 = eng._flat_params.clone()
                log = _record_pops(eng)
                self._cache[key] = (eng, eng.run(ROUNDS), log, p0)
        return self._cache[key]


#: torch's default thread count, read at import
POOL = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's LSTM is tiny: a thread pool beside other test
    processes only slows it."""
    with torch_threads(1):
        yield


COUNTS = ("rejected_uploads", "idle_requests", "no_shows", "crashed_uploads",
          "policy", "timing", "participation")
ALL = list(SETTINGS) + [CNN_SETTING[0]]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_schedule_matches_reference(runs, name, batched):
    je, jr, jlog, _ = runs.ref(name)
    te, tr, tlog, _ = runs.port(name, batched)
    assert [e[1:] for e in tlog] == [e[1:] for e in jlog]
    assert tr.staleness_hist == jr.staleness_hist
    np.testing.assert_array_equal(tr.participation, jr.participation)
    assert (te.tx_bytes, te.rx_bytes) == (je.tx_bytes, je.rx_bytes)
    for key in COUNTS:
        assert tr.sched_stats[key] == jr.sched_stats[key], key
    assert [r.round for r in tr.metrics.records] == \
        [r.round for r in jr.metrics.records]
    assert [(r.tx_bytes, r.mean_staleness, r.max_staleness)
            for r in tr.metrics.records] == \
        [(r.tx_bytes, r.mean_staleness, r.max_staleness)
         for r in jr.metrics.records]
    times = np.asarray([e[0] for e in tlog])
    want = np.asarray([e[0] for e in jlog])
    sim = np.asarray([r.sim_time for r in tr.metrics.records])
    want_sim = np.asarray([r.sim_time for r in jr.metrics.records])
    np.testing.assert_array_equal(times, want)
    np.testing.assert_array_equal(sim, want_sim)
    assert len(tr.metrics.records) == ROUNDS


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_params_match_reference(runs, name, batched):
    je, jr, _, jflat = runs.ref(name)
    te, tr, _, p0 = runs.port(name, batched)
    got = te._flat_params.numpy()
    if runs._kw(name).get("wire") == "q8":
        rel = (np.linalg.norm(got - jflat)
               / np.linalg.norm(jflat - p0.numpy()))
        assert rel <= 1e-3, rel
    else:
        atol = 1e-5 if runs._kw(name)["aggregation"] == "fedopt" else 1e-6
        np.testing.assert_allclose(got, jflat, rtol=1e-5, atol=atol)
    assert not np.array_equal(got, p0.numpy())
    for a, b in zip(tr.metrics.records, jr.metrics.records):
        assert not a.nan_event
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)


def test_settings_exercise_every_verdict(runs):
    """The settings reach what they are there for: rejections under seafl
    and uniform, idles under ratelimit, no-shows under Markov, crashes
    under the chaos mix, horizons of other sizes than k."""
    def stats(name):
        return runs.ref(name)[1].sched_stats
    for pol in ("seafl", "uniform"):
        for timing in ("static", "lognormal", "markov"):
            assert stats(f"{timing}-{pol}")["rejected_uploads"] > 0
        assert stats(f"markov-{pol}")["no_shows"] > 0
    assert stats("timeout-ratelimit")["idle_requests"] > 0
    assert stats("timeout-lognormal-chaos")["crashed_uploads"] > 0
    for name in ("timeout-ratelimit", "hybrid-markov"):
        uploads = int(runs.ref(name)[1].participation.sum())
        assert uploads != ROUNDS * 4, name


_FL_SIM_ARGS = ["--rounds", "3", "--samples", "240", "--clients", "5",
                "--k", "2", "--sched-timing", "markov", "--sched-policy",
                "seafl", "--horizon", "hybrid", "--horizon-timeout-s",
                "0.3", "--sched-stale-cap", "1", "--sched-drop-p", "0.3"]


@pytest.mark.parametrize("sequential", [True, False])
def test_fl_sim_markov_seafl_hybrid(tmp_path, monkeypatch, capsys,
                                    sequential):
    """``fl_sim --sched-timing markov --sched-policy seafl --horizon
    hybrid``: the summary's ``sched``, bytes and staleness equal the
    reference launcher's under the same flags."""
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["fl_sim", *_FL_SIM_ARGS, "--sequential",
                                     "--json-out", str(jout)])
    jfl_sim.main()
    extra = ["--sequential"] if sequential else []
    tfl_sim.main([*_FL_SIM_ARGS, *extra, "--device", "cpu", "--json-out",
                  str(tout)])
    log = capsys.readouterr().out
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    js, ts = dict(j["sched"]), dict(t["sched"])
    # the reference's sequential engine fills no staleness_bins (the
    # device histogram of its batched engine)
    if not sequential:
        assert sum(ts.pop("staleness_bins")) == sum(
            t["sched"]["participation"])
        js.pop("staleness_bins")
    assert ts == js
    for k in ("tx_bytes", "rx_bytes", "mean_staleness", "rounds",
              "duration_s"):
        assert t[k] == j[k], k
    assert js["policy"] == "seafl" and js["timing"] == "markov"
    assert "no-shows:" in log
