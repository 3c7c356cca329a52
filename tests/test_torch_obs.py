"""repro_torch.obs against repro.obs on the CPU: the span tracer through
both of the port's engines, the Chrome export, the metrics registry,
the profiling hooks, the report and ``fl_sim --trace-dir``.

The reference test's size (``tests/test_obs.py``: the paper CNN at width
4 on 16x16, 6 clients, k = 3, 4 rounds) in five settings that between
them make every record kind: fedbuff, the sync round, q8 under the chaos
mix (crashes, stragglers, corrupt uploads) with the screen, Markov
timing with seafl, and a timeout horizon with rate control.

  * the port's ``canonical`` stream equals the reference's record for
    record (its sequential engine: the reference's two engines emit one
    stream), on both of the port's engines;
  * a traced run's params, bytes, staleness, verdict counts and metric
    records are bitwise the untraced run's;
  * the stream reconciles with the engine: ingest bytes sum to
    ``tx_bytes``, the ``sched`` instants count the scheduler's rejected,
    idled, no-show and crashed totals, ``fac == 0`` ingests the screened;
  * the report, the Chrome export, ``to_native`` and the registry's
    exposition equal the reference's on the same input, and
    ``from_engine`` gives the reference's families with its host values;
  * ``CompileLog``'s contract, the engine's build counts, one ring flush
    a batched run, and ``fl_sim --trace-dir`` writing its four files (the
    trace equal to the reference launcher's).

Each run is made once (a module-scoped cache); torch runs on one thread.
"""
import collections
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.launch import fl_sim as jfl_sim  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import profile as tprofile  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs.trace import SpanTracer, canonical  # noqa: E402

ROUNDS = 4
STOCHASTIC = dict(sched_jitter_sigma=0.5, sched_drop_p=0.3,
                  sched_off_mean_s=2.0)
#: name -> FLConfig overrides
SETTINGS = {
    "fedbuff": dict(aggregation="fedbuff"),
    "sync": dict(mode="sync", aggregation="fedsgd"),
    "q8-chaos-screen": dict(aggregation="fedsgd", wire="q8",
                            defense="screen", fault_crash_p=0.15,
                            fault_straggler_p=0.15, fault_corrupt_p=0.3),
    "markov-seafl": dict(aggregation="fedsgd", sched_timing="markov",
                         sched_policy="seafl", sched_stale_cap=1,
                         **STOCHASTIC),
    "timeout-ratelimit": dict(aggregation="fedbuff", horizon="timeout",
                              horizon_timeout_s=0.3,
                              sched_policy="ratelimit", sched_rate_limit=2),
}
ENGINES = ("batched", "sequential")
INSTANTS = {"wake", "crash", "offline", "reject", "idle"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The model is tiny: a thread pool beside other test processes only
    slows it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    ds = make_dataset("cifar10", n=240, seed=0, hw=16)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "iid", n_clients=6, batch_size=16)
    p0, s0, fn = jcnn.build_paper_model("cnn", jax.random.PRNGKey(0),
                                        width=4, image_size=16)
    return shards, te.x[:100], te.y[:100], p0, s0, fn


def _cfg(cls, name, batched, level="upload", trace_dir=""):
    return cls(**{**dict(n_clients=6, k=3, mode="semi_async",
                         client_lr=0.05, server_lr=0.05,
                         target_accuracy=0.3, batch_clients=batched,
                         trace_level=level, trace_dir=trace_dir),
                  **SETTINGS[name]})


def _port_engine(name, batched, level="upload", trace_dir=""):
    shards, x, y, p0, _, _ = _setup()
    return TEngine(_cfg(TConfig, name, batched, level, trace_dir),
                   tcnn.cnn_apply, "image",
                   params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu"), {}, shards, x, y, device="cpu")


@functools.lru_cache(maxsize=None)
def _port(name, engine, level="upload"):
    eng = _port_engine(name, engine == "batched", level)
    return eng, eng.run(ROUNDS)


@functools.lru_cache(maxsize=None)
def _ref(name):
    """The reference's sequential engine, traced."""
    shards, x, y, p0, s0, fn = _setup()
    eng = JEngine(_cfg(JConfig, name, False), fn, "image", p0, s0, shards,
                  x, y)
    return eng, eng.run(ROUNDS)


def _named(eng, name):
    return [r for r in eng.tracer.records if r.get("name") == name]


def _outcome(eng, res):
    st = dict(res.sched_stats)
    return dict(
        bins=np.asarray(st.pop("staleness_bins")).tolist(),
        stats=st, hist=dict(res.staleness_hist), tx=eng.tx_bytes,
        rx=eng.rx_bytes, t=eng.t_global, sim=eng._last_agg_time,
        records=[(r.round, r.sim_time, r.accuracy, r.loss, r.tx_bytes,
                  r.rx_bytes, r.mean_staleness, r.max_staleness,
                  r.update_norm, r.screened_uploads, r.clipped_uploads)
                 for r in res.metrics.records])


# ----------------------------- the stream -----------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(SETTINGS))
def test_stream_matches_reference(name, engine):
    """Record for record, the wall-clock note aside: the meta record, each
    upload's train / wire / ingest (staleness, bytes, fac, the folded
    weight), the scheduler's instants, the aggregate and round spans with
    their counters."""
    te, _ = _port(name, engine)
    je, _ = _ref(name)
    got, want = canonical(te.tracer.records), canonical(je.tracer.records)
    assert len(got) > 20
    assert got == want
    assert all("wall" in r for r in _named(te, "round"))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_batched_equals_sequential(name):
    a = canonical(_port(name, "batched")[0].tracer.records)
    b = canonical(_port(name, "sequential")[0].tracer.records)
    assert a == b


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["fedbuff", "q8-chaos-screen",
                                  "markov-seafl", "timeout-ratelimit"])
def test_traced_equals_untraced(name, engine):
    """Tracing is host bookkeeping over values the engine holds: the
    traced run's params and accounting equal the untraced run's bit for
    bit."""
    te, tr = _port(name, engine)
    ue = _port_engine(name, engine == "batched", level="off")
    ur = ue.run(ROUNDS)
    assert ue.tracer is None and ue.sched.tracer is None
    assert torch.equal(te._flat_params.view(torch.int32),
                       ue._flat_params.view(torch.int32))
    assert _outcome(te, tr) == _outcome(ue, ur)


def test_every_instant_kind_appears():
    seen = collections.Counter()
    for name in SETTINGS:
        for r in _port(name, "batched")[0].tracer.records:
            if r.get("cat") == "sched":
                seen[r["name"]] += 1
    assert set(seen) == INSTANTS, seen


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(SETTINGS))
def test_stream_reconciles_with_engine(name, engine):
    eng, res = _port(name, engine)
    ingests = _named(eng, "ingest")
    assert sum(i["bytes"] for i in ingests) == eng.tx_bytes
    hist = collections.Counter(i["staleness"] for i in ingests
                               if "round" in i)
    assert hist == {s: n for s, n in eng.staleness_hist.items() if n}
    counts = _named(eng, "round")[-1]["counts"]
    assert counts == dict(tx_bytes=eng.tx_bytes, rx_bytes=eng.rx_bytes,
                          screened=eng.screened_uploads,
                          clipped=eng.clipped_uploads,
                          corrupted=eng.corrupted_uploads,
                          byzantine=eng.byzantine_uploads)
    for rs in _named(eng, "round"):
        assert rs["k"] == sum(1 for i in ingests
                              if i.get("round") == rs["round"])
    st = res.sched_stats
    sched = collections.Counter(r["name"] for r in eng.tracer.records
                                if r.get("cat") == "sched")
    assert sched["reject"] == st["rejected_uploads"]
    assert sched["idle"] == st["idle_requests"]
    assert sched["offline"] == st["no_shows"]
    assert sched["crash"] == st["crashed_uploads"]
    assert sum(1 for i in ingests if i.get("fac") == 0.0) == \
        eng.screened_uploads
    if name == "q8-chaos-screen":
        assert eng.screened_uploads > 0
    # each upload's train -> wire -> ingest chain is contiguous
    spans = {(r["name"], r["cid"], r["slot"], r.get("round")): r
             for r in eng.tracer.records if r.get("name") in ("train",
                                                              "wire")}
    for i in ingests:
        key = (i["cid"], i["slot"], i.get("round"))
        assert spans[("train",) + key]["t1"] == spans[("wire",) + key]["t0"]
        assert spans[("wire",) + key]["t1"] == i["t"]


def test_round_level_drops_upload_spans():
    eng, _ = _port("markov-seafl", "batched", "round")
    names = {r.get("name") for r in eng.tracer.records}
    assert names == {None, "aggregate", "round"}
    assert len(_named(eng, "round")) == ROUNDS
    want = [r for r in canonical(_port("markov-seafl",
                                       "batched")[0].tracer.records)
            if r.get("name") in ("aggregate", "round")]
    got = [{k: v for k, v in r.items()}
           for r in canonical(eng.tracer.records)[1:]]
    assert got == want


def test_trace_level_validated():
    with pytest.raises(AssertionError):
        TConfig(trace_level="verbose").validate()
    with pytest.raises(ValueError):
        SpanTracer(level="off")
    assert set(TEngine.PORTED["trace_level"]) == {"off", "round", "upload"}


# ----------------------- JSONL, report, Chrome -----------------------


def test_jsonl_roundtrip_and_report(tmp_path, capsys):
    eng = _port_engine("q8-chaos-screen", True, trace_dir=str(tmp_path))
    eng.run(ROUNDS)
    eng.tracer.close()
    assert eng.tracer.path == str(tmp_path / "trace.jsonl")
    records = texport.load_jsonl(eng.tracer.path)
    assert records == eng.tracer.records
    text = treport.render(records)
    assert text == jreport.render(records)
    assert text.count("\nr") >= ROUNDS
    assert "staleness at ingest:" in text and "defense: screened=" in text
    assert treport.main([eng.tracer.path]) == 0
    assert "bytes by wire:" in capsys.readouterr().out


def test_chrome_export_matches_reference(tmp_path):
    records = _port("timeout-ratelimit", "batched")[0].tracer.records
    out = str(tmp_path / "trace.json")
    obj = texport.export_chrome_trace(records, out)
    with open(out) as f:
        assert json.load(f) == obj
    assert obj == jexport.export_chrome_trace(records)
    assert texport.validate_chrome_trace(obj) == len(obj["traceEvents"])
    qd = [e["args"]["uploads"] for e in obj["traceEvents"]
          if e["ph"] == "C" and e["name"] == "queue_depth"]
    assert max(qd) >= 2 and 0 in qd


@pytest.mark.parametrize("bad", [
    {"traceEvents": []}, [], {"traceEvents": [{"ph": "Z", "name": "x",
                                               "pid": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "ts": 0.0,
                      "dur": -1.0, "tid": 0}]},
    {"traceEvents": [{"ph": "C", "name": "q", "pid": 1, "ts": 0.0,
                      "args": {"n": "one"}}]},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 1}]}])
def test_chrome_validation_rejects_bad_shapes(bad):
    for mod in (texport, jexport):
        with pytest.raises(ValueError):
            mod.validate_chrome_trace(bad)


def test_to_native():
    obj = {"a": np.float32(1.5), "b": np.int64(3),
           "c": np.arange(3, dtype=np.int32), 4: "int-key",
           "d": {"nested": np.bool_(True)}, "e": [np.float64(0.25), None],
           "t0": torch.tensor(2.5), "t1": torch.arange(3),
           "tb": torch.tensor([True, False])}
    native = texport.to_native(obj)
    assert json.loads(json.dumps(native)) == native
    assert native["4"] == "int-key" and native["b"] == 3
    assert native["t0"] == 2.5 and native["t1"] == [0, 1, 2]
    assert native["tb"] == [True, False]
    del obj["t0"], obj["t1"], obj["tb"]
    assert texport.to_native(obj) == jexport.to_native(obj)
    with pytest.raises(TypeError, match="CPU tensors"):
        texport.to_native(torch.empty(2, device="meta"))


# ------------------------------ metrics ------------------------------


def _fill(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("up_total", "uploads", wire="q8")
    c.inc(3)
    assert reg.counter("up_total", wire="q8") is c
    reg.counter("up_total", wire="f32").inc(1.5)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("stale", buckets=(1, 2.5))
    for v in (0.5, 2, 5):
        h.observe(v)
    h.observe(1, n=3)
    with pytest.raises(ValueError):
        reg.gauge("up_total")
    with pytest.raises(ValueError):
        mod.Counter().inc(-1)
    return reg


def test_registry_exposition():
    t, j = _fill(tmetrics), _fill(jmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_json() == j.to_json()
    text = t.to_prometheus()
    assert 'up_total{wire="q8"} 3' in text
    assert 'stale_bucket{le="2.5"} 5' in text
    assert 'stale_bucket{le="+Inf"} 6' in text


#: gauges read off the wall clock, not the run's host state
_WALL = ("safl_wall_run_seconds", "safl_folds_per_second")


@pytest.mark.parametrize("name", ["q8-chaos-screen", "timeout-ratelimit"])
def test_from_engine_matches_reference(name):
    te, _ = _port(name, "batched")
    je, _ = _ref(name)
    t = tmetrics.from_engine(te).to_json()
    j = jmetrics.from_engine(je).to_json()
    assert set(t) == set(j)
    for fam in set(t) - set(_WALL):
        assert t[fam] == j[fam], fam
    assert t["safl_wall_run_seconds"]["samples"][0]["value"] == \
        te.wall_run_s > 0
    assert t["safl_rounds_total"]["samples"][0]["value"] == ROUNDS


# ------------------------------ profile ------------------------------


def test_compile_log_contract():
    class Srv:
        compile_count = 3

    class Attr:
        folds = 2

    log = (tprofile.CompileLog().track("srv", Srv())
           .track("unknown", object()).track("fold", Attr(), attr="folds"))
    assert log.counts() == {"srv": 3, "unknown": -1, "fold": 2}
    assert log.assert_exactly("srv", 3) == 3
    assert log.assert_at_most("fold", 2) == 2
    assert log.assert_exactly("unknown", 99) == -1
    with pytest.raises(AssertionError):
        log.assert_exactly("srv", 2)
    with pytest.raises(AssertionError):
        log.assert_at_most("fold", 1)


def test_engine_compile_log():
    """The wave program resolves once a batched engine (never on the
    sequential one); no kernel library loads on the CPU."""
    want = {f"kernels.{n}": 0 for n in tprofile.KERNEL_LIBRARIES}
    for engine, wave in (("batched", 1), ("sequential", 0)):
        counts = tprofile.engine_compile_log(
            _port("fedbuff", engine)[0]).counts()
        assert counts == {"wave": wave, **want}
    fresh = _port_engine("fedbuff", True)
    assert tprofile.engine_compile_log(fresh).count("wave") == 0


@pytest.mark.parametrize("engine,flushes", [("batched", 1),
                                            ("sequential", 0)])
def test_run_flushes_ring_exactly_once(engine, flushes):
    eng = _port_engine("markov-seafl", engine == "batched")
    with tprofile.TransferScope() as ts:
        eng.run(ROUNDS)
    assert ts.delta() == ({"metrics_ring.flush": 1} if flushes else {})
    assert ts.count("metrics_ring.flush") == flushes
    assert tprofile.transfer_counts().get("metrics_ring.flush", 0) >= \
        flushes


def test_torch_profile_toggle(tmp_path):
    with tprofile.torch_profile(str(tmp_path), enabled=False) as prof:
        assert prof is None
    with tprofile.torch_profile("", enabled=True) as prof:
        assert prof is None
    with tprofile.torch_profile(str(tmp_path)) as prof:
        torch.ones(8).add_(1)
    assert prof is not None
    with open(tmp_path / tprofile.PROFILE_TRACE) as f:
        assert json.load(f)["traceEvents"]


# ------------------------------ fl_sim ------------------------------

_FL_SIM_ARGS = ["--rounds", "3", "--samples", "240", "--clients", "5",
                "--k", "2", "--sched-timing", "markov", "--sched-policy",
                "seafl", "--sched-stale-cap", "1", "--sched-drop-p", "0.3"]


def test_fl_sim_trace_dir(tmp_path, monkeypatch, capsys):
    """``fl_sim --trace-dir`` (level upload by default) writes
    trace.jsonl, trace.json, metrics.prom and metrics.json; the trace
    equals the reference launcher's record for record, the exports and
    the registry's host values too; ``--trace-jax`` adds the profiler's
    trace; the report renders it."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    monkeypatch.setattr("sys.argv", ["fl_sim", *_FL_SIM_ARGS, "--sequential",
                                     "--trace-dir", str(jdir)])
    jfl_sim.main()
    tfl_sim.main([*_FL_SIM_ARGS, "--device", "cpu", "--trace-dir",
                  str(tdir), "--trace-jax"])
    assert "# trace: " in capsys.readouterr().out
    files = {"trace.jsonl", "trace.json", "metrics.prom", "metrics.json"}
    assert files <= set(os.listdir(tdir))
    assert tprofile.PROFILE_TRACE in os.listdir(tdir)
    got = texport.load_jsonl(str(tdir / "trace.jsonl"))
    want = jexport.load_jsonl(str(jdir / "trace.jsonl"))
    assert canonical(got) == canonical(want)
    assert {r["name"] for r in got if r.get("cat") == "sched"} >= {
        "offline", "reject"}

    def strip(path):
        obj = json.loads(path.read_text())
        for ev in obj["traceEvents"]:
            ev.get("args", {}).pop("wall", None)
        return obj

    assert strip(tdir / "trace.json") == strip(jdir / "trace.json")
    tm = json.loads((tdir / "metrics.json").read_text())
    jm = json.loads((jdir / "metrics.json").read_text())
    assert set(tm) == set(jm)
    for fam in set(tm) - set(_WALL):
        assert tm[fam] == jm[fam], fam
    assert treport.main([str(tdir / "trace.jsonl")]) == 0
    assert capsys.readouterr().out.startswith(
        "trace: mode=semi_async aggregation=fedsgd wire=f32")


def test_fl_sim_trace_level_round(tmp_path):
    tfl_sim.main(["--rounds", "2", "--samples", "200", "--clients", "4",
                  "--k", "2", "--device", "cpu", "--trace-dir",
                  str(tmp_path), "--trace-level", "round"])
    recs = texport.load_jsonl(str(tmp_path / "trace.jsonl"))
    assert recs[0]["level"] == "round"
    assert {r["name"] for r in recs[1:]} == {"aggregate", "round"}
