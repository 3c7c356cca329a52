"""The horizon-batched engine (``batch_clients=True``, the default) in the
port against the reference's batched engine and against the port's own
sequential engine, on the CPU.

Settings: the paper's four (SS, SA, AS, AA); fedbuff, fedasync, fedopt
and sdga in AS and sdga in SS on f32; one semi-async and one sync
setting on each of q8, q4 and top-k; the fault mix under the screen
(f32) and Byzantine uploads under clip; AA on q4 (a model target on a
lossy wire).  Width-4 CNN on 8x8 images (the sizes the sequential bounds
were set at), 6 Dirichlet clients, k = 4, 3 rounds, with short uploads
(``comm_mean_s`` 0.05) and spread speeds (``speed_sigma`` 1.5), so fast
clients upload twice in a horizon and the waves past the first run.

Against the reference's batched engine (each reference run made once and
reused by every check of its setting): bytes, the staleness histogram,
``staleness_bins``, participation, simulated time and the screened /
clipped / corrupted counts exact; accuracy within 2 test samples; params
within the sequential bounds of ``PERF.md`` §2 (f32 ``rtol=1e-5,
atol=1e-6``, fedopt and clip ``atol=1e-5``; q8, q4 and top-k <= 2e-2 of
the run's own movement, <= 1e-3 for gradient targets with error
feedback).

Against the port's sequential engine: with ``wave_impl="map"`` (what
``auto`` picks for the CNN) the flat params ``torch.equal`` and every
record equal, in every setting; ``wave_buckets`` on and off bitwise (the
port accepts the flag and runs every wave at its own size);
``vmap`` against ``map`` within ``rtol=1e-4, atol=1e-5`` on f32
and 2e-2 of the run's movement on the lossy wires, the bounds phase 5 of
``chip_smoke.py`` holds the card's vmapped engine to the CPU's with (the
batched unfold + matmul convolutions sum in another order: the largest
differences seen here are 6e-8 on f32, 9.6e-5 of the movement on q8,
where an ulp moved a level, and 2.5e-5 on top-k).  And the port's
``vmap`` waves against the reference's batched engine run with
``wave_impl="vmap"`` (``jax.vmap`` over its lanes), at the bounds of
the reference comparison above.
"""
import dataclasses
import json

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

ROUNDS = 3
N_TEST = 100
KW = dict(n_clients=6, k=4, client_lr=0.05, speed_sigma=1.5,
          comm_mean_s=0.05, target_accuracy=0.3)
SLR = {"fedsgd": 0.05, "sdga": 0.05, "fedbuff": 0.05, "fedopt": 0.005}
MODEL_TARGETS = ("fedavg", "fedasync")
CHAOS = dict(fault_crash_p=0.15, fault_straggler_p=0.1,
             fault_corrupt_p=0.2, fault_byzantine_p=0.05, fault_seed=19,
             defense="screen")
COUNTS = ("crashed_uploads", "corrupted_uploads", "byzantine_uploads",
          "screened_uploads", "clipped_uploads")
#: name -> (paper setting, FLConfig overrides)
SETTINGS = {
    "SS": ("SS", {}), "SA": ("SA", {}), "AS": ("AS", {}), "AA": ("AA", {}),
    "AS-fedbuff": ("AS", {"aggregation": "fedbuff"}),
    "AS-fedasync": ("AS", {"aggregation": "fedasync"}),
    "AS-fedopt": ("AS", {"aggregation": "fedopt"}),
    "AS-sdga": ("AS", {"aggregation": "sdga"}),
    "SS-sdga": ("SS", {"aggregation": "sdga"}),
    "AS-q8": ("AS", {"wire": "q8"}), "SS-q8": ("SS", {"wire": "q8"}),
    "AS-q4": ("AS", {"wire": "q4"}), "SS-q4": ("SS", {"wire": "q4"}),
    "AA-q4": ("AA", {"wire": "q4"}),
    "AS-topk": ("AS", {"wire": "topk"}),
    "SS-topk": ("SS", {"wire": "topk"}),
    "AS-chaos-screen": ("AS", CHAOS),
    # defense_norm_cap: 3x the median upload norm of a clean first round
    # (set by the fixture); Byzantine uploads are 10x a clean one
    "AS-byz-clip": ("AS", {"aggregation": "fedbuff",
                           "fault_byzantine_p": 0.3, "defense": "clip"}),
}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread.  Its engines run a width-4
    CNN whose ops a thread pool only slows, and far more so when other
    test processes share the cores (each pool takes all of them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class Runs:
    """Each setting's engines, made once and shared by the checks."""

    def __init__(self):
        ds = make_dataset("cifar10", n=400, seed=0, hw=8)
        tr, self.te = train_test_split(ds)
        self.shards = build_client_shards(tr, "hetero_dirichlet", 6, 16,
                                          seed=0, alpha=0.3)
        self.p_j, self.s_j = jcnn.cnn_init(jax.random.PRNGKey(0), width=4,
                                           image_size=8)
        self.p_np = jax.tree_util.tree_map(np.asarray, self.p_j)
        self.p0 = np.concatenate([self.p_np[k].ravel()
                                  for k in sorted(self.p_np)])
        self._cache = {}
        self._cap = None

    def cfg_kw(self, name):
        setting, over = SETTINGS[name]
        agg = over.get("aggregation", jpaper.MODES[setting].aggregation)
        kw = dict(KW, server_lr=SLR.get(agg, 1.0), **over)
        if kw.get("defense") == "clip":
            kw["defense_norm_cap"] = self.clip_cap()
        return setting, kw

    def clip_cap(self):
        if self._cap is None:
            eng = self._port_engine("AS", dict(KW, aggregation="fedbuff",
                                               server_lr=0.05,
                                               defense="screen"))
            norms, inner = [], eng._server.screen

            def screen(payload):
                out = inner(payload)
                norms.extend(np.sqrt(out.numpy()).tolist())
                return out

            eng._server.screen = screen
            eng.run(1)
            self._cap = float(3.0 * np.median(norms))
        return self._cap

    def _port_engine(self, setting, kw):
        return TEngine(dataclasses.replace(tpaper.MODES[setting], **kw),
                       tcnn.cnn_apply, "image",
                       params_from_jax(self.p_np, "cpu"), {}, self.shards,
                       self.te.x[:N_TEST], self.te.y[:N_TEST], device="cpu")

    def ref(self, name, **over):
        key = (name, "ref", tuple(sorted(over.items())))
        if key not in self._cache:
            setting, kw = self.cfg_kw(name)
            cfg = dataclasses.replace(jpaper.MODES[setting],
                                      batch_clients=True, **kw, **over)
            eng = JEngine(cfg, jcnn.cnn_apply, "image", self.p_j, self.s_j,
                          self.shards, self.te.x[:N_TEST],
                          self.te.y[:N_TEST])
            self._cache[key] = (eng, eng.run(ROUNDS))
        return self._cache[key]

    def port(self, name, **over):
        key = (name, tuple(sorted(over.items())))
        if key not in self._cache:
            setting, kw = self.cfg_kw(name)
            eng = self._port_engine(setting, dict(kw, **over))
            norms, inner = [], eng._server.screen

            def screen(payload):
                out = inner(payload)
                norms.extend(np.sqrt(out.numpy()).tolist())
                return out

            eng._server.screen = screen
            eng.screen_norms = norms
            self._cache[key] = (eng, eng.run(ROUNDS))
        return self._cache[key]


@pytest.fixture(scope="module")
def runs():
    return Runs()


def _flat_ref(jres):
    return np.asarray(jflatbuf.PytreeCodec(jres.final_params).ravel(
        jres.final_params))


def _assert_host_equal(eng_a, res_a, eng_b, res_b, acc_samples,
                       bins=True):
    """Bytes, staleness, participation, simulated time, the scheduler's
    and fault counts and every record's host fields equal; accuracy
    within ``acc_samples`` test samples; with ``bins`` the device
    staleness histograms equal too (only the batched semi-async engines
    fill them)."""
    assert eng_a.tx_bytes == eng_b.tx_bytes
    assert eng_a.rx_bytes == eng_b.rx_bytes
    assert res_a.staleness_hist == res_b.staleness_hist
    np.testing.assert_array_equal(res_a.participation, res_b.participation)
    assert res_a.idle_time == res_b.idle_time
    sa, sb = dict(res_a.sched_stats), dict(res_b.sched_stats)
    bins_a, bins_b = sa.pop("staleness_bins"), sb.pop("staleness_bins")
    if bins:
        np.testing.assert_array_equal(bins_a, bins_b)
    assert sa == sb
    assert len(res_a.metrics.records) == len(res_b.metrics.records) == \
        ROUNDS
    for ra, rb in zip(res_a.metrics.records, res_b.metrics.records):
        assert (ra.round, ra.sim_time, ra.mean_staleness, ra.max_staleness,
                ra.tx_bytes, ra.rx_bytes, ra.screened_uploads,
                ra.clipped_uploads) == \
            (rb.round, rb.sim_time, rb.mean_staleness, rb.max_staleness,
             rb.tx_bytes, rb.rx_bytes, rb.screened_uploads,
             rb.clipped_uploads)
        assert abs(ra.accuracy - rb.accuracy) * N_TEST <= acc_samples + 1e-6
        assert not ra.nan_event


def _rel_movement(got, want, p0):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - p0))


def _assert_params_near_reference(runs, name, teng, jres):
    """The port's final params against the reference's at the bounds of
    the module docstring."""
    setting, kw = runs.cfg_kw(name)
    got, want = teng._flat_params.numpy(), _flat_ref(jres)
    wire = kw.get("wire", "f32")
    agg = kw.get("aggregation", jpaper.MODES[setting].aggregation)
    if wire != "f32":
        rel = _rel_movement(got, want, runs.p0)
        assert rel <= (2e-2 if agg in MODEL_TARGETS else 1e-3), rel
    else:
        loose = agg == "fedopt" or kw.get("defense") == "clip"
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 if loose else 1e-6)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_batched_matches_reference_batched(runs, name):
    jeng, jres = runs.ref(name)
    teng, tres = runs.port(name)
    assert teng.wave_impl_resolved == "map"
    assert teng.wave_size_hist == jeng.wave_size_hist
    _assert_host_equal(teng, tres, jeng, jres, acc_samples=2)
    _assert_params_near_reference(runs, name, teng, jres)
    setting, kw = runs.cfg_kw(name)
    if setting.startswith("A"):
        # the batched semi-async engine fills the device histogram: the
        # reference's values, which the sequential engines leave at 0
        bins = tres.sched_stats["staleness_bins"]
        assert bins.sum() == sum(tres.staleness_hist.values()) > 0
    if kw.get("defense") == "screen":
        st = tres.sched_stats
        assert st["crashed_uploads"] > 0 and st["corrupted_uploads"] > 0
        assert st["screened_uploads"] == st["corrupted_uploads"]
    if kw.get("defense") == "clip":
        st = tres.sched_stats
        cap = kw["defense_norm_cap"]
        # no norm within 1e-3 of the cap: no verdict can flip on an ulp
        assert min(abs(n / cap - 1.0) for n in teng.screen_norms) > 1e-3
        assert st["byzantine_uploads"] > 0
        assert st["clipped_uploads"] >= st["byzantine_uploads"]


def test_schedule_has_waves_past_the_first(runs):
    """The settings' schedule puts a client twice into some horizon, so
    the later waves (carry rows, the refresh between lanes) run."""
    teng, _ = runs.port("AS")
    assert sum(teng.wave_size_hist.values()) > ROUNDS, teng.wave_size_hist


@pytest.mark.parametrize("name", list(SETTINGS))
def test_batched_map_equals_sequential_bitwise(runs, name):
    teng, tres = runs.port(name)
    seng, sres = runs.port(name, batch_clients=False)
    assert torch.equal(teng._flat_params, seng._flat_params)
    _assert_host_equal(teng, tres, seng, sres, acc_samples=0, bins=False)
    assert [(r.accuracy, r.loss, r.update_norm)
            for r in tres.metrics.records] == \
        [(r.accuracy, r.loss, r.update_norm) for r in sres.metrics.records]
    if SETTINGS[name][0].startswith("A"):
        assert not sres.sched_stats["staleness_bins"].any()
    assert teng._sr_counter == seng._sr_counter
    assert sorted(teng._residuals) == sorted(seng._residuals)
    for cid, res in teng._residuals.items():
        assert torch.equal(res, seng._residuals[cid])


@pytest.mark.parametrize("name", ["AS", "AS-fedasync", "AS-q4",
                                  "AS-chaos-screen"])
def test_wave_buckets_on_and_off_bitwise(runs, name):
    """``wave_buckets`` is accepted and changes nothing: the run is the
    same bit for bit with it off."""
    teng, tres = runs.port(name)
    ueng, ures = runs.port(name, wave_buckets=False)
    assert torch.equal(teng._flat_params, ueng._flat_params)
    _assert_host_equal(teng, tres, ueng, ures, acc_samples=0)


@pytest.mark.parametrize("name", ["AS", "SS", "AA", "AS-fedasync",
                                  "AS-q8", "SS-q4", "AS-topk"])
def test_vmap_close_to_map(runs, name):
    """The vmapped wave (``torch.func``, the convolutions as unfold +
    matmul) against the serial one: the same schedule and bytes, params
    within the stated tolerance."""
    teng, tres = runs.port(name)
    veng, vres = runs.port(name, wave_impl="vmap")
    assert veng.wave_impl_resolved == "vmap"
    _assert_host_equal(veng, vres, teng, tres, acc_samples=2)
    got, want = veng._flat_params.numpy(), teng._flat_params.numpy()
    if SETTINGS[name][1].get("wire", "f32") == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert _rel_movement(got, want, runs.p0) <= 2e-2


@pytest.mark.parametrize("name", ["AS", "SS", "AS-q8", "SS-q4",
                                  "AS-topk"])
def test_vmap_matches_reference_vmap(runs, name):
    """The port's vmapped waves against the reference's batched engine
    with ``wave_impl="vmap"``: host fields exact, params at the
    reference bounds."""
    jeng, jres = runs.ref(name, wave_impl="vmap")
    veng, vres = runs.port(name, wave_impl="vmap")
    assert veng.wave_impl_resolved == "vmap"
    assert veng.wave_size_hist == jeng.wave_size_hist
    _assert_host_equal(veng, vres, jeng, jres, acc_samples=2)
    _assert_params_near_reference(runs, name, veng, jres)


def test_fl_sim_batched_and_sequential_match_reference(tmp_path,
                                                       monkeypatch, capsys):
    """``fl_sim`` runs the batched engine by default and ``--sequential``
    the oracle: identical bytes, staleness, participation and accuracy;
    the batched run's ``staleness_bins`` are the reference launcher's."""
    args = ["--rounds", "3", "--samples", "400", "--clients", "8"]
    out = {}
    for tag, extra in (("batched", []), ("sequential", ["--sequential"])):
        path = tmp_path / f"{tag}.json"
        tfl_sim.main([*args, *extra, "--device", "cpu", "--json-out",
                      str(path)])
        out[tag] = json.loads(path.read_text())
    jpath = tmp_path / "ref.json"
    monkeypatch.setattr("sys.argv", ["fl_sim", *args, "--json-out",
                                     str(jpath)])
    jfl_sim.main()
    capsys.readouterr()
    ref = json.loads(jpath.read_text())
    b, s = out["batched"], out["sequential"]
    for k in ("tx_bytes", "rx_bytes", "duration_s", "mean_staleness",
              "best_accuracy", "final_accuracy", "traffic"):
        assert b[k] == s[k], k
    sb, ss = dict(b["sched"]), dict(s["sched"])
    assert sb.pop("staleness_bins") == ref["sched"]["staleness_bins"]
    assert sum(ss.pop("staleness_bins")) == 0
    assert sb == ss
    for k in ("schema", "rounds", "tx_bytes", "rx_bytes", "duration_s",
              "mean_staleness", "traffic"):
        assert b[k] == ref[k], k
    assert {k: v for k, v in b["sched"].items()} == ref["sched"]
    assert abs(b["final_accuracy"] - ref["final_accuracy"]) * 60 <= 2 + 1e-6
