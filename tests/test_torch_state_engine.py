"""The port's engines with model state (ResNet-18's BatchNorm statistics)
and with integer token inputs (the LSTM's two heads), against repro's
engines on the CPU.

ResNet-18 at the reference test's sizes (``test_quantized_channel.py``:
width 4, 16x16 CIFAR-10, 6 iid clients, batch 8, k = 3, 2 rounds) in AS,
AA and SA and AA on the q8 and q4 wires (the state then rides the q8
wire: the server sees its roundtrip), on the sequential engine and on the
horizon-batched one:

  * exact: tx / rx bytes (the state payload ``dq + 4 * n_qblocks`` of the
    state codec on q8 / q4), ``_upload_nbytes``, the staleness histogram,
    participation and every record's simulated time, against the
    reference's engine of the same kind;
  * the port's batched engine (``map`` waves, what ``auto`` picks for a
    conv model) bitwise its sequential engine: flat params and every
    leaf of the global state;
  * params and state against the reference's engine fed the same client
    updates (its ``epoch_fn`` the port's ``local_epoch``): f32
    ``rtol=1e-5, atol=1e-6``, params on q8 / q4 within 2e-2 of the run's
    own movement (``PERF.md`` §2).  This holds the server round and the
    state path.  The client's whole epoch is held in
    ``test_torch_paper_models.py``: to the reference's in f64, and in f32
    to the f64 epoch taking the f32 run's branches.  Free-running, two
    correct f32 runs of a conv model part: a unit whose input lies within
    rounding of its ReLU or max-pool kink lands on either side and moves
    the step by its whole gradient term (``repro_torch.models.kinks``).

VGG-16 (width 1/8, 32x32, the same sizes otherwise) in AS and SA: the
same checks, one test a setting.

The LSTM (embed 16, hidden 32) on Sentiment140 with ``lognormal_text``
and on Shakespeare with ``by_role``, AS and SS (and AA for sentiment), on
both engines (``vmap`` waves, what ``auto`` picks without a convolution,
as the reference does on the CPU): exact accounting as above and params
within ``rtol=1e-5, atol=1e-6`` of the free-running reference (the
largest difference seen is 1.2e-7).  Each reference run is made once and
reused by every check of its setting.
"""
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_ROUNDS, LSTM_ROUNDS = 2, 3
#: name -> (mode, aggregation, wire)
RESNET = {"AS": ("semi_async", "fedsgd", "f32"),
          "AA": ("semi_async", "fedavg", "f32"),
          "SA": ("sync", "fedavg", "f32"),
          "AA-q8": ("semi_async", "fedavg", "q8"),
          "AA-q4": ("semi_async", "fedavg", "q4")}
#: name -> (task, dataset, partition, mode, aggregation)
LSTM = {"sentiment-AS": ("sentiment", "sentiment140", "lognormal_text",
                         "semi_async", "fedsgd"),
        "sentiment-SS": ("sentiment", "sentiment140", "lognormal_text",
                         "sync", "fedsgd"),
        "sentiment-AA": ("sentiment", "sentiment140", "lognormal_text",
                         "semi_async", "fedavg"),
        "char-AS": ("char", "shakespeare", "by_role", "semi_async",
                    "fedsgd"),
        "char-SS": ("char", "shakespeare", "by_role", "sync", "fedsgd")}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _flat_j(t):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(t)])


def _flat_t(t):
    return np.concatenate([x.numpy().ravel() for x in tree.tree_leaves(t)])


def _cfg_kw(mode, agg, wire, batched):
    return dict(n_clients=6, k=3, mode=mode, aggregation=agg,
                client_lr=0.05, server_lr=1.0 if agg == "fedavg" else 0.05,
                target_accuracy=0.9, wire=wire, batch_clients=batched)


def _forced_epoch(apply_t, kind):
    """The port's local epoch as the reference engine's ``epoch_fn``: jax
    trees in, the port's result back as jax trees."""
    loss_fn = tclient.make_loss_fn(apply_t, kind)

    def epoch(params, state, xs, ys, mask, lr):
        xs = np.asarray(xs)
        p, s, loss = tclient.local_epoch(
            loss_fn, params_from_jax(_np(params), "cpu"),
            params_from_jax(_np(state), "cpu"),
            torch.as_tensor(xs.astype(np.int64) if xs.dtype.kind in "iu"
                            else xs),
            torch.as_tensor(np.asarray(ys, np.int64)),
            torch.as_tensor(np.asarray(mask)),
            np.asarray(mask).max(axis=1) > 0, float(lr))
        back = functools.partial(jax.tree_util.tree_map,
                                 lambda t: jnp.asarray(t.numpy()))
        return back(p), back(s), jnp.float32(float(loss))

    return epoch


#: the conv models' test sizes: (image side, builder kwargs, settings)
CONV = {"resnet18": (16, dict(width=4), RESNET),
        "vgg16": (32, dict(width_mult=0.125, image_size=32),
                  {k: RESNET[k] for k in ("AS", "SA")})}


class Runs:
    """Each setting's engines, made once and shared by the checks."""

    def __init__(self):
        self.conv = {}
        for model, (hw, kw, _) in CONV.items():
            ds = make_dataset("cifar10", n=240, seed=0, hw=hw)
            tr, te = train_test_split(ds)
            p_j, s_j, f_j = jcnn.build_paper_model(
                model, jax.random.PRNGKey(0), **kw)
            self.conv[model] = dict(
                shards=build_client_shards(tr, "iid", n_clients=6,
                                           batch_size=8),
                x=te.x[:32], y=te.y[:32], p_j=p_j, s_j=s_j, f_j=f_j,
                f_t=(functools.partial(tcnn.resnet18_apply, width=4)
                     if model == "resnet18" else tcnn.vgg16_apply))
        self.p_j, self.s_j = (self.conv["resnet18"][k] for k in ("p_j",
                                                                 "s_j"))
        self._cache = {}

    def _get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def ref_resnet(self, name, batched, forced=False, model="resnet18"):
        def make():
            cfg = JConfig(**_cfg_kw(*RESNET[name], batched))
            r = self.conv[model]
            eng = JEngine(cfg, r["f_j"], "image", r["p_j"], r["s_j"],
                          r["shards"], r["x"], r["y"])
            if forced:
                eng.epoch_fn = _forced_epoch(r["f_t"], "image")
            return eng, eng.run(RESNET_ROUNDS)
        return self._get(("ref", model, name, batched, forced), make)

    def port_resnet(self, name, batched, model="resnet18"):
        def make():
            cfg = TConfig(**_cfg_kw(*RESNET[name], batched))
            r = self.conv[model]
            eng = TEngine(cfg, r["f_t"], "image",
                          params_from_jax(_np(r["p_j"]), "cpu"),
                          params_from_jax(_np(r["s_j"]), "cpu"),
                          r["shards"], r["x"], r["y"], device="cpu")
            return eng, eng.run(RESNET_ROUNDS)
        return self._get(("port", model, name, batched), make)

    def lstm(self, name, batched):
        def make():
            task, dsname, dist, mode, agg = LSTM[name]
            ds = make_dataset(dsname, n=300, seed=0)
            tr, te = train_test_split(ds)
            kw = {"sigma": 0.5} if dist == "lognormal_text" else {}
            shards = build_client_shards(tr, dist, 6, 16, seed=0, **kw)
            mkw = dict(embed=16, hidden=32)
            if task == "char":
                mkw.update(vocab=80, n_out=80)
            p_j, s_j, f_j = jlstm.build_lstm(jax.random.PRNGKey(0), task,
                                             **mkw)
            f_t = functools.partial(tlstm.lstm_apply, task=task)
            kw = _cfg_kw(mode, agg, "f32", batched)
            x, y = te.x[:60], te.y[:60]
            je = JEngine(JConfig(**kw), f_j, ds.kind, p_j, s_j, shards, x, y)
            jr = je.run(LSTM_ROUNDS)
            te_ = TEngine(TConfig(**kw), f_t, ds.kind,
                          params_from_jax(_np(p_j), "cpu"), {}, shards, x,
                          y, device="cpu")
            tr_ = te_.run(LSTM_ROUNDS)
            return je, jr, te_, tr_, _flat_j(p_j)
        return self._get(("lstm", name, batched), make)


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread: its models are tiny, and
    a thread pool beside other test processes only slows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_accounting(je, jr, te, tr):
    assert te.tx_bytes == je.tx_bytes
    assert te.rx_bytes == je.rx_bytes
    assert te._upload_nbytes() == je._upload_nbytes()
    assert tr.staleness_hist == jr.staleness_hist
    np.testing.assert_array_equal(tr.participation, jr.participation)
    assert [r.sim_time for r in tr.metrics.records] == \
        [r.sim_time for r in jr.metrics.records]
    assert [r.round for r in tr.metrics.records] == \
        [r.round for r in jr.metrics.records]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(RESNET))
def test_resnet_accounting_matches_reference(runs, name, batched):
    """Bytes (with the state payload), schedule and participation exact;
    on q8 / q4 the state codec's sizes are the reference's."""
    je, jr = runs.ref_resnet(name, batched)
    te, tr = runs.port_resnet(name, batched)
    _same_accounting(je, jr, te, tr)
    if RESNET[name][2] == "f32":
        assert te._state_codec is None and je._state_codec is None
    else:
        sc, jsc = te._state_codec, je._state_codec
        assert (sc.d, sc.dq, sc.n_qblocks) == (jsc.d, jsc.dq, jsc.n_qblocks)
        assert sc.d == sum(v.numel()
                           for v in tree.tree_leaves(te.global_state))
    for leaf in tree.tree_leaves(te.global_state) + [te._flat_params]:
        assert bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("name", list(RESNET))
def test_resnet_batched_is_the_sequential_engine(runs, name):
    """``map`` waves: the batched engine's params and global BatchNorm
    state bitwise the sequential engine's, every record equal."""
    tb, rb = runs.port_resnet(name, True)
    ts, rs = runs.port_resnet(name, False)
    assert tb.wave_impl_resolved == "map"
    assert torch.equal(tb._flat_params, ts._flat_params)
    assert tree.tree_paths(tb.global_state) == \
        tree.tree_paths(ts.global_state)
    for a, b in zip(tree.tree_leaves(tb.global_state),
                    tree.tree_leaves(ts.global_state)):
        assert torch.equal(a, b)
    assert [(r.accuracy, r.loss, r.tx_bytes) for r in rb.metrics.records] \
        == [(r.accuracy, r.loss, r.tx_bytes) for r in rs.metrics.records]


@pytest.mark.parametrize("name", list(RESNET))
def test_resnet_state_path_matches_reference(runs, name):
    """The reference's sequential engine fed the port's client updates:
    the server round, fedavg's state mean (or the newest state), the q8
    state roundtrip and the eval give the port's params and state."""
    je, jr = runs.ref_resnet(name, False, forced=True)
    te, tr = runs.port_resnet(name, False)
    _same_accounting(je, jr, te, tr)
    got, want = te._flat_params.numpy(), np.asarray(je._flat_params)
    if RESNET[name][2] == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        p0 = _flat_j(runs.p_j)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want - p0)
        assert rel <= 2e-2, rel
    assert tree.tree_paths(te.global_state) == \
        tree.tree_paths(_np(je.global_state))
    np.testing.assert_allclose(_flat_t(te.global_state),
                               _flat_j(je.global_state), **TOL)
    # the state moved: fedavg's mean or the newest upload's, not the init
    assert not np.array_equal(_flat_t(te.global_state),
                              _flat_j(runs.s_j))
    for a, b in zip(tr.metrics.records, jr.metrics.records):
        assert abs(a.accuracy - b.accuracy) * 32 <= 1


@pytest.mark.parametrize("name", list(CONV["vgg16"][2]))
def test_vgg_engine_matches_reference(runs, name):
    """VGG-16 (width 1/8, 32x32) on both engines: accounting exact
    against the reference's engine, the batched engine (``map`` waves)
    bitwise the sequential one, and params against the reference's
    engine fed the port's client updates at ``rtol=1e-5, atol=1e-6``
    (a client's whole epoch is held to the reference in f64, and to
    f64 on its own branches in f32, in ``test_torch_paper_models.py``)."""
    je, jr = runs.ref_resnet(name, False, forced=True, model="vgg16")
    ts, rs = runs.port_resnet(name, False, model="vgg16")
    tb, rb = runs.port_resnet(name, True, model="vgg16")
    for te, tr in ((ts, rs), (tb, rb)):
        _same_accounting(je, jr, te, tr)
    assert tb.wave_impl_resolved == "map"
    assert torch.equal(tb._flat_params, ts._flat_params)
    np.testing.assert_allclose(ts._flat_params.numpy(),
                               np.asarray(je._flat_params), **TOL)
    assert not np.array_equal(ts._flat_params.numpy(),
                              _flat_j(runs.conv["vgg16"]["p_j"]))
    for a, b in zip(rs.metrics.records, jr.metrics.records):
        assert abs(a.accuracy - b.accuracy) * 32 <= 1


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(LSTM))
def test_lstm_engine_matches_reference(runs, name, batched):
    """Integer token shards through both engines: accounting exact, params
    within the f32 bound of the free-running reference, accuracy within
    one test sample (char: one position)."""
    je, jr, te, tr, p0 = runs.lstm(name, batched)
    _same_accounting(je, jr, te, tr)
    assert te.shards[0]["xs"].dtype == torch.int64
    assert te.test_x.dtype == torch.int64
    if batched:
        assert te.wave_impl_resolved == je.wave_impl_resolved == "vmap" \
            or LSTM[name][3] == "sync"
    np.testing.assert_allclose(te._flat_params.numpy(),
                               np.asarray(je._flat_params), **TOL)
    n = 60 * 47 if LSTM[name][0] == "char" else 60
    for a, b in zip(tr.metrics.records, jr.metrics.records):
        assert abs(a.accuracy - b.accuracy) * n <= 1 + 1e-6
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)
    assert not np.array_equal(te._flat_params.numpy(), p0)


_FL_SIM_ARGS = ["--rounds", "2", "--samples", "240", "--clients", "5",
                "--k", "2"]


def _keys(d, pre=""):
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict):
            out |= _keys(v, pre + k + ".")
    return out


@pytest.mark.parametrize("model", [
    ["--model", "resnet18"],
    ["--model", "lstm", "--dataset", "sentiment140", "--dist",
     "lognormal_text"]])
def test_fl_sim_model_matches_reference_launcher(tmp_path, monkeypatch,
                                                 model):
    """``fl_sim --model`` on its default (batched) engine against the
    reference launcher: the same --json-out keys, and bytes, staleness,
    the scheduler's stats and the traffic record equal."""
    from repro.launch import fl_sim as jfl_sim
    from repro_torch.launch import fl_sim as tfl_sim
    args = _FL_SIM_ARGS + model
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr("sys.argv", ["fl_sim", *args, "--json-out",
                                     str(jout)])
    jfl_sim.main()
    tfl_sim.main([*args, "--device", "cpu", "--json-out", str(tout)])
    j, t = (json.loads(p.read_text()) for p in (jout, tout))
    assert _keys(t) == _keys(j)
    for k in ("schema", "rounds", "tx_bytes", "rx_bytes", "tx_GB", "rx_GB",
              "duration_s", "mean_staleness", "sched", "traffic"):
        assert t[k] == j[k], k
