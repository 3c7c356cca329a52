"""Both engines of the port on the meshes against the reference's
single-device engine, on the CPU (every shard on the CPU device).

The setup is the reference's own mesh tests' (``tests/test_hier_mesh.py``:
the sentiment LSTM at embed 2, hidden 4 on Sentiment140, 8 iid clients,
k = 4, fedsgd, 4 rounds).  Settings: semi-async on the streaming and the
buffered f32 channels and on the q8 wire (streaming), and the sync round;
each on the horizon-batched and the sequential engine, on the (2, 2) mesh
and on ``devices=2``.

  * against the reference's single-device engine (one run a setting and
    engine, shared by the checks): bytes, staleness, participation and
    simulated times exact; params within ``atol=rtol=1e-4`` on f32 and
    ``5e-3`` on q8 (the reference's mesh tests' bounds: the mesh sums the
    rows in another order); the traffic record the reference's
    ``edge_traffic`` of the mesh;
  * the mesh's streaming channel bitwise its buffered one (k horizon);
  * ``mesh_shape=(1, 2)`` bitwise ``devices=2``; ``devices=4`` (a row a
    shard, so the shards add in the single device's order) bitwise the
    port's single-device run;
  * kill at round 2 and resume into a fresh (2, 2) engine: bitwise the
    uninterrupted run, records and counters equal;
  * a wave whose lanes sit on several devices (forced here by grouping
    the lanes by shard, every shard's lanes a wave of their own) equals
    the one-call wave bitwise with ``map`` lanes, semi-async and sync.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.models.lstm import build_lstm  # noqa: E402
from repro.sharding import flat as jflat  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import safl as tsafl  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.sharding import flat  # noqa: E402

ROUNDS = 4
SETTINGS = {"AS": {}, "AS-buffered": {"server_channel": "buffered"},
            "AS-q8": {"compress_updates": True}, "SS": {"mode": "sync"}}
MESHES = {"2x2": {"mesh_shape": (2, 2)}, "devices2": {"devices": 2}}
ENGINES = {"batched": True, "sequential": False}


def _cfg_kw(setting, batched, **extra):
    kw = dict(n_clients=8, k=4, mode="semi_async", aggregation="fedsgd",
              client_lr=0.05, server_lr=0.05, target_accuracy=0.9,
              batch_clients=batched)
    kw.update(SETTINGS[setting])
    kw.update(extra)
    return kw


class Runs:
    """The setup and each run, made once and shared by the checks."""

    def __init__(self):
        ds = make_dataset("sentiment140", n=400, seed=0)
        tr, self.te = train_test_split(ds)
        self.shards = build_client_shards(tr, "iid", n_clients=8,
                                          batch_size=8)
        self.p_j, self.s_j, self.f_j = build_lstm(
            jax.random.PRNGKey(0), "sentiment", embed=2, hidden=4)
        self.p_t = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          self.p_j), "cpu")
        self._cache = {}

    def ref(self, setting, batched):
        key = ("ref", setting, batched)
        if key not in self._cache:
            eng = JEngine(JConfig(**_cfg_kw(setting, batched)), self.f_j,
                          "sentiment", self.p_j, self.s_j, self.shards,
                          self.te.x[:32], self.te.y[:32])
            self._cache[key] = (eng, eng.run(ROUNDS))
        return self._cache[key]

    def engine(self, setting, batched, **extra):
        return TEngine(TConfig(**_cfg_kw(setting, batched, **extra)),
                       functools.partial(tlstm.lstm_apply,
                                         task="sentiment"),
                       "sentiment", self.p_t, {}, self.shards,
                       self.te.x[:32], self.te.y[:32], device="cpu")

    def port(self, setting, batched, mesh):
        key = ("port", setting, batched, mesh)
        if key not in self._cache:
            eng = self.engine(setting, batched, **MESHES[mesh])
            self._cache[key] = (eng, eng.run(ROUNDS))
        return self._cache[key]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread: the LSTM is tiny, and a
    thread pool beside other test processes only slows it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_accounting(je, jr, te, tr):
    assert te.tx_bytes == je.tx_bytes
    assert te.rx_bytes == je.rx_bytes
    assert tr.staleness_hist == jr.staleness_hist
    np.testing.assert_array_equal(tr.participation, jr.participation)
    assert [r.sim_time for r in tr.metrics.records] == \
        [r.sim_time for r in jr.metrics.records]
    assert [r.round for r in tr.metrics.records] == \
        [r.round for r in jr.metrics.records]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_mesh_engine_matches_single_device_reference(runs, setting, engine,
                                                     mesh):
    je, jr = runs.ref(setting, ENGINES[engine])
    te, tr = runs.port(setting, ENGINES[engine], mesh)
    _same_accounting(je, jr, te, tr)
    tol = 5e-3 if setting == "AS-q8" else 1e-4
    np.testing.assert_allclose(te._flat_params.numpy(),
                               np.asarray(je._flat_params), atol=tol,
                               rtol=tol)
    shape = te._server.traffic["mesh_shape"]
    assert shape == ((2, 2) if mesh == "2x2" else (1, 2))
    assert te._server.traffic == jflat.edge_traffic(
        shape, je._server.traffic["cross_edge_bytes"] - 4)
    assert te._mesh.size == (4 if mesh == "2x2" else 2)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_mesh_streaming_is_bitwise_the_buffered(runs, engine, mesh):
    es, rs = runs.port("AS", ENGINES[engine], mesh)
    eb, rb = runs.port("AS-buffered", ENGINES[engine], mesh)
    assert es._accum is not None and eb._rows is not None
    assert torch.equal(es._flat_params, eb._flat_params)
    assert [r.loss for r in rs.metrics.records] == \
        [r.loss for r in rb.metrics.records]


def test_mesh_channels_live_on_the_shards(runs):
    """One bank a shard on the streaming channel, K/N rows a shard on the
    buffered one, each on its shard's device."""
    es, _ = runs.port("AS", True, "2x2")
    assert es._accum.n_rows == 4
    assert len(es._accum.devices) == 4
    eb, _ = runs.port("AS-buffered", True, "2x2")
    views = eb._rows.views
    assert len(views) == 4 and all(v.shape == (1, eb.codec.d)
                                   for v in views)
    eq, _ = runs.port("SS", True, "devices2")
    assert [v.shape for v in eq._rows.views] == [(2, eq.codec.d)] * 2


@pytest.mark.parametrize("engine", list(ENGINES))
def test_alias_engine_is_bitwise_the_devices_engine(runs, engine):
    ed, _ = runs.port("AS", ENGINES[engine], "devices2")
    ea = runs.engine("AS", ENGINES[engine], mesh_shape=(1, 2))
    ea.run(ROUNDS)
    assert not flat.is_hier(ea._mesh)
    assert torch.equal(ea._flat_params, ed._flat_params)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_a_row_a_shard_is_the_single_device_run(runs, setting, engine):
    one = runs.engine(setting, ENGINES[engine])
    one.run(ROUNDS)
    mesh = runs.engine(setting, ENGINES[engine], devices=4)
    mesh.run(ROUNDS)
    assert mesh._mesh.size == 4 and one._mesh is None
    assert torch.equal(mesh._flat_params, one._flat_params)


@pytest.mark.parametrize("setting", ["AS", "AS-q8"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_mesh_kill_and_resume_bitwise(runs, tmp_path, engine, setting):
    full, fres = runs.port(setting, ENGINES[engine], "2x2")
    first = runs.engine(setting, ENGINES[engine], mesh_shape=(2, 2))
    first.run(2)
    first.save_snapshot(str(tmp_path))
    again = runs.engine(setting, ENGINES[engine], mesh_shape=(2, 2))
    assert again.load_snapshot(str(tmp_path)) == 2
    res = again.run(ROUNDS)
    assert torch.equal(again._flat_params, full._flat_params)
    assert [dataclasses.asdict(r) for r in res.metrics.records] == \
        [dataclasses.asdict(r) for r in fres.metrics.records]
    assert (again.tx_bytes, again.rx_bytes, res.staleness_hist) == \
        (full.tx_bytes, full.rx_bytes, fres.staleness_hist)


@pytest.mark.parametrize("setting", ["AS", "SS"])
def test_lanes_on_several_devices(runs, monkeypatch, setting):
    """Lanes grouped by shard instead of device (so each shard's lanes run
    as a wave of their own and come back in lane order): bitwise the
    one-call wave with ``map`` lanes."""
    one = runs.engine(setting, True, mesh_shape=(2, 2), wave_impl="map")
    one.run(ROUNDS)
    calls = []

    def by_shard(mesh, shards):
        groups = {}
        for lane, s in enumerate(shards):
            groups.setdefault(s, []).append(lane)
        calls.append(len(groups))
        return [(mesh.devices[s], lanes) for s, lanes in groups.items()]

    monkeypatch.setattr(tsafl.shflat, "lane_groups", by_shard)
    split = runs.engine(setting, True, mesh_shape=(2, 2), wave_impl="map")
    split.run(ROUNDS)
    assert max(calls) > 1
    assert torch.equal(split._flat_params, one._flat_params)
    assert split.tx_bytes == one.tx_bytes
