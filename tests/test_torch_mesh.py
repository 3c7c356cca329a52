"""The port's meshes (``repro_torch.sharding.flat``) and the mesh's server
round against the reference, on the CPU.

The reference's own mesh cannot be built here (its ``shard_map`` call
takes an argument the installed JAX dropped), so the port is held to what
runs: the host oracle ``ref.xor_tree_sum_ref``, ``edge_traffic``, and the
single-device ``FlatServer`` built as its engine builds it
(``external_discount=True, fedasync_rates=True``), at the tolerances of
the reference's own mesh tests (server: params and slow state within
``atol=rtol=2e-5``, ``update_norm`` within ``rel=1e-3``).

  * the tree: a (E, P) mesh's reduction is bitwise the XOR oracle of
    each edge's partials, the edges then in order, for P in 1, 2, 4, 8;
    the 1-D mesh adds in shard order; the host masses follow the same
    tree;
  * ``edge_traffic`` key for key the reference's, for bare shapes and a
    live mesh;
  * ``FlatServer`` on (2, 2), (1, 4) and ``devices=2`` in every mode x
    wire (top-k: the gradient modes), K = 8, D = 5000, against the
    reference's single-device server; ``mesh_shape=(1, P)`` bitwise
    ``devices=P``; the mesh's streaming channel (folds into the shard
    that holds each slot's row, finalize) bitwise its buffered one
    (:class:`repro_torch.core.flatbuf.MeshRows`, one ``sum`` partial a
    shard);
  * ``fl_sim --device cpu --mesh 2 2`` end to end: its ``traffic`` the
    reference's ``edge_traffic((2, 2), ...)``, its bytes, staleness and
    scheduler stats the single-device run's; ``--device cuda --devices
    2`` raises on a host without two GPUs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.sharding import flat as jflat  # noqa: E402
from repro_torch.core import flatbuf  # noqa: E402
from repro_torch.core.aggregation import FlatServer, podwise_aggregate, weighted_mean  # noqa: E402
from repro_torch.launch import fl_sim as tfl_sim  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.obs.export import to_native  # noqa: E402
from repro_torch.sharding import flat  # noqa: E402

MODES = ("fedsgd", "fedavg", "fedbuff", "fedopt", "sdga", "fedasync")
WIRES = ("f32", "q8", "q4", "topk")
CASES = [(m, w) for w in WIRES for m in MODES
         if not (w == "topk" and m in ("fedavg", "fedasync"))]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "devices2": 2}
K, D, SLR = 8, 5000, 0.3
QB = {"f32": 512, "q8": 512, "q4": 512, "topk": 64}
NK = 512
TOL = dict(atol=2e-5, rtol=2e-5)


def _mesh(spec):
    if isinstance(spec, tuple):
        return flat.make_hier_mesh(*spec, devices="cpu")
    return flat.make_pod_mesh(spec, devices="cpu")


# ------------------------------ the tree ------------------------------


@pytest.mark.parametrize("pods", [1, 2, 4, 8])
@pytest.mark.parametrize("edges", [2, 3])
def test_tree_is_the_xor_oracle_bitwise(edges, pods):
    rng = np.random.default_rng(edges * 10 + pods)
    parts = (0.1 * rng.normal(size=(edges * pods, 257))).astype(np.float32)
    mesh = flat.make_hier_mesh(edges, pods, devices="cpu")
    got = flat.mesh_reduce(mesh, [torch.from_numpy(p) for p in parts])
    edge = [np.asarray(jref.xor_tree_sum_ref(
        [jnp.asarray(p) for p in parts[e * pods:(e + 1) * pods]]))
        for e in range(edges)]
    want = edge[0]
    for e in edge[1:]:
        want = want + e
    np.testing.assert_array_equal(got.numpy(), want)
    # the weight masses: host np.float32 through the same tree
    masses = [np.float32(x) for x in rng.uniform(0, 3, edges * pods)]
    medge = [np.float32(np.asarray(jref.xor_tree_sum_ref(
        [jnp.float32(m) for m in masses[e * pods:(e + 1) * pods]])))
        for e in range(edges)]
    mwant = medge[0]
    for m in medge[1:]:
        mwant = np.float32(mwant + m)
    assert flat.mesh_reduce(mesh, masses) == mwant


@pytest.mark.parametrize("n", [2, 3, 4])
def test_pod_mesh_adds_in_shard_order(n):
    rng = np.random.default_rng(n)
    parts = (0.1 * rng.normal(size=(n, 301))).astype(np.float32)
    got = flat.mesh_reduce(flat.make_pod_mesh(n, devices="cpu"),
                           [torch.from_numpy(p) for p in parts])
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    np.testing.assert_array_equal(got.numpy(), want)


def test_mesh_construction():
    m = flat.make_hier_mesh(2, 4, devices="cpu")
    assert m.axis_names == ("edge", "pod")
    assert flat.is_hier(m) and flat.mesh_shape(m) == (2, 4)
    assert flat.mesh_size(m) == 8 and m.home == torch.device("cpu")
    alias = flat.make_hier_mesh(1, 4, devices="cpu")
    assert alias.axis_names == ("pod",) and not flat.is_hier(alias)
    assert flat.mesh_shape(None) == (1, 1) and flat.mesh_size(None) == 1
    devs = [torch.device("cpu")] * 3
    assert flat.make_pod_mesh(2, devices=devs).devices == tuple(devs[:2])
    with pytest.raises(ValueError):  # pods must be a power of two
        flat.make_hier_mesh(1, 3, devices="cpu")
    with pytest.raises(ValueError):  # more shards than listed devices
        flat.make_pod_mesh(4, devices=devs)
    with pytest.raises(ValueError):  # N shards on one named device
        flat.make_pod_mesh(2, devices="meta")
    assert flat.mesh_shape(tmesh.make_hier_mesh(2, 2, "cpu")) == (2, 2)
    assert flat.mesh_size(tmesh.make_pod_mesh(3, "cpu")) == 3


def test_cuda_mesh_needs_its_gpus():
    """The default pool is the first N visible GPUs; fewer raises."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are visible: the CUDA mesh builds")
    with pytest.raises(RuntimeError):
        flat.make_pod_mesh(2)
    with pytest.raises(RuntimeError):
        flat.make_hier_mesh(2, 2, devices="cuda")


def test_cross_edge_roofline():
    assert tmesh.cross_edge_time_s(tmesh.NVLINK_BW) == pytest.approx(1.0)
    assert tmesh.cross_edge_time_s(1000, link_bw=500.0) == \
        pytest.approx(2.0)


# ----------------------------- traffic model -----------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4),
                                   (4, 2)])
def test_edge_traffic_is_the_reference(shape):
    for nbytes in (1000, 4 * 2_154_730):
        assert flat.edge_traffic(shape, nbytes) == \
            jflat.edge_traffic(shape, nbytes)


@pytest.mark.parametrize("spec", [(2, 2), (2, 4), (1, 4), 2, None])
def test_edge_traffic_of_a_live_mesh(spec):
    mesh = None if spec is None else _mesh(spec)
    shape = (1, 1) if spec is None else (spec if isinstance(spec, tuple)
                                          else (1, spec))
    got = flat.edge_traffic(mesh, 20_000)
    assert got == jflat.edge_traffic(shape, 20_000)
    assert got["cross_edge_reduction"] == (float(shape[1])
                                           if shape[0] > 1 else 1.0)


# ------------------------------- the server -------------------------------


def _weights(mode, rng):
    tau = rng.integers(0, 5, K).astype(np.float32)
    if mode == "fedavg":
        return (rng.uniform(size=K) * 100 + 1).astype(np.float32)
    if mode == "fedsgd":
        return np.ones(K, np.float32)
    if mode == "fedasync":  # the raw mix rates a_i
        return np.asarray(0.6 * np.power(tau + 1, -np.float32(0.5)),
                          np.float32)
    return np.asarray(np.power(tau + 1, -np.float32(0.5)), np.float32)


def _payload(wire, rng):
    """(reference payload as jax arrays, the same as numpy arrays)."""
    buf = (0.1 * rng.normal(size=(K, D))).astype(np.float32)
    qb = QB[wire]
    if wire == "f32":
        return jnp.asarray(buf), (buf,)
    if wire == "topk":
        idx = np.argsort(-np.abs(buf), axis=1, kind="stable")[:, :NK]
        vals = np.take_along_axis(buf, idx, axis=1)
        q, s = jax.vmap(jref.quantize_ref)(
            jnp.asarray(vals).reshape(K, -1, qb))
        out = (idx.astype(np.int32), np.asarray(q).reshape(K, NK),
               np.asarray(s))
        return tuple(jnp.asarray(a) for a in out), out
    dq = -(-D // qb) * qb
    x = np.pad(buf, ((0, 0), (0, dq - D))).reshape(K, dq // qb, qb)
    if wire == "q8":
        q, s = jax.vmap(jref.quantize_ref)(jnp.asarray(x))
        out = (np.asarray(q).reshape(K, dq), np.asarray(s))
    else:
        u = rng.uniform(size=x.shape).astype(np.float32)
        q, s = jax.vmap(jref.quantize_q4_ref)(jnp.asarray(x),
                                              jnp.asarray(u))
        out = (np.asarray(jref.pack_q4_ref(q.reshape(K, dq))),
               np.asarray(s))
    return tuple(jnp.asarray(a) for a in out), out


def _case(mode, wire):
    rng = np.random.default_rng(MODES.index(mode) * 7 + WIRES.index(wire))
    jpay, npay = _payload(wire, rng)
    npay = tuple(np.array(a) for a in npay)  # writable copies for torch
    params = rng.normal(size=(D,)).astype(np.float32)
    return jpay, npay, params, _weights(mode, rng)


def _port_server(mode, wire, mesh):
    return FlatServer(mode, D, server_lr=SLR, wire=wire, qblock=QB[wire],
                      device="cpu", mesh=mesh)


_REF = {}


def _reference(mode, wire):
    """The reference's single-device round of the case, made once."""
    if (mode, wire) not in _REF:
        jpay, _, params, w = _case(mode, wire)
        js = jagg.FlatServer(mode, D, server_lr=SLR, alpha=0.5,
                             momentum=0.8, ema_anchor=0.05, wire=wire,
                             qblock=QB[wire], backend="xla",
                             external_discount=True, fedasync_rates=True)
        p = jnp.asarray(params)
        new, opt, m = js.step(p, jpay, jnp.asarray(w), js.init_opt(p))
        _REF[mode, wire] = (np.asarray(new), jax.tree_util.tree_map(
            np.asarray, opt), float(m["update_norm"]), js.traffic)
    return _REF[mode, wire]


def _mesh_step(mode, wire, mesh):
    _, npay, params, w = _case(mode, wire)
    srv = _port_server(mode, wire, mesh)
    rows = tuple(torch.from_numpy(a) for a in npay)
    rows = rows[0] if wire == "f32" else rows
    p = torch.from_numpy(params)
    new, opt, m = srv.step(p, flat.shard_rows(rows, mesh), w,
                           srv.init_opt(p))
    return srv, new, opt, m


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode,wire", CASES)
def test_mesh_server_matches_single_device_reference(mode, wire, mesh_name):
    mesh = _mesh(MESHES[mesh_name])
    want, jopt, jnorm, jtraffic = _reference(mode, wire)
    srv, new, opt, m = _mesh_step(mode, wire, mesh)
    np.testing.assert_allclose(new.numpy(), want, **TOL)
    assert float(m["update_norm"]) == pytest.approx(jnorm, rel=1e-3,
                                                    abs=1e-6)
    assert sorted(opt) == sorted(jopt)
    for key in opt:
        if key == "step":
            assert opt[key] == int(jopt[key])
        else:
            np.testing.assert_allclose(opt[key].numpy(), jopt[key], **TOL)
    shape = flat.mesh_shape(mesh)
    assert srv.traffic == jflat.edge_traffic(
        shape, jtraffic["cross_edge_bytes"] - 4)
    if mode != "fedasync":
        assert srv.traffic["cross_edge_reduction"] == (
            2.0 if shape == (2, 2) else 1.0)


@pytest.mark.parametrize("mode,wire", CASES)
def test_alias_mesh_is_bitwise_the_pod_mesh(mode, wire):
    _, a, _, _ = _mesh_step(mode, wire, flat.make_hier_mesh(1, 4, "cpu"))
    _, b, _, _ = _mesh_step(mode, wire, flat.make_pod_mesh(4, "cpu"))
    assert torch.equal(a, b)


@pytest.mark.parametrize("mesh_name", ["2x2", "devices2"])
@pytest.mark.parametrize("mode,wire", CASES)
def test_mesh_streaming_is_bitwise_the_buffered(mode, wire, mesh_name):
    """Two rounds (the slow state carried): each upload folded into the
    bank of the shard whose block holds its slot, against MeshRows and
    one ``sum`` partial a shard; params and opt bitwise."""
    mesh = _mesh(MESHES[mesh_name])
    _, npay, params, w = _case(mode, wire)
    srv = _port_server(mode, wire, mesh)
    per = K // mesh.size
    p = torch.from_numpy(params)
    ps, pb = p, p
    os_, ob = srv.init_opt(p), srv.init_opt(p)
    for rnd in range(2):
        rows = tuple(torch.from_numpy(a) for a in npay)
        if rnd:
            rows = tuple(r.flip(0) for r in rows)
        acc = flatbuf.AccumBuffer(srv.bank_width, srv.fold_program, "cpu",
                                  mesh=mesh)
        if wire == "topk":
            make = (lambda k, on: flatbuf.TopkBuffer(k, D, NK, QB[wire],
                                                     device=on))
        elif wire == "f32":
            make = (lambda k, on: flatbuf.RowBuffer(k, D, device=on))
        else:
            make = (lambda k, on: flatbuf.QuantBuffer(
                k, D, QB[wire], device=on, packed=wire == "q4"))
        buf = flatbuf.MeshRows(make, K, mesh)
        for i in range(K):
            pl = tuple(a[i] for a in rows)
            beta = np.float32(1.0) - w[i] if mode == "fedasync" else 1.0
            acc.fold(pl, w=w[i], beta=beta,
                     shard=0 if mode == "fedasync" else i // per)
            buf.write(*pl, i)
        bank, wvec, stats = acc.seal()
        ps, os_, _, zeroed = srv.finalize(ps, bank, wvec, os_,
                                          pprod=stats["pprod"])
        acc.release(zeroed)
        pb, ob, _ = srv.step(pb, buf.views, w, ob)
    assert torch.equal(ps, pb)
    for key in ob:
        assert (os_[key] == ob[key] if key == "step"
                else torch.equal(os_[key], ob[key]))


def test_mesh_rows_write_rows_and_set_rows():
    """A wave's scatter across the shards' buffers (slots past K dropped)
    and a whole round's rows, against the single-device buffer."""
    mesh = flat.make_hier_mesh(2, 2, "cpu")
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    slots = [5, 0, 9, 3, 7, 2]
    single = flatbuf.RowBuffer(8, 40, device="cpu")
    single.write_rows(rows, slots)
    meshed = flatbuf.MeshRows(
        lambda k, on: flatbuf.RowBuffer(k, 40, device=on), 8, mesh)
    meshed.write_rows(rows, slots)
    assert torch.equal(torch.cat(meshed.views), single.views)
    q = torch.from_numpy(rng.integers(-127, 128, (8, 64), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(size=(8, 2)).astype(np.float32))
    qm = flatbuf.MeshRows(lambda k, on: flatbuf.QuantBuffer(
        k, 64, 32, device=on), 8, mesh)
    qm.set_rows(q, s)
    assert torch.equal(torch.cat([v[0] for v in qm.views]), q)
    assert torch.equal(torch.cat([v[1] for v in qm.views]), s)
    with pytest.raises(ValueError):
        flatbuf.MeshRows(lambda k, on: None, 6, mesh)


def test_podwise_aggregate_is_the_pytree_round():
    rng = np.random.default_rng(5)
    stacked = {"a": torch.from_numpy(rng.normal(size=(4, 3, 2))
                                     .astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=(4, 5))
                                     .astype(np.float32))}
    g = {"a": torch.zeros(3, 2), "b": torch.ones(5)}
    w = np.float32([1, 2, 3, 4])
    mean = podwise_aggregate(stacked, w, "params")
    for k in stacked:
        assert torch.equal(mean[k], weighted_mean(stacked, w)[k])
    new = podwise_aggregate(stacked, w, "grads", g, server_lr=0.5)
    for k in g:
        assert torch.equal(new[k], g[k] - 0.5 * mean[k])
    with pytest.raises(ValueError):
        podwise_aggregate(stacked, w, "grads")


# ------------------------------- the launcher -------------------------------

_ARGS = ["--rounds", "2", "--samples", "240", "--clients", "5", "--k", "4",
         "--device", "cpu"]


def test_fl_sim_mesh_end_to_end(tmp_path):
    """``--mesh 2 2`` on the CPU: the traffic record is the reference's
    for a (2, 2) mesh; bytes, staleness and the scheduler's stats are the
    single-device run's; ``--mesh 1 2`` is ``--devices 2``."""
    import json
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2", "2"]),
                        ("alias", ["--mesh", "1", "2"]),
                        ("pods", ["--devices", "2"])):
        path = tmp_path / f"{name}.json"
        tfl_sim.main([*_ARGS, *extra, "--json-out", str(path)])
        outs[name] = json.loads(path.read_text())
    d = (outs["single"]["traffic"]["cross_edge_bytes"] - 4) // 4
    assert outs["mesh"]["traffic"] == to_native(
        jflat.edge_traffic((2, 2), 4 * d))
    assert outs["pods"]["traffic"] == to_native(
        jflat.edge_traffic((1, 2), 4 * d))
    for key in ("tx_bytes", "rx_bytes", "rounds", "mean_staleness",
                "duration_s", "sched"):
        assert outs["mesh"][key] == outs["single"][key], key
    assert outs["alias"] == outs["pods"]


def test_fl_sim_cuda_mesh_raises_without_its_gpus():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are visible")
    with pytest.raises(RuntimeError):
        tfl_sim.main(["--rounds", "1", "--samples", "240", "--clients",
                      "4", "--k", "2", "--device", "cuda", "--devices",
                      "2"])
