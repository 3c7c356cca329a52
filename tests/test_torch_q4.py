"""The packed-int4 (q4) wire in the port against the reference, on the CPU:
the stochastic-rounding quantizer, the nibble packing and the codec's
emit programs (bitwise), the packed buffer, the server in all six modes
through both channels, and the engine in SS/SA/AS/AA, sdga and fedasync
with ``wire="q4"`` against the reference's sequential engine.

Tolerances.  Packed bytes, scales and error-feedback residuals: bitwise
(the same f32 input and the same (seed, client, counter) key give the
same row); the reference codec runs under ``jax.jit``, as its engine runs
it (XLA turns ``absmax / 7`` into ``absmax * f32(1/7)`` there, which
differs from the eager division in the last ulp of about half of all
scales).  Server: ``rtol=1e-5, atol=1e-5`` against the reference (the
reference's q4 mean folds 1/sum(w) into each row's coefficient, the port
divides the sum, as on q8), the port's two channels bitwise.  Engine:
bytes, staleness, participation and simulated time exact, accuracy
within 2 test samples, params within q8's bounds: 2e-2 of the run's own
movement (the reference's), and 1e-3 for gradient targets with error
feedback.  An ulp of difference in a weight moves a lane to the next
int4 level only where its draw sits on the boundary; the runs here read
at most 6.2e-7 of their movement.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import flatbuf as tflatbuf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from test_torch_modes import (KW, MODES, N_TEST, SLR,  # noqa: E402
                              assert_host_exact, assert_same_summary,
                              check_server_both_channels, fl_sim_pair,
                              flat_reference, run_pair, setup)  # noqa: F401
from test_torch_q8 import _codecs, _jt, _trees, _tt  # noqa: E402

KEYS = [(0, 0, 0), (7, 3, 5), (2 ** 31 - 1, 15, 250)]


def _draws(shape, seed=0, cid=0, counter=0):
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), cid), counter)
    return prng.uniform(key, shape)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype == np.int8 else np.uint32)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 300.0])
def test_quantize_q4_ref_matches_jitted_reference_bitwise(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 1000)
    x = (rng.normal(size=(60, 512)) * scale).astype(np.float32)
    x[3] = 0.0  # an all-zero block takes the 1e-12 floor
    x[5, ::7] = np.float32(7.0) * np.float32(scale)  # lanes on the grid
    u = _draws(x.shape, seed=int(scale * 10) % 97)
    u[7] = 0.0  # draws at the ends of [0, 1)
    u[8] = np.float32(1.0) - np.float32(2.0 ** -24)
    qj, sj = jax.jit(jref.quantize_q4_ref)(jnp.asarray(x), jnp.asarray(u))
    qt, st = tref.quantize_q4_ref(torch.from_numpy(x), torch.from_numpy(u))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    assert qt.abs().max() <= 7


def test_eager_reference_scale_differs_from_the_jitted_one():
    """Why the port follows the jitted codec: the eager oracle divides
    absmax by 7, the jitted one multiplies by f32(1/7)."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2000, 64)).astype(np.float32))
    u = jnp.asarray(_draws((2000, 64)))
    _, se = jref.quantize_q4_ref(x, u)
    _, sj = jax.jit(jref.quantize_q4_ref)(x, u)
    _, st = tref.quantize_q4_ref(torch.from_numpy(np.array(x)),
                                 torch.from_numpy(np.array(u)))
    assert (np.asarray(se) != np.asarray(sj)).sum() > 100
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


def test_pack_unpack_roundtrip_and_minus_eight():
    """Every nibble pair, -8 (which a 0x55-flipped byte can hold) among
    them: packing equals the reference's, unpacking inverts it, and every
    byte unpacks as the reference unpacks it."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    q = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(2, -1)
    q = q.astype(np.int8)
    p = tref.pack_q4_ref(torch.from_numpy(q))
    assert p.shape == (2, q.shape[1] // 2) and p.dtype == torch.int8
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(jref.pack_q4_ref(q)))
    np.testing.assert_array_equal(tref.unpack_q4_ref(p).numpy(), q)
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    np.testing.assert_array_equal(
        tref.unpack_q4_ref(torch.from_numpy(every_byte)).numpy(),
        np.asarray(jref.unpack_q4_ref(every_byte)))
    assert (tref.unpack_q4_ref(torch.from_numpy(every_byte)) == -8).any()


@pytest.mark.parametrize("qblock", [64, 512])
def test_codec_q4_programs_match_reference_bitwise(qblock):
    start, end = _trees(qblock + 1)
    jc, tc = _codecs(start, qblock)
    res = (np.random.default_rng(2).normal(size=jc.dq) * 1e-3).astype(
        np.float32)
    jres, tres = jnp.asarray(res), torch.from_numpy(res)
    for key in KEYS:
        cases = [
            (jc.ravel_delta_q4(_jt(start), _jt(end), 0.05, jres, *key),
             tc.ravel_delta_q4(_tt(start), _tt(end), 0.05, tres, *key)),
            (jc.ravel_delta_q4_nores(_jt(start), _jt(end), 0.05, *key),
             tc.ravel_delta_q4_nores(_tt(start), _tt(end), 0.05, *key)),
            (jc.ravel_q4_nores(_jt(end), *key),
             tc.ravel_q4_nores(_tt(end), *key)),
            (jc.ravel_q4(_jt(end), jres, *key),
             tc.ravel_q4(_tt(end), tres, *key)),
        ]
        for want, got in cases:
            assert len(want) == len(got)
            assert tuple(got[0].shape) == (tc.dq // 2,)
            for a, b in zip(want, got):
                assert b.dtype == {np.int8: torch.int8,
                                   np.float32: torch.float32}[
                                       np.asarray(a).dtype.type]
                np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
    # error feedback: what the wire dropped is carried, to an f32 rounding
    p, s, new_res = tc.ravel_delta_q4(_tt(start), _tt(end), 0.05, tres,
                                      *KEYS[1])
    x = torch.nn.functional.pad(tc.ravel_delta(_tt(start), _tt(end), 0.05),
                                (0, tc.dq - tc.d)) + tres
    deq = tref.dequant_q4_flat_ref(p, s, qblock)
    np.testing.assert_allclose((deq + new_res).numpy(), x.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_codec_q4_draws_are_keyed_and_made_in_torch(monkeypatch):
    """The same key gives the same row, another counter another one, and
    no (n_qblocks, qblock) draw goes through the numpy twin."""
    start, end = _trees(3)
    _, tc = _codecs(start, 64)

    def numpy_draw(*a, **kw):
        raise AssertionError("q4 draws made on the host")

    monkeypatch.setattr(prng, "uniform", numpy_draw)
    a = tc.ravel_q4_nores(_tt(end), 5, 2, 0)
    b = tc.ravel_q4_nores(_tt(end), 5, 2, 0)
    c = tc.ravel_q4_nores(_tt(end), 5, 2, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert torch.equal(a[1], c[1])  # the scales do not depend on draws


def test_quant_buffer_packed_layout_matches_reference():
    jb = jflatbuf.QuantBuffer(3, 1100, 512, packed=True)
    tb = tflatbuf.QuantBuffer(3, 1100, 512, device="cpu", packed=True)
    assert (tb.dq, tb.n_qblocks, tb.packed) == (jb.dq, jb.n_qblocks, True)
    for a, b in zip(tb.views, jb.views):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == \
            {jnp.int8: torch.int8, jnp.float32: torch.float32}[b.dtype.type]
        assert not a.any()
    assert tuple(tb.q.shape) == (3, tb.dq // 2)
    p = torch.arange(tb.dq // 2, dtype=torch.int64).remainder(256).sub(
        128).to(torch.int8)
    s = torch.linspace(0.1, 1.0, tb.n_qblocks)
    tb.write(p, s, 2)
    assert torch.equal(tb.q[2], p) and torch.equal(tb.scales[2], s)
    assert not tb.q[:2].any() and not tb.scales[:2].any()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_server_q4_matches_reference_both_channels(mode):
    """Two rounds through each channel of the port's and the reference's
    ``FlatServer(wire="q4")``: to ``rtol=1e-5, atol=1e-5``, and the
    port's channels bitwise."""
    check_server_both_channels(mode, "q4")


def test_server_q4_width_traffic_and_fedasync_oracle():
    d, k, qb = 3001, 4, 512
    srv = tagg.FlatServer("fedasync", d, server_lr=1.0, wire="q4",
                          qblock=qb, device="cpu")
    dq = -(-d // qb) * qb
    assert srv.bank_width == dq
    assert srv.traffic["cross_edge_bytes"] == 4 * dq + 4
    rng = np.random.default_rng(4)
    x = np.zeros((k, dq), np.float32)
    x[:, :d] = rng.normal(size=(k, d))
    q, s = tref.quantize_q4_ref(torch.from_numpy(x.reshape(-1, qb)),
                                torch.from_numpy(_draws((k * dq // qb, qb))))
    qp, s = tref.pack_q4_ref(q.reshape(k, dq)), s.reshape(k, -1)
    rates = np.float32([0.6, 0.3, 0.45, 0.2])
    params = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    new, _, m = srv.step(params, (qp, s), rates, {})
    plain, pmass = tref.fedasync_rates_flat_q4_ref(qp, s, rates, params, qb)
    want, wmass = jref.fedasync_rates_flat_q4_ref(
        jnp.asarray(qp.numpy()), jnp.asarray(s.numpy()), jnp.asarray(rates),
        jnp.asarray(params.numpy()), qb)
    assert torch.equal(new, plain)
    np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(m["weight_sum"]) == float(pmass) == float(wmass)


# ---------------------------------------------------------------------------
# the engine, against the reference's sequential engine
# ---------------------------------------------------------------------------


def _assert_q4_params_close(teng, jres, p_j, ef=True):
    ref = flat_reference(jres)
    p0 = np.concatenate([np.asarray(p_j[k]).ravel() for k in sorted(p_j)])
    rel = np.linalg.norm(teng._flat_params.numpy() - ref) / \
        np.linalg.norm(ref - p0)
    assert rel <= 2e-2, rel
    if ef:
        assert rel <= 1e-3, rel


@pytest.mark.parametrize("setting", ["SS", "SA", "AS", "AA"])
def test_engine_q4_matches_reference(setup, setting):
    jeng, jres, teng, tres = run_pair(setup, setting, wire="q4")
    assert_host_exact(jeng, jres, teng, tres)
    assert teng._sr_counter == jeng._sr_counter
    fedsgd = teng.cfg.aggregation == "fedsgd"
    assert bool(teng._residuals) == fedsgd
    _assert_q4_params_close(teng, jres, setup[2], ef=fedsgd)


@pytest.mark.parametrize("setting,agg", [("SS", "sdga"), ("AS", "fedasync"),
                                         ("AS", "fedopt"), ("AS", "sdga")])
def test_engine_q4_new_modes_match_reference(setup, setting, agg):
    jeng, jres, teng, tres = run_pair(setup, setting, wire="q4",
                                      aggregation=agg)
    assert_host_exact(jeng, jres, teng, tres)
    _assert_q4_params_close(teng, jres, setup[2], ef=agg != "fedasync")


def test_engine_q4_without_error_feedback_matches_reference(setup):
    jeng, jres, teng, tres = run_pair(setup, "AS", wire="q4",
                                      error_feedback=False)
    assert_host_exact(jeng, jres, teng, tres)
    assert not teng._residuals
    _assert_q4_params_close(teng, jres, setup[2], ef=False)


def _engine(setup, setting, **kw):
    shards, te, p_j, _ = setup
    agg = kw.get("aggregation", tpaper.MODES[setting].aggregation)
    cfg = dataclasses.replace(tpaper.MODES[setting], batch_clients=False,
                              server_lr=SLR.get(agg, 1.0), **KW, **kw)
    return TEngine(cfg, tcnn.cnn_apply, "image",
                   params_from_jax(jax.tree_util.tree_map(np.asarray, p_j),
                                   "cpu"), {}, shards, te.x[:N_TEST],
                   te.y[:N_TEST], device="cpu")


@pytest.mark.parametrize("agg", MODES)
def test_engine_q4_channels_bitwise(setup, agg):
    """AS on q4: the streaming channel equals the buffered one bit for
    bit in every mode."""
    flats = []
    for channel in ("streaming", "buffered"):
        eng = _engine(setup, "AS", wire="q4", aggregation=agg,
                      server_channel=channel)
        eng.run(3)
        flats.append(eng._flat_params)
        assert eng._server.wire == "q4"
    assert torch.equal(flats[0], flats[1])


def test_engine_q4_upload_costs_an_eighth_of_f32(setup):
    e32, e4 = _engine(setup, "AS"), _engine(setup, "AS", wire="q4")
    ratio = e32._upload_nbytes() / e4._upload_nbytes()
    assert 7.0 < ratio < 8.0, ratio


@pytest.mark.parametrize("mode,agg", [("sync", "sdga"),
                                      ("semi_async", "fedsgd")])
def test_fl_sim_q4_summary_matches_reference(tmp_path, monkeypatch, capsys,
                                             mode, agg):
    j, t = fl_sim_pair(tmp_path, monkeypatch, capsys,
                       ["--rounds", "2", "--samples", "240", "--clients",
                        "5", "--k", "2", "--mode", mode, "--aggregation",
                        agg, "--wire", "q4"])
    assert_same_summary(j, t)
