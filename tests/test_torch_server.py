"""repro_torch's FlatServer against repro's (xla backend,
``external_discount=True``, as the engine builds it), for fedsgd/fedavg.

Tolerance against the reference: ``rtol=1e-5, atol=1e-5`` (the K-way sum
runs in another order).  The port's streaming channel (folds + finalize)
must equal its buffered channel (one aggregate) bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.flatbuf import AccumBuffer, alloc_buffer, write_slot  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D = 3001
MODES = ["fedsgd", "fedavg"]


def _case(k, mode, seed=0):
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(k, D)).astype(np.float32)
    params = rng.normal(size=(D,)).astype(np.float32)
    if mode == "fedavg":
        w = rng.integers(5, 200, k).astype(np.float32)  # data sizes
    else:
        w = np.ones(k, np.float32)
    return buf, params, w


def _servers(mode):
    j = jagg.FlatServer(mode, D, server_lr=0.05, backend="xla",
                        external_discount=True, fedasync_rates=True)
    t = tagg.FlatServer(mode, D, server_lr=0.05, device="cpu")
    return j, t


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_step_matches_reference(mode, k):
    buf, params, w = _case(k, mode, seed=k)
    js, ts = _servers(mode)
    jnew, _, jm = js.step(jnp.asarray(params), jnp.asarray(buf),
                          jnp.asarray(w), js.init_opt(jnp.asarray(params)))
    tnew, opt, tm = ts.step(torch.from_numpy(params), torch.from_numpy(buf),
                            w, ts.init_opt(None))
    assert opt == {}
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), **TOL)
    np.testing.assert_allclose(float(tm["update_norm"]),
                               float(jm["update_norm"]), rtol=1e-5)
    assert float(tm["weight_sum"]) == float(jm["weight_sum"])


@pytest.mark.parametrize("mode", MODES)
def test_streaming_matches_reference_and_buffered_bitwise(mode):
    k = 4
    buf, params, w = _case(k, mode, seed=7)
    js, ts = _servers(mode)
    # reference streaming channel
    bank = jnp.zeros((1, D), jnp.float32)
    for i in range(k):
        bank = js.fold_program(bank, jnp.asarray(buf[i]), jnp.int32(0),
                               jnp.float32(w[i]), jnp.float32(1.0))
    jnew, _, _, jzero = js.finalize(jnp.asarray(params), bank, w, {})
    # port streaming channel, through the AccumBuffer the engine uses
    acc = AccumBuffer(D, ts.fold_program, "cpu")
    for i in range(k):
        acc.fold((torch.from_numpy(buf[i]),), w=w[i])
    tbank, wvec, stats = acc.seal()
    np.testing.assert_array_equal(wvec, w)
    assert (stats["count"], stats["pprod"]) == (k, np.float32(1.0))
    p0 = torch.from_numpy(params)
    snew, _, sm, zeroed = ts.finalize(p0, tbank, wvec, {})
    assert float(zeroed.abs().sum()) == 0.0
    acc.release(zeroed)
    np.testing.assert_allclose(snew.numpy(), np.asarray(jnew), **TOL)
    # port buffered channel: bitwise equal to the streaming one
    rows = alloc_buffer(k, D, "cpu")
    for i in range(k):
        write_slot(rows, torch.from_numpy(buf[i]), i)
    bnew, _, bm = ts.step(p0, rows, w, {})
    assert torch.equal(snew, bnew)
    assert float(sm["weight_sum"]) == float(bm["weight_sum"])


def test_traffic_and_staleness_poly_match_reference():
    js, ts = _servers("fedsgd")
    assert {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in ts.traffic.items()} == \
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in js.traffic.items()}
    tau = np.array([0, 1, 2, 5, 17], np.int32)
    np.testing.assert_allclose(
        tagg.staleness_poly(torch.from_numpy(tau), 0.5).numpy(),
        np.asarray(jagg.staleness_poly(jnp.asarray(tau), 0.5)), rtol=1e-6)


def test_unported_modes_raise():
    """Every aggregation mode and wire is ported; the topk wire refuses
    the modes that upload weights (fedavg, fedasync), and an unknown mode
    is refused."""
    for mode in ("fedavg", "fedasync"):
        with pytest.raises(ValueError, match="gradient-only"):
            tagg.FlatServer(mode, D, server_lr=0.1, wire="topk",
                            device="cpu")
    with pytest.raises(ValueError):
        tagg.FlatServer("median", D, server_lr=0.1, device="cpu")


def test_sum_in_order_is_sequential():
    w = np.float32([1e8, 1.0, -1e8, 1.0] * 3)
    s = np.float32(0.0)
    for x in w:
        s = np.float32(s + x)
    assert tagg.sum_in_order(w) == s
