"""The port's pytree-level server functions
(``repro_torch.core.aggregation``: ``fedsgd``, ``fedavg``,
``fedasync_mix``, ``fedbuff``, ``fedopt_adam``, ``sdga`` and
``ServerOptState``) against the reference's (``repro.core.aggregation``)
on nested trees, and against the port's ``FlatServer`` on the same rows
(the trees raveled by ``PytreeCodec``), on the CPU.

Nested trees of a conv weight (HWIO), biases, a dense weight and a
BatchNorm-like leaf, K = 4 stacked uploads, 3 server steps for the
stateful modes; everything within ``rtol=1e-5, atol=1e-6``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.flatbuf import PytreeCodec  # noqa: E402

K = 4
SHAPES = {"conv": {"w": (3, 3, 2, 4), "b": (4,)},
          "dense": {"w": (16, 5), "b": (5,)},
          "norm": {"scale": (4,)}}
STALENESS = [0, 2, 1, 5]
SIZES = [12, 40, 7, 25]
RTOL, ATOL = 1e-5, 1e-6


def _tree(rng, lead=(), scale=1.0):
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(lead + node)).astype(np.float32)
    return make(SHAPES)


def _to_torch(t):
    return tree.tree_map(torch.from_numpy, t) if t is not None else None


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    return np.asarray(t)


def _close(got, want):
    got, want = _to_np(tree.tree_map(lambda x: x.numpy(), got)), _to_np(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(p=_tree(rng), g=_tree(rng, (K,), 0.1), c=_tree(rng, (K,)),
                w=rng.uniform(0.2, 1.5, K).astype(np.float32))


def _flat(codec, t):
    return codec.ravel(_to_torch(t))


def _rows(codec, stacked):
    return torch.stack([codec.ravel(_to_torch(jax.tree_util.tree_map(
        lambda x, i=i: x[i], stacked))) for i in range(K)])


# ------------------------- against the reference -------------------------


def test_fedsgd_and_fedavg(data):
    _close(tagg.fedsgd(_to_torch(data["p"]), _to_torch(data["g"]),
                       data["w"], 0.05),
           jagg.fedsgd(data["p"], data["g"], jnp.asarray(data["w"]), 0.05))
    _close(tagg.fedavg(_to_torch(data["c"]), SIZES),
           jagg.fedavg(data["c"], jnp.asarray(SIZES)))


def test_fedasync_mix_in_sequence(data):
    """K mixes in arrival order at each upload's rate (the fedasync
    coefficients' a_i)."""
    rates = np.float32(0.6) * np.power(
        np.float32(1.0) + np.asarray(STALENESS, np.float32),
        -np.float32(0.5))
    tp, jp = _to_torch(data["p"]), data["p"]
    for i, a in enumerate(rates):
        tp = tagg.fedasync_mix(
            tp, tree.tree_map(lambda x, i=i: x[i], _to_torch(data["c"])), a)
        jp = jagg.fedasync_mix(
            jp, jax.tree_util.tree_map(lambda x, i=i: x[i], data["c"]),
            jnp.float32(a))
    _close(tp, jp)


def test_fedbuff(data):
    _close(tagg.fedbuff(_to_torch(data["p"]), _to_torch(data["g"]),
                        STALENESS, 0.05),
           jagg.fedbuff(data["p"], data["g"], jnp.asarray(STALENESS), 0.05))


def test_fedopt_adam_three_steps(data):
    tp, jp = _to_torch(data["p"]), data["p"]
    topt, jopt = tagg.ServerOptState(), jagg.ServerOptState()
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x, s=step: x * (1.0 + 0.5 * s),
                                   data["g"])
        tp, topt = tagg.fedopt_adam(tp, _to_torch(g), data["w"], topt, 0.005)
        jp, jopt = jagg.fedopt_adam(jp, g, jnp.asarray(data["w"]), jopt,
                                    0.005)
        _close(tp, jp)
        _close(topt.adam_m, jopt.adam_m)
        _close(topt.adam_v, jopt.adam_v)
        assert topt.step == jopt.step == step + 1


def test_sdga_three_steps(data):
    tp, jp = _to_torch(data["p"]), data["p"]
    topt, jopt = tagg.ServerOptState(), jagg.ServerOptState()
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x, s=step: x * (1.0 - 0.3 * s),
                                   data["g"])
        tp, topt = tagg.sdga(tp, _to_torch(g), STALENESS, topt,
                             server_lr=0.05)
        jp, jopt = jagg.sdga(jp, g, jnp.asarray(STALENESS), jopt,
                             server_lr=0.05)
        _close(tp, jp)
        _close(topt.momentum, jopt.momentum)
        _close(topt.ema, jopt.ema)
        assert topt.step == jopt.step == step + 1


def test_server_opt_state_fields():
    assert [f.name for f in dataclasses.fields(tagg.ServerOptState)] == \
        [f.name for f in dataclasses.fields(jagg.ServerOptState)]
    assert tagg.ServerOptState().step == 0


# --------------------------- against FlatServer ---------------------------


def _server(mode, codec, **kw):
    return tagg.FlatServer(mode, codec.d, server_lr=kw.pop("lr", 0.05),
                           device="cpu", **kw)


@pytest.mark.parametrize("mode", ["fedsgd", "fedbuff", "fedavg",
                                  "fedasync"])
def test_flat_server_same_rows(data, mode):
    """One buffered step of FlatServer over the raveled rows against the
    pytree function, raveled; FlatServer takes the final weights (the
    discount applied at ingest)."""
    codec = PytreeCodec(_to_torch(data["p"]))
    p = _flat(codec, data["p"])
    tp = _to_torch(data["p"])
    if mode == "fedsgd":
        buf, w = _rows(codec, data["g"]), data["w"]
        want = tagg.fedsgd(tp, _to_torch(data["g"]), w, 0.05)
    elif mode == "fedbuff":
        buf = _rows(codec, data["g"])
        w = tagg._poly_host(STALENESS, 0.5)
        want = tagg.fedbuff(tp, _to_torch(data["g"]), STALENESS, 0.05)
    elif mode == "fedavg":
        buf, w = _rows(codec, data["c"]), np.asarray(SIZES, np.float32)
        want = tagg.fedavg(_to_torch(data["c"]), SIZES)
    else:
        buf = _rows(codec, data["c"])
        w = np.float32(0.6) * tagg._poly_host(STALENESS, 0.5)
        want = tp
        for i, a in enumerate(w):
            want = tagg.fedasync_mix(want, tree.tree_map(
                lambda x, i=i: x[i], _to_torch(data["c"])), a)
    srv = _server(mode, codec)
    new, _, _ = srv.step(p, buf, w, srv.init_opt(p))
    np.testing.assert_allclose(new.numpy(), codec.ravel(want).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["fedopt", "sdga"])
def test_flat_server_stateful_modes(data, mode):
    """Three steps of FlatServer's fedopt / sdga against ``fedopt_adam``
    / ``sdga`` on the trees: params and the slow state."""
    codec = PytreeCodec(_to_torch(data["p"]))
    p = _flat(codec, data["p"])
    srv = _server(mode, codec, lr=0.005 if mode == "fedopt" else 0.05)
    opt = srv.init_opt(p)
    tp, topt = _to_torch(data["p"]), tagg.ServerOptState()
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x, s=step: x * (1.0 + 0.5 * s),
                                   data["g"])
        buf = _rows(codec, g)
        if mode == "fedopt":
            p, opt, _ = srv.step(p, buf, data["w"], opt)
            tp, topt = tagg.fedopt_adam(tp, _to_torch(g), data["w"], topt,
                                        0.005)
            slow = ((opt["m"], topt.adam_m), (opt["v"], topt.adam_v))
        else:
            p, opt, _ = srv.step(p, buf, tagg._poly_host(STALENESS, 0.5),
                                 opt)
            tp, topt = tagg.sdga(tp, _to_torch(g), STALENESS, topt,
                                 server_lr=0.05)
            slow = ((opt["momentum"], topt.momentum), (opt["ema"], topt.ema))
        np.testing.assert_allclose(p.numpy(), codec.ravel(tp).numpy(),
                                   rtol=RTOL, atol=ATOL)
        for flat_leaf, t in slow:
            np.testing.assert_allclose(flat_leaf.numpy(),
                                       codec.ravel(t).numpy(),
                                       rtol=RTOL, atol=ATOL)
        assert opt["step"] == topt.step == step + 1
