"""The q8 round's large-K int8-dot regime in the port against the
reference, on the CPU (``repro_torch.kernels.int8dot``,
``repro_torch.kernels.ref.int8dot_*``, ``FlatServer`` with
``REPRO_INT8_DOT=1``).

  * ``int8dot_coeff_scale`` and the plain ``weighted_sum_q8_int8dot``
    bitwise the reference's functions under ``jax.jit`` (the scale is
    ``absmax * f32(1/127)`` there, not ``absmax / 127``), at K = 32, 33,
    64 and an odd D, with and without a given coefficient scale; the
    plain version widens before its products (exact int32 sums where int8
    or int16 would wrap); K past the int32 headroom refused;
  * ``int8dot_auto`` case for case as the reference's
    (``tests/test_quantized_channel.py``), its gate closed with the
    variable unset;
  * the single device's round at K = 64 against the reference's
    ``FlatServer(..., backend="xla", external_discount=True,
    fedasync_rates=True)``: the mean (fedavg) bitwise, which needs the
    weight sum in the reference's jitted order (XLA's CPU backend sums
    64 weights as two windows of 32, :func:`flat.xla_sum`; a sequential
    f32 sum differs in the last bit); the other modes within
    ``rtol=atol=1e-6`` over two rounds (seen: 2.4e-7), since XLA fuses
    the steps' multiply-adds (``p0 - lr * g`` is one FMA in its program)
    where the port's step bodies round each op; ``update_norm`` within
    ``rel=1e-6``;
  * the (2, 2) and 4-shard mesh rounds bitwise an oracle built from the
    reference's pieces (each shard's ``int8dot_coeff_scale``, their max,
    each shard's ``weighted_sum_q8_int8dot_ref(coeff_scale=...)``,
    ``xor_tree_sum_ref`` / in-order sums, the step in eager ops), and
    within the reference's own mesh bound (``atol=rtol=2e-5``, at its
    tests' D) of the single device's round (the reference's mesh tests
    of the regime fail on this host on ``shard_map(check_rep=...)``; at
    the CNN's D a coefficient lands one level apart, which
    ``chip_smoke.py`` phase 10 holds in coefficient levels);
  * the regime off with the variable unset or ``0``, below K = 32, for
    fedasync and on the other wires; the engine's sync q8 rounds at K =
    64 take one int8-dot call a round with the variable set and none
    without.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.aggregation import FlatServer  # noqa: E402
from repro_torch.kernels import int8dot  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.sharding import flat  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

QB, SLR = 512, 0.3
#: an odd D: its last block is mostly padding
D = 5003
MODES = ("fedsgd", "fedbuff", "fedavg", "fedopt", "sdga")
KW = dict(server_lr=SLR, momentum=0.8, ema_anchor=0.05)
STEP_TOL = dict(rtol=1e-6, atol=1e-6)


def _rows(k, d=D, seed=0, qb=QB):
    """k rows quantized by the reference's jitted codec: (q int8 (k, Dq),
    scales (k, nb)) as numpy."""
    rng = np.random.default_rng(seed)
    dq = -(-d // qb) * qb
    x = np.zeros((k, dq), np.float32)
    x[:, :d] = 0.1 * rng.normal(size=(k, d))
    q, s = jax.jit(jax.vmap(jref.quantize_ref))(
        jnp.asarray(x.reshape(k, dq // qb, qb)))
    return np.array(q).reshape(k, dq), np.array(s)


def _weights(k, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=k) * 3 + 0.05).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------- the kernel's function -------------------------


@pytest.mark.parametrize("k", [32, 33, 64])
def test_coeff_scale_is_the_jitted_reference_bitwise(k):
    q, s = _rows(k, seed=k)
    w = _weights(k, seed=k)
    want = np.asarray(jax.jit(jref.int8dot_coeff_scale)(jnp.asarray(s),
                                                        jnp.asarray(w)))
    got = tref.int8dot_coeff_scale(_t(s), _t(w)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("k", [32, 33, 64])
def test_plain_is_the_jitted_reference_bitwise(k, given):
    """The wrapper on CPU tensors (its plain version) against
    ``weighted_sum_q8_int8dot_ref`` under ``jax.jit``; ``given`` passes a
    coefficient scale above the rows' own (a mesh's max over shards)."""
    q, s = _rows(k, seed=10 + k)
    w = _weights(k, seed=10 + k)
    cs = None
    if given:
        cs = np.asarray(jax.jit(jref.int8dot_coeff_scale)(
            jnp.asarray(s), jnp.asarray(w))) * np.float32(1.75)
    jfn = jax.jit(jref.weighted_sum_q8_int8dot_ref, static_argnums=3)
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), QB,
                          None if cs is None else jnp.asarray(cs)))
    before = int8dot.weighted_sum_q8_int8dot.launches
    got = int8dot.weighted_sum_q8_int8dot(
        _t(q), _t(s), _t(w), QB, None if cs is None else _t(cs))
    assert int8dot.weighted_sum_q8_int8dot.launches == before  # plain
    assert got.shape == (q.shape[1],) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the padding lanes of the last block hold level 0
    assert not got[D:].any()


def test_plain_widens_before_the_product():
    """Saturated rows and equal weights: every coefficient level is 127,
    so a lane's sum is 127 * sum_k q_k, far past int8 and int16; the plain
    version's int32 sums equal numpy's int64 ones."""
    k, qb = 64, 64
    rng = np.random.default_rng(3)
    q = rng.choice(np.array([-127, 127, 126, -1], np.int8), size=(k, 4 * qb))
    s = np.ones((k, 4), np.float32)
    w = np.ones(k, np.float32)
    got = int8dot.weighted_sum_q8_int8dot_plain(_t(q), _t(s), _t(w), qb)
    exact = 127 * q.astype(np.int64).sum(axis=0)
    assert np.abs(exact).max() > 2 ** 15
    cs = np.float32(np.float32(1.0) * np.float32(tref.INV_127))
    np.testing.assert_array_equal(
        got.numpy(), exact.astype(np.float32) * cs)


def test_k_past_the_int32_headroom_is_refused():
    assert 127 ** 2 * int8dot.MAX_K < 2 ** 31 <= 127 ** 2 * (
        int8dot.MAX_K + 1)
    k = int8dot.MAX_K + 1
    q = torch.zeros((k, 4), dtype=torch.int8)
    s, w = torch.ones((k, 1)), torch.ones(k)
    with pytest.raises(ValueError, match=str(int8dot.MAX_K)):
        int8dot.weighted_sum_q8_int8dot(q, s, w, 4)


def test_int8dot_auto_follows_the_reference(monkeypatch):
    """The variable overrides the platform gate, never the K threshold;
    unset, the gate is closed (on this CPU the reference's is too)."""
    assert tref.INT8_DOT_MIN_K == jref.INT8_DOT_MIN_K == 32
    cases = [(None, 64), (None, 1024), ("1", 32), ("1", 31), ("1", 64),
             ("0", 64), ("0", 31), (" 1 ", 40), ("yes", 64)]
    for env, k in cases:
        if env is None:
            monkeypatch.delenv("REPRO_INT8_DOT", raising=False)
        else:
            monkeypatch.setenv("REPRO_INT8_DOT", env)
        assert jax.default_backend() == "cpu"
        assert tref.int8dot_auto(k) == jref.int8dot_auto(k), (env, k)
    monkeypatch.delenv("REPRO_INT8_DOT", raising=False)
    assert not tref.int8dot_auto(64) and not tref.int8dot_auto(10 ** 5)


def test_xla_sum_is_the_jitted_sum():
    jsum = jax.jit(jnp.sum)
    rng = np.random.default_rng(5)
    for k in (1, 31, 32, 33, 48, 64, 100, 1000):
        for _ in range(20):
            w = (rng.uniform(size=k) * rng.choice([1e-3, 1.0, 1e3], k)
                 ).astype(np.float32)
            assert flat.xla_sum(w) == np.float32(jsum(jnp.asarray(w))), k
            if k <= 32:
                assert flat.xla_sum(w) == flat.sum_in_order(w)


# ---------------------------- the server round ----------------------------


@pytest.fixture
def regime(monkeypatch):
    """``REPRO_INT8_DOT=1`` for both packages, set before the reference
    traces its server; the calls of each aggregate the round makes."""
    monkeypatch.setenv("REPRO_INT8_DOT", "1")
    calls = []

    def counting(real):
        def counted(*a, **k):
            calls.append(real.__name__)
            return real(*a, **k)
        return counted
    monkeypatch.setattr(tagg, "weighted_sum_q8_int8dot",
                        counting(tagg.weighted_sum_q8_int8dot))
    q8 = tagg._QUANT_KERNELS["q8"]
    monkeypatch.setitem(tagg._QUANT_KERNELS, "q8", q8._replace(
        aggregate=counting(q8.aggregate), sdga=counting(q8.sdga),
        fold=counting(q8.fold)))
    return calls


_K = 64


def _case(mode):
    q, s = _rows(_K, seed=20 + MODES.index(mode))
    rng = np.random.default_rng(30 + MODES.index(mode))
    params = rng.normal(size=D).astype(np.float32)
    if mode == "fedsgd":
        w = np.ones(_K, np.float32)
    elif mode == "fedavg":
        w = (rng.uniform(size=_K) * 100 + 1).astype(np.float32)
    else:
        w = np.power(rng.integers(0, 5, _K) + np.float32(1.0),
                     -np.float32(0.5)).astype(np.float32)
    return q, s, params, w


def _reference_rounds(mode, q, s, params, w, rounds=2):
    js = jagg.FlatServer(mode, D, alpha=0.5, wire="q8", qblock=QB,
                         backend="xla", external_discount=True,
                         fedasync_rates=True, **KW)
    p = jnp.asarray(params)
    opt = js.init_opt(p)
    for _ in range(rounds):
        p, opt, m = js.step(p, (jnp.asarray(q), jnp.asarray(s)),
                            jnp.asarray(w), opt)
    return np.asarray(p), jax.tree_util.tree_map(np.asarray, opt), m


def _port_rounds(mode, q, s, params, w, mesh=None, rounds=2):
    srv = FlatServer(mode, D, wire="q8", qblock=QB, device="cpu", mesh=mesh,
                     **KW)
    p = _t(params)
    opt = srv.init_opt(p)
    buf = flat.shard_rows((_t(q), _t(s)), mesh)
    for _ in range(rounds):
        p, opt, m = srv.step(p, buf, w, opt)
    return p, opt, m


@pytest.mark.parametrize("mode", MODES)
def test_single_device_round_matches_reference(mode, regime):
    q, s, params, w = _case(mode)
    want, jopt, jm = _reference_rounds(mode, q, s, params, w)
    got, opt, m = _port_rounds(mode, q, s, params, w)
    assert regime == ["weighted_sum_q8_int8dot"] * 2, regime
    if mode == "fedavg":
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, **STEP_TOL)
    for key in opt:
        if key == "step":
            assert opt[key] == int(jopt[key])
        else:
            np.testing.assert_allclose(opt[key].numpy(), jopt[key],
                                       **STEP_TOL)
    if mode != "fedavg":  # fedavg's second round barely moves
        assert float(m["update_norm"]) == pytest.approx(
            float(jm["update_norm"]), rel=1e-6)


def _oracle(mode, q, s, params, w, edges, pods):
    """One mesh round from the reference's pieces: each shard's coefficient
    scale of its unnormalized weights, their max, each shard's int8-dot
    partial on that grid (jitted), the partials and masses through the
    mesh's tree, then the step in eager ops."""
    n = edges * pods
    per = _K // n
    jfn = jax.jit(jref.weighted_sum_q8_int8dot_ref, static_argnums=3)
    shards = [(jnp.asarray(q[i * per:(i + 1) * per]),
               jnp.asarray(s[i * per:(i + 1) * per]),
               jnp.asarray(w[i * per:(i + 1) * per])) for i in range(n)]
    cs = jax.jit(jref.int8dot_coeff_scale)(*shards[0][1:])
    for _, ss, ws in shards[1:]:
        cs = jnp.maximum(cs, jax.jit(jref.int8dot_coeff_scale)(ss, ws))
    parts = [jfn(qs, ss, ws, QB, cs) for qs, ss, ws in shards]
    masses = [flat.sum_in_order(np.asarray(ws)) for _, _, ws in shards]

    def tree(xs, add):
        if edges == 1:  # the 1-D mesh adds its shards in order
            groups = list(xs)
        else:  # each edge's XOR tree, then the edges in order
            groups = [jref.xor_tree_sum_ref(xs[e * pods:(e + 1) * pods])
                      for e in range(edges)]
        total = groups[0]
        for x in groups[1:]:
            total = add(total, x)
        return total
    gsum = np.asarray(tree(parts, lambda a, b: a + b))[:D]
    wsum = tree([np.float32(m) for m in masses],
                lambda a, b: np.float32(a + b))
    wsum = np.float32(np.asarray(wsum))
    g = jnp.asarray(gsum) / jnp.float32(max(wsum, np.float32(1e-12)))
    p0 = jnp.asarray(params)
    if mode == "fedavg":
        return np.asarray(g)
    if mode in ("fedsgd", "fedbuff"):
        return np.asarray(p0 - SLR * g)
    if mode == "sdga":
        new, _, _ = jref.sdga_step_from_mean(
            g, p0, jnp.zeros(D), p0, server_lr=SLR, momentum=0.8,
            ema_anchor=0.05, ema_decay=tagg.EMA_DECAY)
        return np.asarray(new)
    b1, b2 = tagg.ADAM_B1, tagg.ADAM_B2
    m = b1 * jnp.zeros(D) + (1 - b1) * g
    v = b2 * jnp.zeros(D) + (1 - b2) * jnp.square(g)
    mh = m / (1 - jnp.power(jnp.float32(b1), jnp.float32(1)))
    vh = v / (1 - jnp.power(jnp.float32(b2), jnp.float32(1)))
    return np.asarray(p0 - SLR * mh / (jnp.sqrt(vh) + tagg.ADAM_EPS))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=["2x2", "pod4"])
@pytest.mark.parametrize("mode", MODES)
def test_mesh_round_is_the_oracle_bitwise(mode, shape, regime):
    q, s, params, w = _case(mode)
    mesh = flat.make_hier_mesh(*shape, devices="cpu")
    got, _, _ = _port_rounds(mode, q, s, params, w, mesh=mesh, rounds=1)
    assert regime == ["weighted_sum_q8_int8dot"] * 4, regime
    want = _oracle(mode, q, s, params, w, *shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # and within the reference's mesh bound of the single device's round
    single, _, _ = _port_rounds(mode, q, s, params, w, rounds=1)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=2e-5,
                               rtol=2e-5)


# ---------------------------- the regime's gate ----------------------------


def _one_round(mode="fedsgd", wire="q8", k=_K):
    q, s, params, w = _case("fedsgd")
    srv = FlatServer(mode, D, wire=wire, qblock=QB, device="cpu", **KW)
    p = _t(params)
    if wire == "q8":
        buf = (_t(q[:k]), _t(s[:k]))
    else:
        rng = np.random.default_rng(0)
        buf = torch.from_numpy(rng.normal(size=(k, D)).astype(np.float32))
    if mode == "fedasync":
        w = np.full(k, 0.01, np.float32)
    srv.step(p, buf, w[:k], srv.init_opt(p))


def test_regime_off_without_the_variable(monkeypatch, regime):
    """``regime`` sets the variable and counts; each case then changes one
    thing that keeps the regime off."""
    _one_round()
    assert regime == ["weighted_sum_q8_int8dot"]
    del regime[:]
    _one_round(k=31)
    _one_round(mode="fedasync")
    _one_round(wire="f32")
    assert regime == ["safl_aggregate_q8"] + ["safl_fold_q8"] * _K
    for env in (None, "0"):
        del regime[:]
        if env is None:
            monkeypatch.delenv("REPRO_INT8_DOT")
        else:
            monkeypatch.setenv("REPRO_INT8_DOT", env)
        for mode in ("fedsgd", "fedavg", "sdga"):
            _one_round(mode=mode)
        assert regime == ["safl_aggregate_q8"] * 2 + ["sdga_aggregate_q8"]


def test_engine_sync_q8_rounds_take_the_regime(monkeypatch, regime):
    """The CNN engine in sync mode on the q8 wire with K = 64 clients, 2
    rounds: one int8-dot call a round and no fused q8 aggregate with the
    variable set; the other way round without it."""
    import dataclasses

    from repro_torch.configs.paper import MODES as SETTINGS
    from repro_torch.core import FLEngine
    from repro_torch.data import (build_client_shards, make_dataset,
                                  train_test_split)
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    ds = make_dataset("cifar10", n=700, seed=0, hw=8)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "iid", _K, 8, seed=0)
    model = build_paper_model("cnn", prng_key(0), device="cpu",
                              n_classes=ds.n_classes, in_ch=3, width=2,
                              image_size=8)
    cfg = dataclasses.replace(SETTINGS["SS"], n_clients=_K, k=_K,
                              client_lr=0.05, wire="q8")
    seen = {}
    for env in ("1", None):
        if env is None:
            monkeypatch.delenv("REPRO_INT8_DOT")
        del regime[:]
        eng = FLEngine(cfg, model[2], ds.kind, model[0], model[1], shards,
                       te.x[:50], te.y[:50], device="cpu")
        res = eng.run(2)
        assert len(res.metrics.records) == 2
        assert all(np.isfinite(r.loss) for r in res.metrics.records)
        seen[env] = list(regime)
    assert seen["1"] == ["weighted_sum_q8_int8dot"] * 2, seen
    assert seen[None] == ["safl_aggregate_q8"] * 2, seen
