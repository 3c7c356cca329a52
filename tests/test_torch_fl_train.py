"""The cross-pod FL train step (``repro_torch.launch.steps
.make_fl_train_step``) against the reference's ``make_fl_train_step`` on
the CPU: 2 pods, ``fedsgd`` with 1 inner step and ``fedavg`` with 2,
weights ``(1, 1)`` and ``(1, 0)`` (a straggler pod), 2 rounds from the
same stacked params and optimizer state on the same global batch.

* sgd and sgdm run free: params and the loss within ``rtol=1e-5,
  atol=1e-6``, the optimizer state (sgdm's momentum, a sum of gradients)
  within ``STATE_TOL`` of its leaf's largest value (seen: one embedding
  momentum lane of 65,536 1.2e-6 off, 1.8e-6 of the leaf's largest,
  after 4 local steps: the embedding's gradient adds a token's
  occurrences in another order).  The reduced internvl2 (the VLM: sgdm,
  its patch embeddings split over the pods with the tokens) and kimi-k2
  (a dense and a MoE layer, sgd).
* AdamW (the reduced qwen3) is fed the port's gradients, as
  ``test_three_steps_of_own_optimizer`` does (``_train_common`` says
  why): each pod's gradient, taken at the reference's params, within the
  gradient bound, then the reference's jitted local updates, pod mean and
  server update on those gradients give the port's params and state
  bitwise.

Every round: the pods in sync, the pod mean one ``safl_aggregate`` call
in mode ``avg`` over the pods' flat rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _train_common as tc  # noqa: E402
import _zoo_common as zc  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.launch.steps import _tmean_over_leading  # noqa: E402
from repro.launch.steps import make_fl_train_step as jmake_fl  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

N_PODS, ROUNDS, LR = 2, 2, 1e-2
#: the momentum's bound, a fraction of its leaf's largest value: a few
#: times the 1.8e-6 read
STATE_TOL = 5e-6
_JSTEPS = {}


def _ref_step(arch, agg, inner):
    """The reference's jitted FL step, once per (arch, aggregation, inner
    steps) and process."""
    key = (arch, agg, inner)
    if key not in _JSTEPS:
        jcfg, _, jm, _, _ = tc.ref(arch)
        step, opt = jmake_fl(jm, jcfg, aggregation=agg, lr=LR,
                             inner_steps=inner)
        _JSTEPS[key] = (jax.jit(step), opt)
    return _JSTEPS[key]


def _counting(monkeypatch, rows=None):
    """Count the step's ``safl_aggregate`` calls as (shape, mode); with
    ``rows`` (a list) also keep each call's rows and result."""
    calls = []
    real = tsteps.ops.safl_aggregate

    def counted(u, w, *a, **k):
        calls.append((tuple(u.shape), k.get("mode")))
        out = real(u, w, *a, **k)
        if rows is not None:
            rows.append((u.clone(), out.clone()))
        return out
    monkeypatch.setattr(tsteps.ops, "safl_aggregate", counted)
    return calls


@pytest.mark.parametrize("arch,agg,inner,weights", [
    ("internvl2-76b", "fedsgd", 1, (1.0, 1.0)),
    ("internvl2-76b", "fedsgd", 1, (1.0, 0.0)),
    ("internvl2-76b", "fedavg", 2, (1.0, 1.0)),
    ("internvl2-76b", "fedavg", 2, (1.0, 0.0)),
    ("kimi-k2-1t-a32b", "fedavg", 2, (1.0, 0.0)),
    ("kimi-k2-1t-a32b", "fedsgd", 1, (0.25, 1.0)),
])
def test_fl_step_matches_reference(arch, agg, inner, weights, monkeypatch):
    _, tcfg, _, jp, _ = tc.ref(arch)
    jstep, jopt = _ref_step(arch, agg, inner)
    tstep, topt = tsteps.make_fl_train_step(
        build_model(tcfg), tcfg, aggregation=agg, lr=LR, inner_steps=inner)
    jps = jax.tree_util.tree_map(lambda x: jnp.stack([x] * N_PODS), jp)
    jos = jax.vmap(jopt.init)(jps)
    tps = params_from_jax(tc.np_tree(jps), "cpu")
    tos = params_from_jax(tc.np_tree(jos), "cpu")
    D = sum(leaf.size for leaf in jax.tree_util.tree_leaves(jp))
    calls = _counting(monkeypatch)
    for rnd in range(ROUNDS):
        # 8 sequences of 32: 4 a pod, 2 a microbatch under fedavg; the
        # MoE's groups of 64 tokens fill a microbatch
        jb, tb = tc.batches(tcfg, 40 + rnd, b=8, s=32)
        w = jnp.asarray(weights, jnp.float32)
        jps, jos, jmet = jstep(jps, jos, jb, jnp.int32(rnd), w)
        n = len(calls)
        tps, tos, tmet = tstep(tps, tos, tb, rnd, weights)
        assert calls[n:] == [((N_PODS, D), "avg")], calls[n:]
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= 1e-5 * abs(want), rnd
        for leaf in jax.tree_util.tree_leaves(tps):
            assert torch.equal(leaf[0], leaf[1])  # the pods in sync
    tc.assert_params_close(tc.to_numpy(tps), tc.np_tree(jps))
    tc.assert_grads_close(tc.to_numpy(tos), tc.np_tree(jos), "state",
                          tol=STATE_TOL)


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("agg,inner,weights", [
    ("fedsgd", 1, (1.0, 1.0)),
    ("fedsgd", 1, (1.0, 0.0)),
    ("fedavg", 2, (1.0, 1.0)),
    ("fedavg", 2, (1.0, 0.0)),
])
def test_fl_step_adamw_fed_the_port_gradients(agg, inner, weights,
                                              monkeypatch):
    """The reduced qwen3 (AdamW), 2 rounds: every gradient the port's FL
    step takes is held to the reference's at the same params and
    microbatch, and the reference, fed those gradients (its jitted AdamW
    update, ``_tmean_over_leading`` and, under fedsgd, the vmapped server
    update), lands on the port's rows, pod mean, params and state
    bitwise."""
    jcfg, tcfg, _, jp, jvg = tc.ref("qwen3-1.7b")
    assert tcfg.optimizer == "adamw"
    jo = jopt.make_optimizer(jcfg.optimizer, lr=LR)
    jupd = jax.jit(jo.update)
    jserver = jax.jit(jax.vmap(jo.update, in_axes=(0, 0, 0, None)))
    jmean = jax.jit(_tmean_over_leading)
    seen = tc.record_value_and_grad(monkeypatch)
    rows = []
    calls = _counting(monkeypatch, rows)
    tstep, _ = tsteps.make_fl_train_step(
        build_model(tcfg), tcfg, aggregation=agg, lr=LR, inner_steps=inner)
    jps = jax.tree_util.tree_map(lambda x: jnp.stack([x] * N_PODS), jp)
    jos = jax.vmap(jo.init)(jps)
    tps = params_from_jax(tc.np_tree(jps), "cpu")
    tos = params_from_jax(tc.np_tree(jos), "cpu")
    w = jnp.asarray(weights, jnp.float32)
    pod = lambda tree, i: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x[i], tree)
    for rnd in range(ROUNDS):
        jb, tb = tc.batches(tcfg, 40 + rnd, b=8, s=32)
        n, m = len(seen), len(calls)
        tps, tos, tmet = tstep(tps, tos, tb, rnd, weights)
        assert calls[m:] == [((N_PODS, rows[-1][0].shape[1]), "avg")]
        assert len(seen) - n == N_PODS * inner
        mb = 8 // N_PODS // inner
        p_loc, s_loc, g_loc, losses = [], [], [], []
        for i in range(N_PODS):
            p, st = pod(jps, i), pod(jos, i)
            for j in range(inner):
                tparams, _, ((tl, _), tg) = seen[n + i * inner + j]
                tc.assert_bitwise(tc.to_numpy(tparams), tc.np_tree(p),
                               ("params at the gradient", rnd, i, j))
                lo = (i * inner + j) * mb
                (jl, _), jg = jvg(p, {k: v[lo:lo + mb]
                                      for k, v in jb.items()})
                assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
                tc.assert_grads_close(tc.to_numpy(tg), tc.np_tree(jg),
                                      ("grads", rnd, i, j))
                g = jax.tree_util.tree_map(jnp.asarray, tc.to_numpy(tg))
                if agg == "fedavg":
                    p, st = jupd(p, g, st, jnp.int32(rnd + j))
                losses.append(float(tl))
            p_loc.append(p)
            s_loc.append(st)
            g_loc.append(g)
        stack = lambda trees: jax.tree_util.tree_map(  # noqa: E731
            lambda *xs: jnp.stack(xs), *trees)
        mine = stack(p_loc if agg == "fedavg" else g_loc)
        u, out = rows[-1]
        for i in range(N_PODS):
            assert np.array_equal(u[i].numpy(), _flat(pod(mine, i))), i
        mean = jmean(mine, w)
        assert np.array_equal(out.numpy(), _flat(pod(mean, 0)))
        if agg == "fedavg":
            jps, jos = mean, stack(s_loc)
        else:
            jps, jos = jserver(jps, mean, jos, jnp.int32(rnd))
        tc.assert_bitwise(tc.to_numpy(tps), tc.np_tree(jps), ("params", rnd))
        tc.assert_bitwise(tc.to_numpy(tos), tc.np_tree(jos), ("state", rnd))
        assert float(tmet["loss"]) == pytest.approx(np.mean(losses),
                                                    rel=1e-6)
        for leaf in jax.tree_util.tree_leaves(tps):
            assert torch.equal(leaf[0], leaf[1])  # the pods in sync


def test_fl_step_refuses_other_aggregations():
    _, tcfg, _, _, _ = tc.ref("internvl2-76b")
    with pytest.raises(ValueError):
        tsteps.make_fl_train_step(build_model(tcfg), tcfg,
                                  aggregation="fedbuff")


def test_pod_mean_zero_weight_is_the_other_pod(monkeypatch):
    """With weights (0, 1), fedavg with 1 inner step gives every pod the
    second pod's local params bitwise (its row alone in the mean)."""
    _, tcfg, _, jp, _ = tc.ref("internvl2-76b")
    model = build_model(tcfg)
    tstep, topt = tsteps.make_fl_train_step(model, tcfg, aggregation="fedavg",
                                            lr=LR, inner_steps=1)
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    tps = jax.tree_util.tree_map(lambda x: torch.stack([x, x]), tp)
    tos = jax.tree_util.tree_map(lambda x: torch.stack([x, x]),
                                 topt.init(tp))
    _, tb = tc.batches(tcfg, 5, b=4, s=32)
    new, _, _ = tstep(tps, tos, tb, 0, (0.0, 1.0))
    step, opt = tsteps.make_train_step(model, tcfg, lr=LR)
    alone, _, _ = step(tp, opt.init(tp), {k: v[2:] for k, v in tb.items()},
                       0)
    for a, b in zip(jax.tree_util.tree_leaves(tc.to_numpy(new)),
                    jax.tree_util.tree_leaves(tc.to_numpy(alone))):
        assert np.array_equal(a[0], b) and np.array_equal(a[1], b)
