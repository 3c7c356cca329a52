"""The port's two LLM examples against the reference's, on the CPU
(``examples/torch_serve_batched.py``, ``examples/torch_distributed_pretrain
.py``).

  * ``pad_prompts`` equal to the reference example's, and the prompt queue
    the reference's draw from ``default_rng(0)``;
  * the batched serving loop at ``--requests 4 --max-new 6`` on the
    reduced xlstm-125m with the reference's weights carried across
    (``convert.params_from_jax``): every request's ids and length equal to
    the reference example's loop (jitted prefill and decode) on the same
    prompts; the loop also stops at the EOS id;
  * the cross-pod pretraining loop, 3 steps under fedsgd and fedavg: the
    losses within 1e-5 (relative) of the reference's ``make_fl_train_step``
    run jitted on one CPU device with the pod axis stacked, free-running
    where AdamW keeps them there (every fedsgd round, fedavg's first; see
    ``FREE_ROUNDS``), and every microbatch's loss and gradients at the
    port's params within 1e-5 and ``_train_common``'s gradient bound of
    the reference's at those params; the drift between the pods 0.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _train_common as tc  # noqa: E402
import _zoo_common as zc  # noqa: E402
from repro.launch.steps import make_fl_train_step as jmake_fl  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve_ex = _load("torch_serve_batched")
pretrain_ex = _load("torch_distributed_pretrain")
ref_serve_ex = _load("serve_batched")


def _quiet(line):
    del line


def test_pad_prompts_is_the_reference():
    rng = np.random.default_rng(4)
    for lens in ([8, 32, 17], [5], [3, 3, 9, 1]):
        prompts = [rng.integers(0, 500, n).tolist() for n in lens]
        for pad in (0, 3):
            got = serve_ex.pad_prompts(prompts, 500, pad)
            want = ref_serve_ex.pad_prompts(prompts, 500, pad)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_prompt_queue_is_the_reference_draw():
    _, tcfg, _, _, _ = zc.cached_setup("xlstm-125m")
    rng = np.random.default_rng(0)
    want = [rng.integers(0, tcfg.vocab_size, rng.integers(8, 33)).tolist()
            for _ in range(16)]
    assert serve_ex.make_prompts(tcfg, 16) == want


def _reference_loop(jm, jp, cfg, prompts, max_new, decode):
    """The reference example's loop (``examples/serve_batched.py``) on
    ``prompts``: the same lines, the decode jitted once per process."""
    toks, _ = ref_serve_ex.pad_prompts(prompts, cfg.vocab_size)
    B, S = toks.shape
    batch = {"tokens": jnp.asarray(toks)}
    if cfg.family == "ssm":
        logits, cache = jax.jit(jm.prefill)(jp, batch)
    else:
        logits, cache = jax.jit(
            lambda p, b: jm.prefill(p, b, capacity=S + max_new))(jp, batch)
    done = np.zeros(B, bool)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    generated = [[] for _ in range(B)]
    steps = 0
    for i in range(max_new):
        for b in range(B):
            if not done[b]:
                generated[b].append(int(np.array(tok)[b]))
        done |= np.array(tok) == 7  # the example's synthetic EOS id
        if done.all():
            break
        logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        steps += 1
    return generated, steps


def test_serve_loop_matches_the_reference_loop():
    _, tcfg, jm, jp, tm = zc.cached_setup("xlstm-125m")
    prompts = serve_ex.make_prompts(tcfg, 4)
    want, want_steps = _reference_loop(jm, jp, tcfg, prompts, 6,
                                       zc.jax_decode("xlstm-125m"))
    got = serve_ex.serve(tm, prompts, 6, torch.device("cpu"), log=_quiet)
    assert got["generated"] == want
    assert got["lens"] == [len(g) for g in want]
    assert got["steps"] == want_steps
    assert serve_ex.EOS == 7


def test_serve_loop_stops_at_eos(monkeypatch):
    """With the EOS id set to a request's first token, that request stops
    after it (the reference's rule: the EOS token is kept), the others
    run on; with every request's first token, no decode step is taken."""
    _, tcfg, _, _, tm = zc.cached_setup("xlstm-125m")
    prompts = serve_ex.make_prompts(tcfg, 4)
    free = serve_ex.serve(tm, prompts, 6, torch.device("cpu"), log=_quiet)
    first = [g[0] for g in free["generated"]]
    monkeypatch.setattr(serve_ex, "EOS", first[1])
    got = serve_ex.serve(tm, prompts, 6, torch.device("cpu"), log=_quiet)
    for b, g in enumerate(got["generated"]):
        if first[b] == first[1]:
            assert g == [first[1]]
        else:
            assert g == free["generated"][b][:len(g)] and len(g) == 6
    if len(set(first)) == 1:
        assert got["steps"] == 0


def _reference_pretrain(agg, steps):
    jcfg, tcfg, jm, jp, _ = tc.ref("qwen3-1.7b")
    step_fn, opt = jmake_fl(jm, jcfg, aggregation=agg, lr=pretrain_ex.LR,
                            inner_steps=2 if agg == "fedavg" else 1)
    params = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jp)
    ostate = jax.vmap(opt.init)(params)
    jstep = jax.jit(step_fn)
    rng = np.random.default_rng(0)
    losses = []
    for step in range(steps):
        toks = jnp.asarray(rng.integers(0, jcfg.vocab_size,
                                        (pretrain_ex.B, pretrain_ex.S)),
                           jnp.int32)
        params, ostate, m = jstep(params, ostate, {"tokens": toks},
                                  jnp.int32(step), jnp.ones((2,)))
        losses.append(float(m["loss"]))
    return losses


#: the rounds whose free-running losses are held to the reference's: under
#: fedavg each pod takes two AdamW steps a round, and from round 1 on the
#: free runs part at small-gradient coordinates (AdamW moves each by about
#: lr whatever its gradient's size; seen 1.3e-5 and 1.3e-4 relative in the
#: losses of rounds 1 and 2), so those rounds are held at the same params
FREE_ROUNDS = {"fedsgd": 3, "fedavg": 1}


@pytest.mark.parametrize("agg", ["fedsgd", "fedavg"])
def test_pretrain_losses_match_the_reference(agg, monkeypatch):
    """3 rounds of the example's loop: the free-running losses of
    ``FREE_ROUNDS`` rounds within 1e-5 of the reference's, and every
    microbatch's loss and gradients, taken at the port's params, within
    1e-5 and the gradient bound of the reference's jitted
    ``value_and_grad`` at those params; the pods' drift 0."""
    jcfg, tcfg, _, _, jvg = tc.ref("qwen3-1.7b")
    # the reduced config is the example's already, so the cached reference
    # model is the example's
    assert pretrain_ex.pretrain_config() == tcfg
    want = _reference_pretrain(agg, 3)
    seen = tc.record_value_and_grad(monkeypatch)
    got = pretrain_ex.run(steps=3, aggregation=agg, device="cpu",
                          log=_quiet)
    assert len(got["losses"]) == 3 and got["drift"] == 0.0
    n = FREE_ROUNDS[agg]
    for g, w in zip(got["losses"][:n], want[:n]):
        assert abs(g - w) <= 1e-5 * abs(w), (got["losses"], want)
    # 2 pods x inner steps a round
    assert len(seen) == 3 * 2 * (2 if agg == "fedavg" else 1)
    for params, batch, ((loss, _), grads) in seen:
        jparams = jax.tree_util.tree_map(jnp.asarray, tc.to_numpy(params))
        (jloss, _), jgrads = jvg(jparams, {"tokens": jnp.asarray(
            batch["tokens"].numpy(), jnp.int32)})
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        tc.assert_grads_close(tc.to_numpy(grads), tc.np_tree(jgrads))
