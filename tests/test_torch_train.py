"""The zoo's training path (``repro_torch.optim``, ``models.transformer``'s
``forward`` / ``train_loss``, ``launch.steps.make_train_step``,
``launch.train``) against the reference on the CPU:

  * ``warmup_cosine`` / ``cosine_schedule`` at step 0, the warmup edge,
    the middle and past the end, and ``sgd``, ``sgdm`` and ``adamw``
    over 4 updates (constant and scheduled lr), bitwise the reference's
    jitted functions (XLA's FMAs, reciprocal constants and ``powf``
    reproduced), each written into the trees it was given;
  * each of the ten reduced configs: ``train_loss``'s total, ``loss``
    and ``aux`` within 1e-5 relative, every gradient leaf within 1e-4 of
    its largest reference value; 3 steps of ``make_train_step`` with the
    config's optimizer: params and optimizer state within ``rtol=1e-5,
    atol=1e-6`` (AdamW: see ``_train_common``);
  * ``remat=True`` bitwise ``remat=False`` (dense, hybrid, moe, xlstm,
    enc-dec); ``attn_impl="online"`` and ``attn_chunk`` against the
    reference's online and chunked attention;
  * the training forward never reaches ``ops.flash_attention``; the
    serving prefill does; the CUDA wrapper refuses a differentiable
    input;
  * ``python -m repro_torch.launch.train --device cpu`` logs the
    reference launcher's losses, and a 2-step checkpoint of either
    package resumes in the other (leaves bitwise on load; 2 steps on,
    internvl2's sgdm params within the bound, and the default qwen3's
    AdamW params and state bitwise the reference fed the port's
    gradients).
"""
import contextlib
import dataclasses
import io
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _train_common as tc  # noqa: E402
import _zoo_common as zc  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import io as tckpt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)


def _tt(tree):
    return {k: _tt(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (
        what, np.abs(a - b).max())


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [(3e-3, 5, 100), (1e-2, 0, 7),
                                             (3e-4, 12, 240)])
def test_schedules_bitwise_reference_jit(lr, warmup, total):
    steps = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                    (warmup + total) // 2, total - 1, total, total + 2})
    pairs = [(jopt.warmup_cosine(lr, warmup, total),
              topt.warmup_cosine(lr, warmup, total)),
             (jopt.cosine_schedule(lr, total), topt.cosine_schedule(lr,
                                                                    total))]
    for jf, tf in pairs:
        jf = jax.jit(jf)
        for s in steps:
            got = tf(s)
            assert got.dtype == torch.float32 and got.shape == ()
            _bitwise(got.numpy(), jf(jnp.int32(s)), ("step", s))


def _opt_tree(rng):
    return {"a": rng.normal(size=(96, 33)).astype(np.float32),
            "b": {"c": (rng.normal(size=(77,)) * 1e-3).astype(np.float32)}}


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw"])
@pytest.mark.parametrize("sched", [False, True])
def test_optimizer_updates_bitwise_reference_jit(name, sched):
    rng = np.random.default_rng(1)
    jo = jopt.make_optimizer(
        name, lr=jopt.warmup_cosine(3e-3, 2, 6) if sched else 1e-2)
    to = topt.make_optimizer(
        name, lr=topt.warmup_cosine(3e-3, 2, 6) if sched else 1e-2)
    p = _opt_tree(rng)
    jp, js = p, jo.init(p)
    tp, ts = _tt(p), to.init(_tt(p))
    upd = jax.jit(jo.update)
    for step in range(4):
        g = _opt_tree(rng)
        jp, js = upd(jp, g, js, jnp.int32(step))
        given = jax.tree_util.tree_leaves((tp, ts))
        tp, ts = to.update(tp, _tt(g), ts, step)
        assert all(a is b for a, b in zip(
            given, jax.tree_util.tree_leaves((tp, ts))))  # written in place
        for path, w in zc.leaves({"p": tc.np_tree(jp),
                                  "s": tc.np_tree(js)}):
            got = tc.get({"p": tc.to_numpy(tp), "s": tc.to_numpy(ts)}, path)
            _bitwise(got, w, (name, step, path))


def test_optimizer_unknown_name_raises():
    with pytest.raises(ValueError):
        topt.make_optimizer("lion")


# ---------------------------------------------------------------------------
# each family's train_loss, gradients and steps
# ---------------------------------------------------------------------------


def _port_vg(tcfg, tp, tb):
    return tsteps.value_and_grad(build_model(tcfg).train_loss)(tp, tb)


def _check_loss_and_grads(arch, seed=7, **kw):
    jcfg, tcfg, jm, jp, jvg = tc.ref(arch, **kw)
    jb, tb = tc.batches(tcfg, seed)
    (jl, jmet), jg = jvg(jp, jb)
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    (tl, tmet), tg = _port_vg(tcfg, tp, tb)
    assert sorted(tmet) == sorted(jmet)
    for name, got, want in [("total", tl, jl)] + [
            (k, tmet[k], jmet[k]) for k in jmet]:
        want = float(want)
        assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1e-6), (
            name, float(got), want)
    tc.assert_grads_close(tc.to_numpy(tg), tc.np_tree(jg))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_three_steps_of_own_optimizer(arch):
    """3 steps of ``make_train_step`` with the config's optimizer, lr 3e-3.
    Each step's port gradient is held to the reference's at the same
    params, and the reference's jitted update then takes the port's
    gradient: params and optimizer state bitwise.  Under sgd and sgdm the
    two also run free, each on its own gradients, within ``rtol=1e-5,
    atol=1e-6`` (AdamW: see ``_train_common``)."""
    jcfg, tcfg, jm, jp, jvg = tc.ref(arch)
    lr = 3e-3
    jo = jopt.make_optimizer(jcfg.optimizer, lr=lr)
    jupd = jax.jit(jo.update)
    step_fn, to = tsteps.make_train_step(build_model(tcfg), tcfg, lr=lr)
    tvg = tsteps.value_and_grad(build_model(tcfg).train_loss)
    fed, fed_s = jp, jo.init(jp)  # the reference fed the port's gradients
    free, free_s = jp, jo.init(jp)  # the reference on its own
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    ts = to.init(tp)
    for step in range(3):
        jb, tb = tc.batches(tcfg, 100 + step)
        (_, jmet), jg = jvg(fed, jb)
        (_, tmet), tg = tvg(tp, tb)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(
            float(jmet["loss"])), step
        tc.assert_grads_close(tc.to_numpy(tg), tc.np_tree(jg), ("step", step))
        fed, fed_s = jupd(fed, jax.tree_util.tree_map(
            jnp.asarray, tc.to_numpy(tg)), fed_s, jnp.int32(step))
        (_, _), g = jvg(free, jb)
        free, free_s = jupd(free, g, free_s, jnp.int32(step))
        tp, ts, _ = step_fn(tp, ts, tb, step)
    for path, w in zc.leaves({"p": tc.np_tree(fed), "s": tc.np_tree(fed_s)}):
        _bitwise(tc.get({"p": tc.to_numpy(tp), "s": tc.to_numpy(ts)}, path), w,
                 path)
    if tcfg.optimizer != "adamw":
        tc.assert_params_close(tc.to_numpy(tp), tc.np_tree(free))
        tc.assert_params_close(tc.to_numpy(ts), tc.np_tree(free_s), "state")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m", "xlstm-125m",
                                  "seamless-m4t-medium"])
def test_remat_bitwise(arch):
    _, tcfg, _, jp, _ = tc.ref(arch)
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    _, tb = tc.batches(tcfg, 7)
    (l0, m0), g0 = _port_vg(dataclasses.replace(tcfg, remat=False), tp, tb)
    (l1, m1), g1 = _port_vg(dataclasses.replace(tcfg, remat=True), tp, tb)
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k])
                                       for k in m0)
    for a, b in zip(jax.tree_util.tree_leaves(tc.to_numpy(g0)),
                    jax.tree_util.tree_leaves(tc.to_numpy(g1))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(attn_impl="online", attn_chunk=8, attn_kv_chunk=16),
    dict(attn_chunk=8),
    dict(attn_chunk=8, sliding_window=12),
], ids=["online", "chunked", "chunked-window"])
def test_training_attention_forms(kw):
    """The reference's online (q chunks of 8, kv chunks of 16) and
    q-chunked attention, and the window under the chunks."""
    arch = "starcoder2-3b" if "sliding_window" in kw else "qwen3-1.7b"
    _check_loss_and_grads(arch, **kw)


# ---------------------------------------------------------------------------
# flash attention: serving only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_training_never_reaches_flash(arch, monkeypatch):
    def sentinel(*a, **k):
        raise AssertionError("the training forward reached flash attention")
    monkeypatch.setattr(ops, "flash_attention", sentinel)
    _, tcfg, _, jp, _ = tc.ref(arch)
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    _, tb = tc.batches(tcfg, 7)
    (loss, _), grads = _port_vg(tcfg, tp, tb)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_serving_prefill_still_reaches_flash(arch, monkeypatch):
    calls = []
    real = ops.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(ops, "flash_attention", counted)
    _, tcfg, _, jp, _ = tc.ref(arch)
    model = build_model(tcfg)
    step = tsteps.make_prefill_step(model)
    _, tb = tc.batches(tcfg, 7)
    logits, _ = step(params_from_jax(tc.np_tree(jp), "cpu"), tb)
    want = (tcfg.n_layers // tcfg.hybrid_attn_every
            if tcfg.family == "hybrid" else
            tcfg.n_layers * (2 if tcfg.family == "audio" else 1))
    assert len(calls) == want and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-medium"])
def test_prefill_and_decode_steps_match_reference(arch):
    """``make_prefill_step`` / ``make_decode_step`` on a params tree
    against the reference's on the same tree: the prefill's logits, then
    2 decode steps' logits (cache capacity S: each writes the last
    slot, as the reference's)."""
    from repro.launch import steps as jsteps
    _, tcfg, jm, jp, _ = tc.ref(arch)
    jb, tb = tc.batches(tcfg, 9)
    jl, jc = jsteps.make_prefill_step(jm)(jp, jb)
    tl, tcache = tsteps.make_prefill_step(build_model(tcfg))(
        params_from_jax(tc.np_tree(jp), "cpu"), tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **zc.TOL)
    jdec = jax.jit(jsteps.make_decode_step(jm))
    tdec = tsteps.make_decode_step(build_model(tcfg))
    tp = params_from_jax(tc.np_tree(jp), "cpu")
    for i, tok in enumerate(np.random.default_rng(3).integers(
            0, tcfg.vocab_size, (2, tc.B))):
        pos = tc.S + i
        jl, jc = jdec(jp, jc, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        tl, tcache = tdec(tp, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **zc.TOL,
                                   err_msg=f"decode {i}")


def test_flash_wrapper_refuses_differentiable_input(monkeypatch):
    """The CUDA route (``on_cuda`` forced true) raises on an input that
    requires grad, before any launch; without grad mode it goes on."""
    monkeypatch.setattr(fa, "on_cuda", lambda t, kernel: True)
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    k = v = torch.zeros(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="train=True"):
        fa.flash_attention(q, k, v)
    monkeypatch.setattr(fa, "_lib", lambda: (_ for _ in ()).throw(
        LookupError("launch")))
    with torch.no_grad(), pytest.raises(LookupError):
        fa.flash_attention(q, k, v)


def test_cross_entropy_matches_reference():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 5, 11)) * 4).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5))
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                     None if m is None else jnp.asarray(m))
        got = layers.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(tgt),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the launcher and its checkpoints
# ---------------------------------------------------------------------------


def _losses(text):
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ")]


def _run_ref(argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    return out.getvalue()


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ttrain.main(argv + ["--device", "cpu"])
    return out.getvalue(), res


def test_cli_logs_reference_losses(monkeypatch):
    argv = ["--steps", "4", "--log-every", "1"]
    want = _losses(_run_ref(argv, monkeypatch))
    text, res = _run_port(argv)
    got = _losses(text)
    assert len(got) == len(want) == 4
    assert got == want or np.allclose(got, want, rtol=0, atol=1e-5)
    assert np.allclose(res.losses, want, rtol=0, atol=5e-5)
    assert text.splitlines()[0].startswith("arch=qwen3-1.7b family=dense ")


def _write_and_load(writer, arch, tmp_path, monkeypatch):
    """A 2-step checkpoint of ``arch`` written by ``writer``'s launcher,
    loaded by the port leaf for leaf -> (its directory, the loaded
    (params, opt_state))."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", arch, "--log-every", "1", "--steps", "2",
            "--ckpt-dir", ck]
    if writer == "reference":
        _run_ref(argv, monkeypatch)
    else:
        _run_port(argv)
    with np.load(tmp_path / "ck" / "ckpt_00000002.npz") as data:
        written = [data[f"leaf_{i}"] for i in range(len(data.files))]
    _, tcfg = zc.cfgs(arch)
    tpl = build_model(tcfg).init_params(prng_key(0), "cpu")
    opt = topt.make_optimizer(tcfg.optimizer)
    (lp, ls), step = tckpt.load_checkpoint(ck, (tpl, opt.init(tpl)))
    assert step == 2
    loaded = jax.tree_util.tree_leaves((tc.to_numpy(lp), tc.to_numpy(ls)))
    assert len(loaded) == len(written)
    for a, b in zip(loaded, written):
        assert np.array_equal(a, b)
    return ck, (lp, ls)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path, monkeypatch):
    """A 2-step checkpoint of (params, opt_state) written by one package
    resumes in the other: its leaves load bitwise; 2 more steps land
    within the bound of the writer's own resumed run (internvl2, the VLM:
    sgdm state and the patch embeddings drawn after the tokens)."""
    arch = ["--arch", "internvl2-76b", "--log-every", "1"]
    ck, _ = _write_and_load(writer, "internvl2-76b", tmp_path, monkeypatch)
    # 2 more steps in each package from the same checkpoint
    ck2 = str(tmp_path / "ck2")
    shutil.copytree(ck, ck2)
    more = arch + ["--steps", "4", "--resume"]
    _run_ref(more + ["--ckpt-dir", ck], monkeypatch)
    _, res = _run_port(more + ["--ckpt-dir", ck2])
    assert res.start == 2 and len(res.losses) == 2
    with np.load(tmp_path / "ck" / "ckpt_00000004.npz") as data:
        want = [data[f"leaf_{i}"] for i in range(len(data.files))]
    got = jax.tree_util.tree_leaves((tc.to_numpy(res.params),
                                     tc.to_numpy(res.opt_state)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tc.RTOL, atol=tc.ATOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_adamw_checkpoint_resumes_across_packages(writer, tmp_path,
                                                  monkeypatch):
    """The launcher's default, the reduced qwen3 with AdamW: a 2-step
    checkpoint of either package loads leaf for leaf (``m`` and ``v``
    with the params) and resumes in both.  The reference's resumed run
    logs the port's losses; the port's 2 resumed steps, each gradient
    within the bound of the reference's at the same params and batch,
    fed to the reference's jitted AdamW update under the launcher's
    schedule, give the port's params and state bitwise (AdamW is not
    held free-running: see ``_train_common``)."""
    ck, (lp, ls) = _write_and_load(writer, "qwen3-1.7b", tmp_path,
                                   monkeypatch)
    ck2 = str(tmp_path / "ck2")
    shutil.copytree(ck, ck2)
    more = ["--log-every", "1", "--steps", "4", "--resume"]
    want = _losses(_run_ref(more + ["--ckpt-dir", ck], monkeypatch))
    seen = tc.record_value_and_grad(monkeypatch)
    _, res = _run_port(more + ["--ckpt-dir", ck2])
    assert res.start == 2 and len(seen) == 2 == len(want)
    assert np.allclose(res.losses, want, rtol=0, atol=5e-5)
    jcfg, _, _, _, jvg = tc.ref("qwen3-1.7b")
    assert jcfg.optimizer == "adamw"
    jupd = jax.jit(jopt.make_optimizer(
        jcfg.optimizer, lr=jopt.warmup_cosine(3e-3, 1, 4)).update)
    p, s = (jax.tree_util.tree_map(jnp.asarray, tc.to_numpy(t))
            for t in (lp, ls))
    for k, (tparams, tb, ((tl, _), tg)) in enumerate(seen):
        tc.assert_bitwise(tc.to_numpy(tparams), tc.np_tree(p), ("at", k))
        (jl, _), jg = jvg(p, {"tokens": jnp.asarray(tb["tokens"].numpy(),
                                                     jnp.int32)})
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), k
        tc.assert_grads_close(tc.to_numpy(tg), tc.np_tree(jg), ("step", k))
        p, s = jupd(p, jax.tree_util.tree_map(jnp.asarray, tc.to_numpy(tg)),
                    s, jnp.int32(2 + k))
    tc.assert_bitwise(tc.to_numpy(res.params), tc.np_tree(p), "params")
    tc.assert_bitwise(tc.to_numpy(res.opt_state), tc.np_tree(s), "state")
