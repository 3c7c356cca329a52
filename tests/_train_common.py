"""Shared helpers of the training parity tests (``test_torch_train.py``,
``test_torch_fl_train.py``): the reference's jitted ``value_and_grad``
once per arch and process, the same batch for both packages, and the
bounds.

Free-running steps are held to ``rtol=1e-5, atol=1e-6`` under sgd and
sgdm, which are linear in the gradient.  Under AdamW they are not: AdamW
moves each coordinate by about ``lr * m / sqrt(v)``, whatever the
gradient's size, so the port's gradients, within about 1e-6 of the
largest reference gradient of their leaf (other exp / log / GELU
formulas and reduction orders), step some small-gradient coordinates
differently, and three steps compound it (reduced configs, lr 3e-3: up
to 2.6 lr apart, the losses still within 1e-5).  So every config is
also run with the same gradients fed to both optimizers, which must then
agree bitwise, while each step's port gradient, taken at the same
params, is held to the gradient bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import _zoo_common as zc
from repro_torch.launch import steps as tsteps

#: the gradient bound: a fraction of the leaf's largest reference gradient
GRAD_TOL = 1e-4
RTOL, ATOL = 1e-5, 1e-6
#: every test's batch: B sequences of S tokens (the reduced MoE's groups
#: of 64 take all B * S tokens; the hybrid's chunks of 16 split S)
B, S = 2, 32

_REF = {}


def ref(arch, **kw):
    """(jax cfg, port cfg, jax model, jax params, the reference's jitted
    ``value_and_grad(train_loss, has_aux=True)``), made once per arch and
    overrides."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REF:
        jcfg, tcfg = zc.cfgs(arch, **kw)
        jm = zc.jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _REF[key] = (jcfg, tcfg, jm, jp,
                     jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True)))
    return _REF[key]


def batches(cfg, seed, b=B, s=S):
    """The same batch for the reference (jnp) and the port (torch)."""
    toks, extra = zc.inputs(cfg, b, s, seed)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_numpy(tree):
    """The port's params or optimizer state -> the same nested dict of
    numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_params_close(got, want, what="params"):
    """Every leaf of ``got`` (numpy tree) within ``RTOL``/``ATOL`` of
    ``want``'s."""
    for path, w in zc.leaves(want):
        g = get(got, path)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        close = np.abs(g - w) <= ATOL + RTOL * np.abs(w)
        assert close.all(), (what, path, np.abs(g - w).max())


def assert_grads_close(got, want, what="grads", tol=GRAD_TOL):
    """Every leaf of ``got`` within ``tol`` (``GRAD_TOL``) of the largest
    |value| of ``want``'s leaf."""
    for path, w in zc.leaves(want):
        g = get(got, path)
        assert g.shape == w.shape, (what, path)
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max() + 1e-12, (what, path, err)


def assert_bitwise(got, want, what):
    """Every leaf of ``got`` (numpy tree) bitwise ``want``'s."""
    for path, w in zc.leaves(want):
        g = get(got, path)
        assert g.dtype == w.dtype and np.array_equal(
            g.view(np.uint32), w.view(np.uint32)), (what, path,
                                                     np.abs(g - w).max())


def record_value_and_grad(monkeypatch):
    """Keep every call of a ``value_and_grad`` that ``launch.steps`` makes
    from now on: (the params it was given, copied, the batch, ((loss,
    metrics), grads))."""
    seen = []
    real = tsteps.value_and_grad

    def make(loss_fn):
        vg = real(loss_fn)

        def rec(params, batch):
            out = vg(params, batch)
            seen.append((jax.tree_util.tree_map(torch.clone, params), batch,
                         out))
            return out
        return rec
    monkeypatch.setattr(tsteps, "value_and_grad", make)
    return seen
