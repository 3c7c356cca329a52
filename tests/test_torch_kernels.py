"""The plain versions of the ported kernels against the reference's Pallas
kernels (interpret mode) and its jnp oracles, on the CPU.

Tolerance against the reference: ``rtol=1e-5, atol=1e-5``.  The plain
versions reduce over K one row at a time; the reference's einsum may sum
in another order and the poly discount's ``pow`` may differ in the last
ulp, so they agree to a few ulp of the summed terms (magnitude up to ~10
here, hence the absolute term where the sum cancels).  Properties of the port itself (a fold
chain equals one aggregate, a CPU call is the plain version) are exact.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import safl_agg as jk  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D_RAGGED = 2500  # not a multiple of the reference's 2048-lane block


def _rows(k, d, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(k, d)).astype(np.float32)
    p = rng.normal(size=(d,)).astype(np.float32)
    return u, p, rng


def _weights(rng, k, mode, discount):
    if discount == "poly":  # staleness values
        return rng.integers(0, 6, k).astype(np.float32)
    if mode == "mix":  # fedasync mix coefficients sum below 1
        return (rng.uniform(0.05, 0.9, k) / k).astype(np.float32)
    return rng.uniform(0.5, 4.0, k).astype(np.float32)


@pytest.mark.parametrize("beta", [1.0, 0.625])
def test_fold_plain_matches_reference(beta):
    u, p, _ = _rows(1, D_RAGGED)
    acc, vec, w = p, u[0], np.float32(0.37)
    want = np.asarray(jk.safl_fold(acc, vec, w, beta, interpret=True))
    oracle = np.asarray(jref.fold_ref(acc, vec, w, beta))
    got = tk.safl_fold_plain(torch.from_numpy(acc), torch.from_numpy(vec),
                             w, beta).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("discount", ["none", "poly"])
@pytest.mark.parametrize("mode", ["fedsgd", "avg", "mix", "sum"])
def test_aggregate_plain_matches_reference(mode, discount, k):
    u, p, rng = _rows(k, D_RAGGED, seed=k)
    w = _weights(rng, k, mode, discount)
    needs_p = mode in ("fedsgd", "mix")
    kw = dict(server_lr=0.3, mode=mode, alpha=0.5, discount=discount)
    want = np.asarray(jk.safl_aggregate(u, w, p if needs_p else None,
                                        interpret=True, **kw))
    got = tk.safl_aggregate_plain(
        torch.from_numpy(u), torch.from_numpy(w),
        torch.from_numpy(p) if needs_p else None, **kw).numpy()
    assert got.shape == (D_RAGGED,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # and the jnp oracles of the modes that have one
    wd = np.power(1.0 + w, np.float32(-0.5)) if discount == "poly" \
        else w
    oracle = {"fedsgd": lambda: jref.safl_agg_ref(u, wd, p, 0.3),
              "avg": lambda: jref.weighted_avg_ref(u, wd),
              "mix": lambda: jref.fedasync_flat_ref(u, wd, p),
              "sum": lambda: jref.weighted_sum_ref(u, wd)}[mode]()
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


def test_fold_chain_equals_aggregate_bitwise():
    """The port's streaming channel (K folds) equals its buffered channel
    (one sum-mode aggregate) bit for bit."""
    u, _, rng = _rows(5, D_RAGGED, seed=9)
    w = rng.uniform(0.5, 40.0, 5).astype(np.float32)
    acc = torch.zeros(D_RAGGED)
    for k in range(5):
        tk.safl_fold(acc, torch.from_numpy(u[k]), w[k], out=acc)
    agg = tk.safl_aggregate(torch.from_numpy(u), torch.from_numpy(w),
                            mode="sum")
    assert torch.equal(acc, agg)


def test_cpu_calls_are_plain_and_not_counted():
    u, p, rng = _rows(3, 777, seed=4)
    ut, pt = torch.from_numpy(u), torch.from_numpy(p)
    w = torch.from_numpy(rng.uniform(0.5, 4.0, 3).astype(np.float32))
    f0, a0 = tk.safl_fold.launches, tk.safl_aggregate.launches
    assert torch.equal(tk.safl_fold(pt, ut[0], 0.5),
                       tk.safl_fold_plain(pt, ut[0], 0.5))
    out = pt.clone()
    assert tk.safl_fold(out, ut[1], 0.25, out=out) is out
    assert torch.equal(out, tk.safl_fold_plain(pt, ut[1], 0.25))
    for mode in tk.MODES:
        assert torch.equal(
            tk.safl_aggregate(ut, w, pt, server_lr=0.3, mode=mode),
            tk.safl_aggregate_plain(ut, w, pt, server_lr=0.3, mode=mode))
    assert (tk.safl_fold.launches, tk.safl_aggregate.launches) == (f0, a0)
    assert (f0, a0) == (0, 0)


def test_aggregate_rejects_bad_arguments():
    u = torch.zeros(2, 8)
    w = torch.ones(2)
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, mode="median")
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, discount="hinge")
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, None, mode="fedsgd")
