"""xLSTM (``repro_torch.models.xlstm``; the reduced xlstm-125m: 2 layers,
one mLSTM / sLSTM pair, d_model 256; f32) against the reference on the
CPU:

  * ``init`` bitwise (the sLSTM's recurrent weights divided by the f32
    ``np.sqrt(hd)``);
  * prefill and 8 decode steps within ``atol=rtol=1e-4``, the mLSTM's
    closed-form states and the sLSTM's carry handed to decode;
  * the mLSTM's parallel form, its final state and its recurrent decode,
    and the sLSTM's scan, against the reference's functions;
  * the closed-form final state equal to running the recurrent decode
    over every position, and the parallel form's outputs equal to the
    recurrent form's (the two forms the reference's property tests tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

ARCH = "xlstm-125m"


def test_init_matches_reference_key():
    zc.check_init(ARCH)


@pytest.mark.parametrize("S", [32, 200])
def test_prefill_and_decode(S):
    zc.check_prefill_decode(ARCH, S)


def _cells():
    jcfg, tcfg, _, jp, tm = zc.cached_setup(ARCH)
    mj = jax.tree_util.tree_map(lambda a: a[0], jp["mblocks"])["cell"]
    sj = jax.tree_util.tree_map(lambda a: a[0], jp["sblocks"])["cell"]
    return (jcfg, tcfg, mj, tm.mblocks[0].tree["cell"], sj,
            tm.sblocks[0].tree["cell"])


def test_mlstm_forms_match_reference():
    jcfg, tcfg, mj, mt, _, _ = _cells()
    H = tcfg.n_heads
    x = np.random.default_rng(1).standard_normal(
        (2, 24, 2 * tcfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        yt = tx.mlstm_parallel(mt, torch.from_numpy(x), H)
        st = tx.mlstm_final_state(mt, torch.from_numpy(x), H)
    np.testing.assert_allclose(yt.numpy(), np.asarray(
        jx.mlstm_parallel(mj, jnp.asarray(x), H)), **zc.TOL)
    sj = jx.mlstm_final_state(mj, jnp.asarray(x), H)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **zc.TOL)
    x1 = x[:, :1]
    with torch.inference_mode():
        ht, st2 = tx.mlstm_decode(mt, torch.from_numpy(x1), st, H)
    hj, sj2 = jx.mlstm_decode(mj, jnp.asarray(x1), sj, H)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **zc.TOL)
    for a, b in zip(st2, sj2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **zc.TOL)


def test_mlstm_parallel_is_the_recurrence():
    _, tcfg, _, mt, _, _ = _cells()
    H, D, S = tcfg.n_heads, 2 * tcfg.d_model, 20
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, S, D)).astype(np.float32))
    hd = D // H
    state = (torch.zeros((1, H, hd, hd)), torch.zeros((1, H, hd)),
             torch.full((1, H), -1e30))
    with torch.inference_mode():
        par = tx.mlstm_parallel(mt, x, H)
        closed = tx.mlstm_final_state(mt, x, H)
        hs = []
        for t in range(S):
            h, state = tx.mlstm_decode(mt, x[:, t:t + 1], state, H)
            hs.append(h)
    np.testing.assert_allclose(torch.cat(hs, 1).numpy(), par.numpy(),
                               atol=1e-4, rtol=1e-4)
    # the states agree up to the common stabiliser exp(m)
    for a, b in zip(state[:2], closed[:2]):
        scale = torch.exp(state[2] - closed[2]).reshape(
            1, H, *([1] * (a.dim() - 2)))
        np.testing.assert_allclose((a * scale).numpy(), b.numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_slstm_scan_matches_reference():
    jcfg, tcfg, _, _, sj, st = _cells()
    x = np.random.default_rng(3).standard_normal(
        (2, 30, tcfg.d_model)).astype(np.float32)
    yj, cj = jx.slstm_scan(sj, jnp.asarray(x), tx.SLSTM_HEADS)
    with torch.inference_mode():
        yt, ct = tx.slstm_scan(st, torch.from_numpy(x), tx.SLSTM_HEADS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **zc.TOL)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **zc.TOL)
