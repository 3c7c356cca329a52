"""Mamba2 (``repro_torch.models.ssm``) and the zamba2 hybrid (reduced: 4
layers, the shared attention every 2nd, state 16, head dim 32, chunk 16;
f32 compute) against the reference on the CPU:

  * ``A_log`` bitwise the reference's ``log(linspace(1, 16, H))`` at the
    reduced H (16) and the full H (80) and others, made on the host in
    XLA's formula;
  * ``init`` bitwise; prefill (200 is no multiple of the chunk: the
    chunk falls back to 10) and 8 decode steps within ``atol=rtol=1e-4``;
  * ``ssd_forward`` and its returned state against the reference at
    prompts where the chunk divides S, where it falls back, and shorter
    than the conv kernel (the conv state's left padding); a decode step
    from that state against the reference's;
  * chunked prefill equal to token-by-token decode from zeros (the two
    forms of the one recurrence).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

ARCH = "zamba2-2.7b"


@pytest.mark.parametrize("H", [16, 80, 7, 2, 160])
def test_a_log_bitwise(H):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, H)).astype(
        jnp.float32))
    np.testing.assert_array_equal(tssm.a_log(H).view(np.int32),
                                  want.view(np.int32))


def test_init_matches_reference_key():
    zc.check_init(ARCH)


@pytest.mark.parametrize("S", [32, 200])
def test_prefill_and_decode(S):
    zc.check_prefill_decode(ARCH, S)


def _layer():
    jcfg, tcfg, _, jp, tm = zc.cached_setup(ARCH)
    pj = jax.tree_util.tree_map(lambda a: a[0, 0], jp["mamba"])["ssm"]
    pt = tm.mamba[0].tree["ssm"]
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("S", [48, 37, 3])
def test_ssd_forward_and_state(S):
    jcfg, tcfg, pj, pt = _layer()
    u = np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    yj, sj = jssm.ssd_forward(pj, jcfg, jnp.asarray(u), return_state=True)
    with torch.inference_mode():
        yt, st = tssm.ssd_forward(pt, tcfg, torch.from_numpy(u),
                                  return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **zc.TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   **zc.TOL, err_msg=k)
    x1 = np.random.default_rng(S + 1).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32)
    yj, sj = jssm.ssd_decode_step(pj, jcfg, jnp.asarray(x1), sj)
    with torch.inference_mode():
        yt, st = tssm.ssd_decode_step(pt, tcfg, torch.from_numpy(x1), st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **zc.TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(sj["ssm"]),
                               **zc.TOL)


def test_chunked_prefill_is_the_recurrence():
    _, tcfg, _, pt = _layer()
    S = 40
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, S, tcfg.d_model)).astype(np.float32))
    DI, N, H, P = tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_heads, \
        tcfg.ssm_head_dim
    with torch.inference_mode():
        y, st = tssm.ssd_forward(pt, tcfg, u, return_state=True)
        state = {"ssm": torch.zeros((1, H, P, N)),
                 "conv": torch.zeros((1, tcfg.ssm_conv - 1, DI + 2 * N))}
        ys = []
        for t in range(S):
            yt, state = tssm.ssd_decode_step(pt, tcfg, u[:, t:t + 1], state)
            ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               **zc.TOL)
    np.testing.assert_allclose(state["ssm"].numpy(), st["ssm"].numpy(),
                               **zc.TOL)


def test_full_width_shapes():
    """The full zamba2's Mamba2 widths: d_inner 5120, 80 heads of 64."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.hd) == (5120, 80, 80)
    p = tssm.ssm_init(np.zeros(2, np.uint32), dataclasses.replace(cfg),
                      torch.float32, "meta")
    assert tuple(p["in_proj"].shape) == (2560, 2 * 5120 + 2 * 64 + 80)
