"""The q8 wire in the port against the reference, on the CPU: the
quantizer and the codec's emit programs (bitwise), byte accounting
(exact), the quantized buffers, and the engine in SS/SA/AS/AA with
``wire="q8"`` against the reference's sequential engine.

Tolerances.  Quantized bytes, scales and error-feedback residuals: bitwise
(the same f32 input gives the same int8 row).  Engine: bytes, staleness,
participation and simulated time exact, accuracy within 2 test samples,
and params within the reference's own q8 bound (``tests/
test_quantized_channel.py``): ||p_port - p_ref|| <= 2e-2 * ||p_ref - p_0||.
The reference's CPU q8 mean folds 1/sum(w) and each block's scale into one
coefficient, the port dequantizes first (as the Pallas kernel does), so
the two runs differ by an ulp now and then, and an ulp can move a later
upload across an int8 rounding boundary (one quantization level; the
largest relative difference seen here is 1.3e-4).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import flatbuf as tflatbuf  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from test_torch_modes import (KW, N_TEST, assert_host_exact,  # noqa: E402
                              assert_same_summary, fl_sim_pair,
                              flat_reference, run_pair, setup)  # noqa: F401


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    start = {"c1": rng.normal(size=(3, 3, 3, 4)),
             "b1": rng.normal(size=(700,)),
             "f1": rng.normal(size=(33, 5))}
    start = {k: v.astype(np.float32) for k, v in start.items()}
    end = {k: (v * 0.9 - 0.01 * rng.normal(size=v.shape)).astype(np.float32)
           for k, v in start.items()}
    return start, end


def _codecs(tree, qblock):
    j = jflatbuf.PytreeCodec({k: jnp.asarray(v) for k, v in tree.items()},
                             qblock=qblock)
    t = tflatbuf.PytreeCodec({k: torch.from_numpy(v)
                              for k, v in tree.items()}, qblock=qblock)
    return j, t


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 300.0])
def test_quantize_ref_matches_reference_bitwise(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 1000)
    x = (rng.normal(size=(40, 512)) * scale).astype(np.float32)
    x[3] = 0.0  # an all-zero block takes the 1e-12 floor
    x[5, ::7] = np.float32(127.5) * np.float32(scale)  # exact ties
    # jitted, as the reference's codec runs it: XLA then multiplies
    # absmax by the f32 reciprocal of 127 instead of dividing by 127
    qj, sj = jax.jit(jref.quantize_ref)(jnp.asarray(x))
    qt, st = tref.quantize_ref(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("qblock", [64, 512])
def test_codec_q8_programs_match_reference_bitwise(qblock):
    start, end = _trees(qblock)
    jc, tc = _codecs(start, qblock)
    assert (tc.d, tc.dq, tc.n_qblocks, tc.qblock) == \
        (jc.d, jc.dq, jc.n_qblocks, jc.qblock)
    res = (np.random.default_rng(1).normal(size=jc.dq) * 1e-3).astype(
        np.float32)
    cases = [
        (jc.ravel_delta_q8(_jt(start), _jt(end), 0.05, jnp.asarray(res)),
         tc.ravel_delta_q8(_tt(start), _tt(end), 0.05,
                           torch.from_numpy(res))),
        (jc.ravel_delta_q8_nores(_jt(start), _jt(end), 0.05),
         tc.ravel_delta_q8_nores(_tt(start), _tt(end), 0.05)),
        (jc.ravel_q8_nores(_jt(end)), tc.ravel_q8_nores(_tt(end))),
    ]
    for want, got in cases:
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # error feedback: what the wire dropped is carried, to an f32 rounding
    q, s, new_res = cases[0][1]
    x = torch.nn.functional.pad(tc.ravel_delta(_tt(start), _tt(end), 0.05),
                                (0, tc.dq - tc.d)) + torch.from_numpy(res)
    deq = tref.dequant_flat_ref(q, s, qblock)
    np.testing.assert_allclose((deq + new_res).numpy(), x.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_zero_residual_matches_reference():
    start, _ = _trees()
    jc, tc = _codecs(start, 512)
    zj, zt = np.asarray(jc.zero_residual()), tc.zero_residual("cpu")
    assert zt.shape == zj.shape == (jc.dq,) and zt.dtype == torch.float32
    np.testing.assert_array_equal(zt.numpy(), zj)
    assert not zt.any()


def test_payload_nbytes_and_wires_match_reference():
    assert tquant.WIRES == jquant.WIRES and tquant.BLOCK == jquant.BLOCK
    for d in (1, 511, 512, 2_154_730):
        dq = -(-d // 512) * 512
        kw = dict(d=d, dq=dq, n_qblocks=dq // 512, nk=dq // 10,
                  nk_qblocks=max(1, dq // 5120))
        for wire in tquant.WIRES:
            assert tquant.payload_nbytes(wire, **kw) == \
                jquant.payload_nbytes(wire, **kw)
    with pytest.raises(ValueError):
        tquant.payload_nbytes("q2", d=8)


def test_quant_buffer_matches_reference_layout():
    jb = jflatbuf.QuantBuffer(3, 1100, 512)
    tb = tflatbuf.QuantBuffer(3, 1100, 512, device="cpu")
    assert (tb.dq, tb.n_qblocks) == (jb.dq, jb.n_qblocks)
    for (a, b) in zip(tb.views, jb.views):
        assert tuple(a.shape) == tuple(b.shape)
        assert not a.any()
    q = torch.arange(tb.dq, dtype=torch.int64).remainder(255).sub(127).to(
        torch.int8)
    s = torch.linspace(0.1, 1.0, tb.n_qblocks)
    tb.write(q, s, 1)
    assert torch.equal(tb.q[1], q) and torch.equal(tb.scales[1], s)
    assert not tb.q[0].any() and not tb.q[2].any()


# ---------------------------------------------------------------------------
# the engine, against the reference's sequential engine
# ---------------------------------------------------------------------------


def _assert_q8_params_close(teng, jres, p_j):
    """The reference's bound, then a tighter one: an engine that drops
    each client's new error-feedback residual reads 9.0e-3 to 4.5e-2 here
    (three of its four gradient runs pass 2e-2), the sound port at most
    1.3e-4, so 1e-3 separates them."""
    ref = flat_reference(jres)
    p0 = np.concatenate([np.asarray(p_j[k]).ravel() for k in sorted(p_j)])
    rel = np.linalg.norm(teng._flat_params.numpy() - ref) / \
        np.linalg.norm(ref - p0)
    assert rel <= 2e-2, rel
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("setting", ["SS", "SA", "AS", "AA"])
def test_engine_q8_matches_reference(setup, setting):
    jeng, jres, teng, tres = run_pair(setup, setting, wire="q8")
    assert_host_exact(jeng, jres, teng, tres)
    _assert_q8_params_close(teng, jres, setup[2])


@pytest.mark.parametrize("setting,agg", [("SS", "sdga"), ("AS", "fedasync"),
                                         ("AS", "fedopt")])
def test_engine_q8_new_modes_match_reference(setup, setting, agg):
    jeng, jres, teng, tres = run_pair(setup, setting, wire="q8",
                                      aggregation=agg)
    assert_host_exact(jeng, jres, teng, tres)
    _assert_q8_params_close(teng, jres, setup[2])


def test_engine_q8_without_error_feedback_matches_reference(setup):
    jeng, jres, teng, tres = run_pair(setup, "AS", wire="q8",
                                      error_feedback=False)
    assert_host_exact(jeng, jres, teng, tres)
    assert not teng._residuals
    _assert_q8_params_close(teng, jres, setup[2])


def _engine(setup, setting, **kw):
    shards, te, p_j, _ = setup
    cfg = dataclasses.replace(tpaper.MODES[setting], server_lr=0.05,
                              batch_clients=False, **KW, **kw)
    return TEngine(cfg, tcnn.cnn_apply, "image",
                   params_from_jax(jax.tree_util.tree_map(np.asarray, p_j),
                                   "cpu"), {}, shards, te.x[:N_TEST],
                   te.y[:N_TEST], device="cpu")


def test_engine_q8_channels_and_compress_alias_bitwise(setup):
    """AS on q8: the streaming channel equals the buffered one bit for bit,
    and ``compress_updates=True`` is the same run as ``wire="q8"``; the
    q8 upload costs about a quarter of the f32 one."""
    flats = []
    for kw in (dict(wire="q8"), dict(wire="q8", server_channel="buffered"),
               dict(compress_updates=True)):
        eng = _engine(setup, "AS", **kw)
        eng.run(3)
        flats.append(eng._flat_params)
        assert eng._server.wire == "q8"
    assert torch.equal(flats[0], flats[1])
    assert torch.equal(flats[0], flats[2])
    e32, e8 = _engine(setup, "AS"), _engine(setup, "AS", wire="q8")
    ratio = e32._upload_nbytes() / e8._upload_nbytes()
    assert 3.8 < ratio < 4.0, ratio


@pytest.mark.parametrize("flags", [["--wire", "q8"], ["--compress"]])
def test_fl_sim_q8_summary_matches_reference(tmp_path, monkeypatch, capsys,
                                             flags):
    j, t = fl_sim_pair(tmp_path, monkeypatch, capsys,
                       ["--rounds", "2", "--samples", "240", "--clients",
                        "5", "--k", "2", "--mode", "sync", "--aggregation",
                        "sdga", *flags])
    assert_same_summary(j, t)
