"""The q4 K-row aggregate's CUDA design, modelled on the CPU.

``safl_aggregate_q4`` runs one kernel a call on the card
(``csrc/safl_agg.cu`` ``aggregate_q4_kernel``): V lanes a thread over an
exact grid, the rows' words and scales loaded R rows at a time.  The
kernel cannot run here, so this file holds a plain model of it, written
from the .cu constants (checked against the source text):

* the lane partition (``agg_span``): vectors of V lanes from lane 0 and
  a scalar tail when the packed rows (buffer and row stride), ``p`` (in
  fedsgd / mix) and the output are vector-aligned and a qblock spans a
  vector, else every lane alone; it must cover every output lane
  exactly once, for the rows 0-15 bytes and ``p`` 0-3 lanes off, over D
  lanes (fedsgd / mix, D < Dq: a tail) and Dq lanes (avg / sum), and a
  vector's lanes must share one scale a row;
* a vector's levels made as floats from its words without a conversion
  (the bits 0x4B000000 | (nibble ^ 8) by a byte permute, less 2^23 +
  8), against
  ``unpack_q4_ref`` for every byte value;
* the weights: computed in parallel (thread j takes w_j), then summed by
  every thread in k order, which is ``load_weights``' serial order: the
  same w_j and the same sum bitwise;
* the aggregate itself, lane by lane through the partition, the rows in
  groups of R (each lane still summed in row order), every mode x
  discount (``none`` / ``poly``) x K in {1, 3, 4, 16}, with D < Dq in
  fedsgd / mix and rows holding -8 nibbles: bitwise
  ``safl_aggregate_q4_plain``, and within the kernel tests' ``TOL`` of the
  reference's Pallas ``safl_aggregate_q4`` (interpret mode) and its
  oracles ``safl_agg_q4_ref`` / ``weighted_avg_q4_ref``.

The poly discount's ``powf`` on the card may differ from ``torch.pow`` in
the last ulp, so ``chip_smoke.py`` holds the kernel with poly weights
bitwise against the parent kernel (``aggregate_kernel<Q4Rows>``) and
without them bitwise against the plain version.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import safl_agg as jk  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

CU = Path(tk.__file__).resolve().parent / "csrc" / "safl_agg.cu"
#: the kernel's kAggQ4Vec, kAggQ4Threads and kAggQ4Rows
VEC, THREADS, ROWS = 8, 128, 4
QB = 512
D_FULL, DQ_FULL = 2_154_730, 2_155_008
D_SMALL, DQ_SMALL = 4_099, 4_608
#: the kernel tests' tolerance against the reference (tests/test_torch_kernels.py)
TOL = dict(rtol=1e-5, atol=1e-5)
#: a 512-byte aligned base address for the rows' placements
BASE = 1 << 20
ALPHA, LR = 0.5, 0.3


def test_cu_constants_match_the_model():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kAggQ4Vec") == VEC
    assert const("kAggQ4Threads") == THREADS
    assert const("kAggQ4Rows") == ROWS


def agg_span(q_off: int, stride: int, p_off, out_off: int, n: int,
             qblock: int = QB, v: int = VEC):
    """``agg_span<Int4Lanes, V>``: (nv, tail) for the packed rows
    ``q_off`` bytes past a boundary with a row stride of ``stride``
    bytes, p ``p_off`` lanes off (None: the mode does not read p), out
    ``out_off`` lanes off and ``qblock``."""
    nb = v // 2  # bytes of one vector
    align = 4 * min(v, 4)
    vec = (qblock >= v and (BASE + q_off) % nb == 0 and stride % nb == 0
           and (BASE + 4 * out_off) % align == 0
           and (p_off is None or (BASE + 4 * p_off) % align == 0))
    nv = n // v if vec else 0
    return nv, v * nv


def lanes_of(span, n: int, v: int = VEC):
    """(vectors (nv, v) of lanes, tail lanes): thread i takes vector i and
    tail lane tail + i."""
    nv, tail = span
    return v * np.arange(nv)[:, None] + np.arange(v), tail + np.arange(
        n - tail)


@pytest.mark.parametrize("dq,qblock", [(DQ_SMALL, 512), (DQ_SMALL, 8),
                                       (DQ_SMALL, 4), (4_610, 2),
                                       (DQ_FULL, 512)])
@pytest.mark.parametrize("mode", ["fedsgd", "avg"])
def test_partition_covers_every_lane_once(mode, dq, qblock):
    """Every output lane in exactly one item for the rows 0-15 bytes and
    p 0-3 lanes off; vectors only where everything is aligned and a
    qblock spans a vector (never at qblock 4 or 2, whose row stride of
    2,305 bytes is odd besides); a vector's lanes in one qblock (one
    scale a row); the exact grid taking every item."""
    n = dq - 9 if mode == "fedsgd" else dq
    stride = dq // 2
    for q_off in range(16):
        for p_off in (range(4) if mode == "fedsgd" else (None,)):
            span = agg_span(q_off, stride, p_off, 0, n, qblock)
            nv, tail = span
            vectors, tails = lanes_of(span, n)
            seen = np.bincount(np.concatenate([vectors.reshape(-1), tails]),
                               minlength=n)
            assert seen.size == n and (seen == 1).all()
            aligned = q_off % (VEC // 2) == 0 and p_off in (0, None) \
                and stride % (VEC // 2) == 0 and qblock >= VEC
            assert (nv > 0) == aligned
            assert n - tail < VEC if aligned else tail == 0
            j0 = vectors[:, 0]
            qs = qblock.bit_length() - 1
            np.testing.assert_array_equal(vectors >> qs,
                                          np.repeat((j0 >> qs)[:, None],
                                                    VEC, axis=1))
            threads = max(nv, n - tail)
            blocks = max(1, -(-threads // THREADS))
            assert blocks * THREADS >= threads > (blocks - 1) * THREADS


def test_main_path_is_all_vectors():
    """The engine's SS round: aligned packed rows, params and output at
    the paper CNN's D: 269,341 vectors, a 2-lane tail, 2,105 blocks of
    128; SA's avg over Dq: no tail."""
    span = agg_span(0, DQ_FULL // 2, 0, 0, D_FULL)
    assert span == (D_FULL // VEC, D_FULL // VEC * VEC)
    assert D_FULL - span[1] == 2
    assert -(-span[0] // THREADS) == 2105
    assert agg_span(0, DQ_FULL // 2, None, 0, DQ_FULL) == (DQ_FULL // VEC,
                                                          DQ_FULL)


def levels_of_words(words: np.ndarray) -> np.ndarray:
    """``Int4Lanes::levels``: a word's low and high nibbles masked into
    their bytes and XORed with 8 (n + 8), then lane 2b from byte b of the
    low word and 2b + 1 of the high one, set under 0x4B (the byte
    permute): the float 2^23 + 8 + n, less 2^23 + 8 in f32."""
    words = words.astype("<u4")
    out = []
    for half in (words & 0x0F0F0F0F, (words >> 4) & 0x0F0F0F0F):
        x = (half ^ 0x08080808).astype("<u4").view(np.uint8).reshape(-1, 4)
        out.append(x.astype(np.uint32) | np.uint32(0x4B000000))
    bits = np.stack(out, axis=-1).reshape(-1).astype("<u4")
    return bits.view(np.float32) - np.float32(8388616.0)


def test_word_levels_every_byte():
    b = np.arange(256, dtype=np.uint8)
    got = levels_of_words(b.view("<u4"))
    assert got.dtype == np.float32
    want = np.asarray(jref.unpack_q4_ref(b.view(np.int8))).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() == -8 and got.max() == 7


def nibble(byte: np.ndarray, high: np.ndarray) -> np.ndarray:
    """``nibble``: the nibble shifted to the top of a 32-bit word, then
    back by an arithmetic shift."""
    w = (byte.astype(np.uint32) << np.where(high, 24, 28).astype(np.uint32))
    return (w.view(np.int32) >> 28).astype(np.int8)


def weights_model(w: np.ndarray, discount: str):
    """The kernel's weights: thread j computes w_j (discounted as
    ``load_weights`` discounts it, here by the plain version's pow), then
    every thread sums them in k order."""
    wv = torch.from_numpy(w.astype(np.float32))
    if discount == "poly":
        wv = torch.pow(1.0 + wv, -ALPHA)
    wv = wv.numpy()
    wsum = np.float32(0.0)
    for x in wv:
        wsum = np.float32(wsum + x)
    return wv, wsum


def aggregate_model(qp, s, w, p, mode, discount, qblock, q_off=0, p_off=0):
    """The kernel's output lane by lane through its partition: each
    vector's levels from its rows' words and one scale a row, the tail
    (and every lane where the partition has no vectors) by the scalar
    path, the rows in groups of
    ``ROWS`` (each lane summed in row order), then the mode's step."""
    k, stride = qp.shape
    dq = 2 * stride
    n = p.size if mode in ("fedsgd", "mix") else dq
    qs = qblock.bit_length() - 1
    wv, wsum = weights_model(w, discount)
    span = agg_span(q_off, stride, p_off if mode in ("fedsgd", "mix")
                    else None, 0, n, qblock)
    vectors, tails = lanes_of(span, n)
    lev = np.zeros((k, n), np.float32)
    sc = np.zeros((k, n), np.float32)
    j0 = vectors[:, 0]
    bytes_ = qp.view(np.uint8)
    for j in range(k):
        if j0.size:
            words = bytes_[j][(j0 >> 1)[:, None] + np.arange(VEC // 2)]
            lev[j, vectors.reshape(-1)] = levels_of_words(
                words.reshape(-1).view("<u4"))
            sc[j, vectors.reshape(-1)] = np.repeat(s[j][j0 >> qs], VEC)
        lev[j, tails] = nibble(bytes_[j][tails >> 1], tails & 1)
        sc[j, tails] = s[j][tails >> qs]
    acc = np.zeros(n, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for r0 in range(0, k, ROWS):
            for j in range(r0, min(r0 + ROWS, k)):
                acc = acc + wv[j] * (lev[j] * sc[j])
        wsafe = np.maximum(wsum, np.float32(1e-12))
        if mode == "fedsgd":
            return p - np.float32(LR) * (acc / wsafe)
        if mode == "avg":
            return acc / wsafe
        if mode == "mix":
            return (np.float32(1.0) - wsum) * p + acc
        return acc


def _inputs(k: int, mode: str, discount: str, seed: int):
    """Packed rows of random bytes (every nibble, -8 included, as a
    corrupted byte holds it), their scales, weights (staleness for
    poly, mix coefficients summing below 1) and D < Dq params."""
    rng = np.random.default_rng(seed)
    qp = rng.integers(-128, 128, size=(k, DQ_SMALL // 2)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, size=(k, DQ_SMALL // QB)).astype(np.float32)
    if discount == "poly":
        w = rng.integers(0, 6, k).astype(np.float32)
    elif mode == "mix":
        w = (rng.uniform(0.05, 0.9, k) / k).astype(np.float32)
    else:
        w = rng.uniform(0.5, 4.0, k).astype(np.float32)
    p = rng.normal(size=D_SMALL).astype(np.float32)
    return qp, s, w, p


def test_weights_parallel_then_k_order_is_the_serial_order():
    """w_j computed one a thread and summed k = 0..K-1 by every thread:
    bitwise ``load_weights``' serial loop (and the plain version's)."""
    rng = np.random.default_rng(3)
    for discount in ("none", "poly"):
        for k in (1, 3, 16, 300):
            w = (rng.integers(0, 6, k) if discount == "poly"
                 else rng.uniform(0.1, 4.0, k)).astype(np.float32)
            wv, wsum = weights_model(w, discount)
            serial = np.float32(0.0)
            for j in range(k):
                x = torch.from_numpy(w[j:j + 1])
                if discount == "poly":
                    x = torch.pow(1.0 + x, -ALPHA)
                assert x.numpy()[0].view(np.int32) == wv[j].view(np.int32)
                serial = np.float32(serial + x.numpy()[0])
            assert serial.view(np.int32) == wsum.view(np.int32)
            _, plain_sum = tk._weighted_sum_plain(
                torch.zeros((k, 1)), torch.from_numpy(w), ALPHA, discount)
            assert plain_sum.numpy().view(np.int32) == wsum.view(np.int32)


@pytest.mark.parametrize("k", [1, 3, 4, 16])
@pytest.mark.parametrize("discount", ["none", "poly"])
@pytest.mark.parametrize("mode", ["fedsgd", "avg", "mix", "sum"])
def test_model_matches_plain_reference_and_pallas(mode, discount, k):
    qp, s, w, p = _inputs(k, mode, discount, seed=100 * k + len(mode))
    needs_p = mode in ("fedsgd", "mix")
    kw = dict(server_lr=LR, mode=mode, alpha=ALPHA, discount=discount)
    plain = tk.safl_aggregate_q4_plain(
        torch.from_numpy(qp), torch.from_numpy(s), torch.from_numpy(w),
        torch.from_numpy(p) if needs_p else None, qblock=QB, **kw).numpy()
    assert plain.shape == ((D_SMALL,) if needs_p else (DQ_SMALL,))
    # the vector path (as in the engine) and the lane-by-lane one
    for q_off, p_off in ((0, 0), (1, 1)):
        model = aggregate_model(qp, s, w, p, mode, discount, QB, q_off,
                                p_off)
        np.testing.assert_array_equal(model.view(np.int32),
                                      plain.view(np.int32))
    pallas = np.asarray(jk.safl_aggregate_q4(
        qp, s, w, p if needs_p else None, qblock=QB, interpret=True, **kw))
    np.testing.assert_allclose(model, pallas, **TOL)
    wd = np.power(1.0 + w, np.float32(-ALPHA)) if discount == "poly" else w
    if mode == "fedsgd":
        np.testing.assert_allclose(
            model, np.asarray(jref.safl_agg_q4_ref(qp, s, wd, p, LR, QB)),
            **TOL)
    elif mode == "avg":
        np.testing.assert_allclose(
            model, np.asarray(jref.weighted_avg_q4_ref(qp, s, wd, QB)),
            **TOL)


@pytest.mark.parametrize("qblock", [2, 4, 8])
def test_model_narrow_qblocks_bitwise_plain(qblock):
    """qblocks below a vector of 8 lanes (every lane alone, its own
    scale) and at one (vectors, one scale a row)."""
    rng = np.random.default_rng(qblock)
    qp = rng.integers(-128, 128, size=(3, DQ_SMALL // 2)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, size=(3, DQ_SMALL // qblock)).astype(
        np.float32)
    w = rng.uniform(0.5, 4.0, 3).astype(np.float32)
    p = rng.normal(size=D_SMALL).astype(np.float32)
    plain = tk.safl_aggregate_q4_plain(
        *(torch.from_numpy(a) for a in (qp, s, w, p)), server_lr=LR,
        qblock=qblock).numpy()
    model = aggregate_model(qp, s, w, p, "fedsgd", "none", qblock)
    np.testing.assert_array_equal(model.view(np.int32), plain.view(np.int32))
