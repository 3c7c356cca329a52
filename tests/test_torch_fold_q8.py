"""The q8 fold's CUDA design, modelled on the CPU.

``safl_fold_q8`` runs one kernel a call on the card (``csrc/safl_agg.cu``
``fold_q8_kernel``), V = 4 lanes a thread over an exact grid.  The kernel
cannot run here, so this file holds a plain model of it, written from the
.cu constants (checked against the source text):

* the lane partition (``fold_span`` over int8 lanes): a scalar head up to
  the first lane whose byte sits on a V-byte boundary, when acc and out
  agree mod 16 bytes and acc is 16-byte aligned there; vectors of V
  lanes; a scalar tail; every lane alone where the rows disagree.  It
  must cover every lane exactly once for acc / out 0-3 lanes and the
  int8 row 0-15 bytes off their boundaries, Dq in {4,608, 2,155,008} and
  qblock in {4, 8, 512}, each vector's scales (two at most, split at the
  qblock boundary, or each lane's own below V) must be its lanes' own,
  and the exact grid must take every item;
* the int8 lanes of a vector's word, sign-extended byte by byte, against
  the int8 view for every byte value;
* the fold itself, lane by lane through the partition: bitwise
  ``safl_fold_q8_plain`` at beta 1 and 0.625, and within the kernel
  tests' ``TOL`` of the reference's oracle ``fold_q8_ref`` and its Pallas
  ``safl_fold_q8`` (interpret mode, at Dq = 4,608).

``chip_smoke.py`` holds the kernel itself against the plain version on
the card in 64 placements.
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
#: the kernel's kFoldQ8Vec and kFoldQ8Threads
VEC, THREADS = 4, 128
QB = 512
DQ_FULL, DQ_SMALL = 2_155_008, 4_608
#: the kernel tests' tolerance against the reference (tests/test_torch_kernels.py)
TOL = dict(rtol=1e-5, atol=1e-5)
#: a 256-byte aligned base address for the rows' placements
BASE = 1 << 20


def test_cu_constants_match_the_model():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kFoldQ8Vec") == VEC
    assert const("kFoldQ8Threads") == THREADS


def fold_q8_span(acc_off: int, out_off: int, q_off: int, dq: int,
                 v: int = VEC):
    """``fold_span<Int8Lanes, V>``: (head, nv, tail) for acc and out
    ``acc_off`` / ``out_off`` lanes and the int8 row ``q_off`` bytes past
    256-byte boundaries."""
    a, o, q = BASE + 4 * acc_off, 2 * BASE + 4 * out_off, 3 * BASE + q_off
    ka = min(v, 4)  # lanes of one acc load
    h = (v - q % v) % v
    ok = a % 4 == 0 and (a - o) % (4 * ka) == 0 and (a // 4 + h) % ka == 0
    head = min(h if ok else dq, dq)
    nv = (dq - head) // v
    return head, nv, head + v * nv


def items(span, dq: int, v: int = VEC):
    """The lanes thread i takes: (vectors (nv, v), head lanes, tail
    lanes)."""
    head, nv, tail = span
    vectors = head + v * np.arange(nv)[:, None] + np.arange(v)
    return vectors, np.arange(head), tail + np.arange(dq - tail)


def scales_of(j0: np.ndarray, qblock: int, v: int = VEC) -> np.ndarray:
    """The block of each lane of the vectors starting at ``j0`` as the
    kernel reads their scales (``vec_scales``): s0 / s1 split at the
    qblock boundary when qblock >= V, else each lane's own."""
    qs = qblock.bit_length() - 1
    lanes = np.arange(v)
    if qblock >= v:
        b0, b1 = j0 >> qs, (j0 + v - 1) >> qs
        split = ((b0 + 1) << qs) - j0
        return np.where(lanes < split[:, None], b0[:, None], b1[:, None])
    return (j0[:, None] + lanes) >> qs


@pytest.mark.parametrize("qblock", [4, 8, 512])
@pytest.mark.parametrize("dq", [DQ_SMALL, DQ_FULL])
@pytest.mark.parametrize("acc_off", [0, 1, 2, 3])
def test_partition_covers_every_lane_once(acc_off, dq, qblock):
    """acc and out at ``acc_off`` (in place) and, out of place, out one
    lane further; the int8 row 0-15 bytes off: every lane in exactly one
    item, vectors aligned, each vector's scales its lanes' own, and the
    exact grid taking every item."""
    for out_off in (acc_off, (acc_off + 1) % 4):
        for q_off in range(16):
            span = fold_q8_span(acc_off, out_off, q_off, dq)
            head, nv, tail = span
            vectors, heads, tails = items(span, dq)
            seen = np.bincount(np.concatenate(
                [vectors.reshape(-1), heads, tails]), minlength=dq)
            assert seen.size == dq and (seen == 1).all()
            assert head < VEC or (head == dq and nv == 0)
            assert dq - tail < VEC or (head == dq and tail == dq)
            if out_off != acc_off:
                assert (head, nv) == (dq, 0)  # out and acc disagree
            j0 = vectors[:, 0]
            assert ((acc_off + j0) % min(VEC, 4) == 0).all()  # acc / out
            assert ((q_off + j0) % VEC == 0).all()  # one aligned word
            qs = qblock.bit_length() - 1
            np.testing.assert_array_equal(scales_of(j0, qblock),
                                          vectors >> qs)
            threads = max(nv, len(heads), len(tails))
            blocks = max(1, -(-threads // THREADS))
            assert blocks * THREADS >= threads > (blocks - 1) * THREADS \
                or threads == 0


def test_main_path_is_all_vectors():
    """A bank row and an int8 upload row from aligned allocations at the
    paper CNN's Dq: no head, no tail, 4,209 blocks of 128."""
    span = fold_q8_span(0, 0, 0, DQ_FULL)
    assert span == (0, DQ_FULL // VEC, DQ_FULL)
    assert -(-span[1] // THREADS) == 4209


def lanes_of_words(words: np.ndarray) -> np.ndarray:
    """The kernel's int8 lanes of 32-bit words (``Int8Lanes::unpack``):
    lane l is byte l % 4 of word l / 4, shifted down and narrowed to int8
    (sign-extended)."""
    words = words.astype("<u4")
    shifts = (8 * np.arange(4)).astype(np.uint32)
    out = (words[:, None] >> shifts) & np.uint32(0xFF)
    return out.astype(np.uint8).view(np.int8).reshape(-1)


def test_word_lane_extension_every_byte():
    b = np.arange(256, dtype=np.uint8)
    got = lanes_of_words(b.view("<u4"))
    np.testing.assert_array_equal(got, b.view(np.int8))
    assert got.min() == -128 and got.max() == 127


def fold_model(acc, q, s, w, beta, qblock, acc_off=0, q_off=0):
    """The kernel's output lane by lane through its partition (in place:
    out at acc's offset): vectors' lanes from their words and their
    scales as the kernel reads them, the head and the tail by the scalar
    path."""
    dq = acc.size
    qs = qblock.bit_length() - 1
    span = fold_q8_span(acc_off, acc_off, q_off, dq)
    vectors, heads, tails = items(span, dq)
    n = np.zeros(dq, np.int8)
    sc = np.zeros(dq, np.float32)
    j0 = vectors[:, 0]
    if j0.size:
        raw = q.view(np.uint8)[j0[:, None] + np.arange(VEC)]
        n[vectors.reshape(-1)] = lanes_of_words(raw.reshape(-1).view("<u4"))
        sc[vectors.reshape(-1)] = s[scales_of(j0, qblock).reshape(-1)]
    for lanes in (heads, tails):
        n[lanes] = q[lanes]
        sc[lanes] = s[lanes >> qs]
    with np.errstate(invalid="ignore"):  # 0 * Inf: NaN, as on the card
        wv = np.float32(w) * (n.astype(np.float32) * sc)
        if np.float32(beta) == 1.0:
            return acc + wv
        return np.float32(beta) * acc + wv


def _row(dq: int, qblock: int, seed: int):
    """acc, an int8 row with every level (-128 included, as a corrupted
    byte holds it) and scales, one block's scale Inf and one 0."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=dq).astype(np.float32)
    q = rng.integers(-128, 128, size=dq).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, size=dq // qblock).astype(np.float32)
    s[1], s[-1] = np.inf, 0.0
    return acc, q, s


def _plain(acc, q, s, w, beta, qblock):
    return tk.safl_fold_q8_plain(torch.from_numpy(acc), torch.from_numpy(q),
                                 torch.from_numpy(s), w, beta,
                                 qblock=qblock).numpy()


@pytest.mark.parametrize("beta", [1.0, 0.625])
@pytest.mark.parametrize("dq", [DQ_SMALL, DQ_FULL])
def test_model_matches_plain_reference_and_pallas(dq, beta):
    acc, q, s = _row(dq, QB, seed=dq % 991)
    w = np.float32(0.37)
    plain = _plain(acc, q, s, w, beta, QB)
    for acc_off, q_off in ((0, 0), (2, 2), (1, 7), (3, 13), (1, 0)):
        model = fold_model(acc, q, s, w, beta, QB, acc_off, q_off)
        np.testing.assert_array_equal(model.view(np.int32),
                                      plain.view(np.int32))
    np.testing.assert_allclose(model, jref.fold_q8_ref(acc, q, s, w, QB,
                                                       beta), **TOL)
    if dq == DQ_SMALL:
        pallas = np.asarray(jk.safl_fold_q8(acc, q, s, w, beta, qblock=QB,
                                            interpret=True))
        np.testing.assert_allclose(model, pallas, **TOL)


@pytest.mark.parametrize("qblock", [2, 4, 8])
def test_model_narrow_qblocks_bitwise_plain(qblock):
    """qblocks below a vector (each lane's own scale) and at one (two
    scales a vector where a head shifts it across a boundary)."""
    acc, q, s = _row(DQ_SMALL, qblock, seed=qblock)
    plain = _plain(acc, q, s, 0.37, 1.0, qblock)
    for acc_off, q_off in ((0, 0), (1, 1), (3, 3), (2, 6)):
        model = fold_model(acc, q, s, 0.37, 1.0, qblock, acc_off, q_off)
        np.testing.assert_array_equal(model.view(np.int32),
                                      plain.view(np.int32))
