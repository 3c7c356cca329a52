"""The q4 fold's CUDA design, modelled on the CPU.

``safl_fold_q4`` runs one kernel a call on the card (``csrc/safl_agg.cu``
``fold_q4_kernel``), V = 4 lanes a thread over an exact grid.  The kernel
cannot run here, so this file holds a plain model of it, written from the
.cu constants (checked against the source text):

* the lane partition (``fold_q4_span``): a scalar head up to the first
  lane whose packed bytes sit on a V/2-byte boundary, when acc and out
  agree mod 16 bytes and acc is 16-byte aligned there; vectors of V
  lanes; a scalar tail; every lane alone where the rows disagree.  It
  must cover every lane exactly once for acc / out 0-3 lanes and the
  packed row 0-15 bytes off their boundaries, Dq in {4,608, 2,155,008}
  and qblock in {2, 4, 8, 512}, each vector's scales (two at most, split
  at the qblock boundary, or each lane's own below V) must be its lanes'
  own, and the exact grid must take every item;
* the nibbles of a vector's packed bytes, zero-extended to a 32-bit
  word, sign-extended as the kernel does ((n ^ 8)
  - 8 per byte of the masked low and high nibbles, ``__vsub4``), against
  ``unpack_q4_ref`` for every byte value;
* the fold itself, lane by lane through the partition: bitwise
  ``safl_fold_q4_plain`` at beta 1 and 0.625, and within the kernel
  tests' ``TOL`` of the reference's oracle ``fold_q4_ref`` and its Pallas
  ``safl_fold_q4`` (interpret mode).

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
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

CU = Path(tk.__file__).resolve().parent / "csrc" / "safl_agg.cu"
#: the kernel's kFoldQ4Vec and kFoldQ4Threads
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
    assert const("kFoldQ4Vec") == VEC
    assert const("kFoldQ4Threads") == THREADS


def fold_q4_span(acc_off: int, out_off: int, qp_off: int, dq: int,
                 v: int = VEC):
    """``fold_q4_span``: (head, nv, tail) for acc and out ``acc_off`` /
    ``out_off`` lanes and the packed row ``qp_off`` bytes past 256-byte
    boundaries."""
    a, o, q = BASE + 4 * acc_off, 2 * BASE + 4 * out_off, 3 * BASE + qp_off
    ka = min(v, 4)  # lanes of one acc load
    h = (v - 2 * (q % (v // 2))) % v
    ok = a % 4 == 0 and (a - o) % (4 * ka) == 0 and (a // 4 + h) % ka == 0
    head = min(h if ok else dq, dq)
    nv = (dq - head) // v
    return head, nv, head + v * nv


def items(span, dq: int, v: int = VEC):
    """The lanes thread i takes: (vectors (nv, v), head lanes, tail
    lanes), each thread index with its lanes."""
    head, nv, tail = span
    vectors = head + v * np.arange(nv)[:, None] + np.arange(v)
    return vectors, np.arange(head), tail + np.arange(dq - tail)


def scales_of(j0: np.ndarray, qblock: int, v: int = VEC) -> np.ndarray:
    """The block of each lane of the vectors starting at ``j0`` as the
    kernel reads their scales: s0 / s1 split at the qblock boundary when
    qblock >= V, else each lane's own."""
    qs = qblock.bit_length() - 1
    lanes = np.arange(v)
    if qblock >= v:
        b0, b1 = j0 >> qs, (j0 + v - 1) >> qs
        split = ((b0 + 1) << qs) - j0
        return np.where(lanes < split[:, None], b0[:, None], b1[:, None])
    return (j0[:, None] + lanes) >> qs


@pytest.mark.parametrize("qblock", [2, 4, 8, 512])
@pytest.mark.parametrize("dq", [DQ_SMALL, DQ_FULL])
@pytest.mark.parametrize("acc_off", [0, 1, 2, 3])
def test_partition_covers_every_lane_once(acc_off, dq, qblock):
    """acc and out at ``acc_off`` (in place) and, out of place, out one
    lane further; the packed row 0-15 bytes off: every lane in exactly
    one item, vectors aligned, each vector's scales its lanes' own, and
    the exact grid taking every item."""
    for out_off in (acc_off, (acc_off + 1) % 4):
        for qp_off in range(16):
            span = fold_q4_span(acc_off, out_off, qp_off, dq)
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
            assert ((qp_off + j0 // 2) % (VEC // 2) == 0).all()  # one word
            assert (j0 % 2 == 0).all()
            qs = qblock.bit_length() - 1
            np.testing.assert_array_equal(scales_of(j0, qblock),
                                          vectors >> qs)
            threads = max(nv, len(heads), len(tails))
            blocks = max(1, -(-threads // THREADS))
            assert blocks * THREADS >= threads > (blocks - 1) * THREADS \
                or threads == 0


def test_main_path_is_all_vectors():
    """A bank row and a packed upload row from aligned allocations at the
    paper CNN's Dq: no head, no tail, 4,209 blocks of 128."""
    span = fold_q4_span(0, 0, 0, DQ_FULL)
    assert span == (0, DQ_FULL // VEC, DQ_FULL)
    assert -(-span[1] // THREADS) == 4209


def nibbles_of_words(words: np.ndarray) -> np.ndarray:
    """The kernel's lanes of 32-bit words (8 a word): the low and high
    nibbles masked into their bytes, XOR 8, minus 8 per byte with
    wraparound; lane 2b from byte b of the low word, 2b + 1 of the high
    one."""
    words = words.astype("<u4")
    out = []
    for half in (words & 0x0F0F0F0F, (words >> 4) & 0x0F0F0F0F):
        x = (half ^ 0x08080808).astype("<u4").view(np.uint8)
        out.append((x - np.uint8(8)).view(np.int8).reshape(-1, 4))
    return np.stack(out, axis=-1).reshape(-1)


def nibble(byte: np.ndarray, high: np.ndarray) -> np.ndarray:
    """The scalar lanes' ``nibble``: the nibble shifted to the top of a
    32-bit word, then back by an arithmetic shift."""
    w = (byte.astype(np.uint32) << np.where(high, 24, 28).astype(np.uint32))
    return (w.view(np.int32) >> 28).astype(np.int8)


def test_word_nibble_extension_every_byte():
    b = np.arange(256, dtype=np.uint8)
    got = nibbles_of_words(b.view("<u4"))
    np.testing.assert_array_equal(got, np.asarray(jref.unpack_q4_ref(
        b.view(np.int8))))
    np.testing.assert_array_equal(
        got, tref.unpack_q4_ref(torch.from_numpy(b.view(np.int8))).numpy())
    lanes = np.arange(512)
    np.testing.assert_array_equal(nibble(b[lanes >> 1], lanes & 1), got)
    assert got.min() == -8 and got.max() == 7


def fold_model(acc, qp, s, w, beta, qblock, acc_off=0, qp_off=0):
    """The kernel's output lane by lane through its partition (in place:
    out at acc's offset): vectors' nibbles from their packed words and
    their scales as the kernel reads them, the head and the tail by the
    scalar path."""
    dq = acc.size
    qs = qblock.bit_length() - 1
    span = fold_q4_span(acc_off, acc_off, qp_off, dq)
    vectors, heads, tails = items(span, dq)
    n = np.zeros(dq, np.int8)
    sc = np.zeros(dq, np.float32)
    j0 = vectors[:, 0]
    if j0.size:
        # each vector's V/2 packed bytes in one load, zero-extended to
        # whole 32-bit words
        nb = VEC // 2
        words = np.zeros((j0.size, -(-nb // 4) * 4), np.uint8)
        words[:, :nb] = qp.view(np.uint8)[(j0 >> 1)[:, None] + np.arange(nb)]
        n[vectors.reshape(-1)] = nibbles_of_words(
            words.reshape(-1).view("<u4")).reshape(j0.size, -1)[:, :VEC]\
            .reshape(-1)
        sc[vectors.reshape(-1)] = s[scales_of(j0, qblock).reshape(-1)]
    for lanes in (heads, tails):
        n[lanes] = nibble(qp.view(np.uint8)[lanes >> 1], lanes & 1)
        sc[lanes] = s[lanes >> qs]
    with np.errstate(invalid="ignore"):  # 0 * Inf: NaN, as on the card
        wv = np.float32(w) * (n.astype(np.float32) * sc)
        if np.float32(beta) == 1.0:
            return acc + wv
        return np.float32(beta) * acc + wv


def _row(dq: int, qblock: int, seed: int):
    """acc, a packed row with every nibble (-8 included, as a corrupted
    byte holds it) and scales, one block's scale Inf and one 0."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=dq).astype(np.float32)
    qp = rng.integers(-128, 128, size=dq // 2).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, size=dq // qblock).astype(np.float32)
    s[1], s[-1] = np.inf, 0.0
    return acc, qp, s


@pytest.mark.parametrize("beta", [1.0, 0.625])
@pytest.mark.parametrize("dq", [DQ_SMALL, DQ_FULL])
def test_model_matches_plain_reference_and_pallas(dq, beta):
    acc, qp, s = _row(dq, QB, seed=dq % 997)
    w = np.float32(0.37)
    plain = tk.safl_fold_q4_plain(torch.from_numpy(acc), torch.from_numpy(qp),
                                  torch.from_numpy(s), w, beta,
                                  qblock=QB).numpy()
    oracle = np.asarray(jref.fold_q4_ref(acc, qp, s, w, QB, beta))
    pallas = np.asarray(jk.safl_fold_q4(acc, qp, s, w, beta, qblock=QB,
                                        interpret=True))
    for acc_off, qp_off in ((0, 0), (2, 1), (1, 5), (3, 14), (1, 0)):
        model = fold_model(acc, qp, s, w, beta, QB, acc_off, qp_off)
        np.testing.assert_array_equal(model.view(np.int32),
                                      plain.view(np.int32))
    np.testing.assert_allclose(model, oracle, **TOL)
    np.testing.assert_allclose(model, pallas, **TOL)


@pytest.mark.parametrize("qblock", [2, 4, 8])
def test_model_narrow_qblocks_bitwise_plain(qblock):
    """qblocks below a vector (each lane's own scale) and at one (two
    scales a vector where a head shifts it across a boundary)."""
    acc, qp, s = _row(DQ_SMALL, qblock, seed=qblock)
    plain = tk.safl_fold_q4_plain(torch.from_numpy(acc), torch.from_numpy(qp),
                                  torch.from_numpy(s), 0.37, 1.0,
                                  qblock=qblock).numpy()
    for acc_off, qp_off in ((0, 0), (1, 1), (3, 3), (2, 7)):
        model = fold_model(acc, qp, s, 0.37, 1.0, qblock, acc_off, qp_off)
        np.testing.assert_array_equal(model.view(np.int32),
                                      plain.view(np.int32))
