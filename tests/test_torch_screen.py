"""The quantized screens' one-launch CUDA design, modelled on the CPU.

``screen_rows_q8`` and ``screen_rows_q4`` run one kernel a call on the
card (``csrc/safl_agg.cu`` ``screen_q_kernel``).  The kernel cannot run
here, so this file holds a plain model of its partition, written from the
package's constants (:data:`SCREEN_QWARPS`, :data:`SCREEN_WARP_BYTES`,
:func:`screen_q_chunks`): the exact int32 sum of q^2 over each
quantization block, each warp's terms ``(q2 * s) * s`` summed in block
order, each block of threads' warp sums in warp order, then the row's
last block's sum of the partials (strided per thread in index order, a
shuffle tree per warp, then the tree over the warp sums).  The model is
held against the plain versions and the reference's oracles on clean,
corrupted (the reference's applier: 64 bytes XOR 0x55 and an Inf scale),
Byzantine, all-zero and flipped-only rows (-8 nibbles on q4) at the
paper CNN's Dq = 2,155,008, its top-k upload's nk = 215,552 and a
ragged Dq = 4,608: isfinite verdicts exact, finite sums within
``rtol=1e-5`` (the orders differ).  The kernel's nibble sign extension,
``(n ^ 8) - 8`` per byte of a 32-bit word, is checked against
``unpack_q4_ref`` for every byte value, and the .cu constants against
the Python ones that size the scratch.  ``chip_smoke.py`` holds the
kernel itself against the plain versions on the card.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

QB = 512
#: (wire, lanes per row): the paper CNN's quantized row, its top-k
#: upload's kept lanes at 0.1 (q8 values), and a ragged row of 9 blocks
SHAPES = (("q8", 2_155_008), ("q8", 215_552), ("q8", 4_608),
          ("q4", 2_155_008), ("q4", 4_608))
CU = Path(tk.__file__).resolve().parent / "csrc" / "safl_agg.cu"


def _lanes(row: np.ndarray, packed: bool) -> np.ndarray:
    """A row's int8 lanes; packed bytes sign-extended as the kernel does:
    each 32-bit word's low and high nibbles masked into their bytes,
    XOR 8, then 8 subtracted from each byte with wraparound (``__vsub4``);
    lane 2j is byte j's low nibble, 2j+1 its high one."""
    if not packed:
        return row.astype(np.int8)
    b = np.ascontiguousarray(row).view(np.uint8)
    pad = (-b.size) % 4
    w = np.concatenate([b, np.zeros(pad, np.uint8)]).view("<u4")
    out = []
    for half in (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F):
        x = (half ^ 0x08080808).astype("<u4").view(np.uint8)
        out.append((x - np.uint8(8)).view(np.int8)[:b.size])
    return np.stack(out, axis=-1).reshape(-1)


def _warp_sum(v: np.ndarray) -> np.float32:
    """Lane 0 of ``warp_sum``: the shuffle-down tree over 32 f32 lanes."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v[:off] = v[:off] + v[off:2 * off]
    return v[0]


def screen_model(row: np.ndarray, scales: np.ndarray, qblock: int,
                 packed: bool) -> np.float32:
    """The kernel's sum of squares of one quantized row, in its order."""
    nb = scales.size
    lanes = _lanes(row, packed).astype(np.int32)
    q2 = (lanes * lanes).reshape(nb, qblock).sum(axis=1, dtype=np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        terms = (q2.astype(np.float32) * scales) * scales
        bbytes = qblock // 2 if packed else qblock
        qpw = tk.screen_q_blocks(bbytes)
        chunks = tk.screen_q_chunks(nb, bbytes)
        nwarps = chunks * tk.SCREEN_QWARPS
        padded = np.zeros(nwarps * qpw, np.float32)
        padded[:nb] = terms
        padded = padded.reshape(nwarps, qpw)
        valid = (np.arange(nwarps * qpw) < nb).reshape(nwarps, qpw)
        acc = np.zeros(nwarps, np.float32)
        for j in range(qpw):  # each warp's blocks in order
            acc = np.where(valid[:, j], acc + padded[:, j], acc)
        acc = acc.reshape(chunks, tk.SCREEN_QWARPS)
        part = np.zeros(chunks, np.float32)
        for w in range(tk.SCREEN_QWARPS):  # a block's warps in order
            part = part + acc[:, w]
        threads = tk.SCREEN_QWARPS * 32
        per = np.zeros(threads, np.float32)
        for r in range(-(-chunks // threads)):  # strided, in index order
            i = r * threads + np.arange(threads)
            per = np.where(i < chunks,
                           per + part[np.minimum(i, chunks - 1)], per)
        warps = [_warp_sum(v) for v in per.reshape(tk.SCREEN_QWARPS, 32)]
        return _warp_sum(np.array(warps + [0.0] * (32 - len(warps)),
                                  np.float32))


def _rows(wire: str, dq: int, qblock: int, seed: int):
    """Five rows on ``wire``: clean, corrupted and Byzantine (the
    reference's applier), all zero, and a 0x55-flipped span under finite
    scales (on q4 it holds -8 nibbles, a level the quantizer never
    emits).  Returns (q int8 (5, Dq) or packed (5, Dq/2), scales)."""
    rng = np.random.default_rng(seed)
    k, nb = 5, dq // qblock
    if wire == "q8":
        x = rng.normal(size=(k * nb, qblock)).astype(np.float32)
        q, s = jref.quantize_ref(x)
        q = np.asarray(q).reshape(k, dq)
    else:
        q = np.asarray(jref.pack_q4_ref(
            rng.integers(-7, 8, size=(k, dq)).astype(np.int8)))
        s = rng.uniform(1e-3, 1.0, size=k * nb).astype(np.float32)
    s = np.asarray(s).reshape(k, nb)
    q, s = jfaults.apply_faults_q(q, s, [False, True, False, False, False],
                                  [False, False, True, False, False],
                                  np.float32([0.3, 0.37, 0.5, 0.1, 0.9]),
                                  10.0)
    q, s = np.array(q), np.array(s)
    q[3], s[3] = 0, 0.0
    q[4, 100:164] ^= 0x55
    if wire == "q4":
        assert (np.asarray(jref.unpack_q4_ref(q[4])) == -8).any()
    return q, s


def _assert_sums(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("wire,dq", SHAPES)
def test_kernel_model_matches_plain_and_reference(wire, dq):
    packed = wire == "q4"
    q, s = _rows(wire, dq, QB, seed=dq % 1000 + packed)
    model = np.array([screen_model(q[i], s[i], QB, packed)
                      for i in range(q.shape[0])], np.float32)
    plain = (tk.screen_rows_q4_plain if packed else tk.screen_rows_q8_plain)
    got = plain(torch.from_numpy(q), torch.from_numpy(s), qblock=QB)
    oracle = (jref.screen_sumsq_q4_ref if packed
              else jref.screen_sumsq_q8_ref)(q, s, QB)
    _assert_sums(model, got.numpy())
    _assert_sums(model, oracle)
    # clean, Byzantine and flipped rows finite; the corrupt row's Inf
    # scale poisons it; the zero row sums to 0
    np.testing.assert_array_equal(np.isfinite(model),
                                  [True, False, True, True, True])
    assert model[3] == 0.0 and model[4] > 0.0


@pytest.mark.parametrize("wire,qblock", [("q8", 16), ("q8", 128),
                                         ("q8", 2048), ("q4", 32),
                                         ("q4", 4096)])
def test_kernel_model_other_qblocks(wire, qblock):
    """Blocks narrower than a warp's load (several per load, reduced in
    lane groups) and wider (one block over several loads): the partition
    still takes every block once."""
    packed = wire == "q4"
    dq = 9 * 4096 + 2 * qblock  # ragged against every warp's span
    q, s = _rows(wire, dq, qblock, seed=qblock)
    model = np.array([screen_model(q[i], s[i], qblock, packed)
                      for i in range(q.shape[0])], np.float32)
    plain = (tk.screen_rows_q4_plain if packed else tk.screen_rows_q8_plain)
    _assert_sums(model, plain(torch.from_numpy(q), torch.from_numpy(s),
                              qblock=qblock).numpy())


def test_nibble_sign_extension_every_byte():
    """``(n ^ 8) - 8`` per byte, with wraparound, on the masked low and
    high nibbles of 32-bit words, against ``unpack_q4_ref`` (the
    reference's and the port's) for all 256 byte values."""
    b = np.arange(256, dtype=np.uint8).view(np.int8)
    got = _lanes(b, packed=True)
    np.testing.assert_array_equal(got, np.asarray(jref.unpack_q4_ref(b)))
    np.testing.assert_array_equal(
        got, tref.unpack_q4_ref(torch.from_numpy(b)).numpy())
    assert got.min() == -8 and got.max() == 7


def test_cu_constants_match_the_scratch_sizes():
    """The kernel's kScreenQWarps and kScreenQLoads (16-byte loads of 32
    lanes a warp) are the wrapper's, which size ``part``."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             src).group(1))
    assert const("kScreenQWarps") == tk.SCREEN_QWARPS
    assert const("kScreenQLoads") * 32 * 16 == tk.SCREEN_WARP_BYTES


@pytest.mark.parametrize("bbytes", [1, 16, 256, 512, 1024, 4096])
def test_screen_chunks_cover_every_block_once(bbytes):
    """A row of nb blocks in chunks of SCREEN_QWARPS warps of
    screen_q_blocks(bbytes) blocks each: enough chunks, none empty."""
    per = tk.SCREEN_QWARPS * tk.screen_q_blocks(bbytes)
    assert per * bbytes >= tk.SCREEN_QWARPS * min(bbytes,
                                                  tk.SCREEN_WARP_BYTES)
    for nb in (1, per - 1, per, per + 1, 421, 4209):
        chunks = tk.screen_q_chunks(nb, bbytes)
        assert (chunks - 1) * per < nb <= chunks * per
    # the main path's shapes: 527 blocks of threads on q8, 264 on q4, 53
    # on the top-k upload's values
    assert tk.screen_q_chunks(4209, 512) == 527
    assert tk.screen_q_chunks(4209, 256) == 264
    assert tk.screen_q_chunks(421, 512) == 53
