"""``quantize_int8``'s CUDA design, modelled on the CPU.

``quantize_int8`` runs one kernel a call on the card (``csrc/quantize.cu``):
at B = 512, the package's only width, with x's rows 16-byte and q's rows
4-byte aligned, ``quantize_int8_b512_kernel``, one warp a row with the
row held in registers (each lane's float4 loads issued first, its absmax
an integer max of the |x| bits, the lanes' maxima combined by xor
shuffles, each float4's four levels made without a conversion and packed
into one 32-bit store, a row with a non-finite scale stored as zeros);
any other B or a misaligned row takes
``quantize_int8_kernel`` (one warp a row, the row read twice).  The
kernels cannot run here, so this file holds a plain model of them,
written from the .cu constants and the host's route (checked against the
source text):

* the host's route: the B = 512 kernel or the general one, by B and by
  x's and q's offsets;
* the B = 512 kernel's layout (G lanes a row, RW rows a lane group, T
  threads a block): every float4 of every row loaded by exactly one lane
  and its packed word stored by the same lane, lane l of a row's group
  taking lanes 4l .. 4l+3 of each slice of 4G lanes, over R in {1, 7, 8,
  9, 37, 4,209}, for the package's shape and every shape timed beside it;
* the byte order of a packed word: lane 4m + b of a float4 at byte b,
  as the byte permutes gather the levels' low bytes;
* both kernels' q and s, lane-group maxima through the shuffle tree:
  bitwise ``quantize_int8_plain`` and the reference's Pallas
  ``quantize_int8`` (interpret mode), on rows holding zero rows, exact
  +-0.5 ties, +-127 saturation, NaN rows and -Inf rows (NaN and Inf
  scales in the same rows; their lanes store 0).

``dequantize_int8`` likewise runs one kernel a call: at B = 512 with q's
rows 4-byte and the output's 16-byte aligned,
``dequantize_int8_b512_kernel`` (one warp a row, lane l's packed words
l, 32 + l, 64 + l and 96 + l loaded first, each word's four levels made
without a conversion by XOR 0x80808080, a byte permute under 0x4B and a
subtraction of 2^23 + 128, multiplied by the row's scale and stored as
one float4); any other B or a misaligned row takes
``dequantize_int8_kernel`` (a block a row).  Modelled here: the host's
route, the layout (every word loaded and its float4 stored by one lane,
at the package's shape and every timed one), the levels of all 256 bytes
bitwise ``f32(q)`` (+0.0 for a zero, -128.0 for 0x80), and the B = 512
kernel's output bitwise ``dequantize_int8_plain`` and the reference's
Pallas ``dequantize_int8`` with level -128, NaN, Inf and -Inf scales.

``chip_smoke.py`` holds the kernels themselves against the plain version
on the card, on both paths.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import quantize as jquant  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.kernels.ref import INV_127  # noqa: E402

CU = Path(tquant.__file__).resolve().parent / "csrc" / "quantize.cu"
VARIANTS = CU.with_name("quantize_variants.cu")
#: the package's kQuantLanes, kQuantRows and kQuantThreads
LANES, ROWS, THREADS = 32, 1, 256
#: the layouts timed beside it (quantize_variants.cu): (G, RW, T)
TIMED = ((32, 1, 128), (32, 1, 256), (32, 2, 128), (32, 2, 256),
         (16, 1, 128), (16, 1, 256))
B = 512
#: a 256-byte aligned base address for the placements
BASE = 1 << 20


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_cu_constants_and_route_match_the_model():
    src = CU.read_text()
    assert _const(src, "kQuantLanes") == LANES
    assert _const(src, "kQuantRows") == ROWS
    assert _const(src, "kQuantThreads") == THREADS
    ok = re.search(r"bool quantize_b512_ok\(.*?\{(.*?)\}", src,
                   flags=re.S).group(1)
    assert re.sub(r"\s+", " ", ok).strip() == (
        "return b == 512 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && "
        "reinterpret_cast<uintptr_t>(q) % 4 == 0;")
    timed = {tuple(int(v) for v in m) for m in re.findall(
        r"^QUANT_VARIANT\((\d+), (\d+), (\d+)\)", VARIANTS.read_text(),
        flags=re.M)}
    assert timed == set(TIMED) and (LANES, ROWS, THREADS) in timed


def test_cu_dequantize_constants_and_route_match_the_model():
    src = CU.read_text()
    assert _const(src, "kDequantLanes") == LANES
    assert _const(src, "kDequantRows") == ROWS
    assert _const(src, "kDequantThreads") == THREADS
    ok = re.search(r"bool dequantize_b512_ok\(.*?\{(.*?)\}", src,
                   flags=re.S).group(1)
    assert re.sub(r"\s+", " ", ok).strip() == (
        "return b == 512 && reinterpret_cast<uintptr_t>(q) % 4 == 0 && "
        "reinterpret_cast<uintptr_t>(out) % 16 == 0;")
    # the level trick's constants: XOR, the byte permute's selector and
    # 2^23 + 128
    body = re.search(r"float4 word_levels\(uint32_t w\) \{(.*?)\n\}", src,
                     flags=re.S).group(1)
    assert "w ^ 0x80808080u" in body
    assert "__byte_perm(u, 0x4B000000u, 0x7650u + j)" in body
    assert "8388736.0f" in body and 8388736 == 2 ** 23 + 128
    timed = {tuple(int(v) for v in m) for m in re.findall(
        r"^DEQUANT_VARIANT\((\d+), (\d+), (\d+)\)", VARIANTS.read_text(),
        flags=re.M)}
    assert timed == set(TIMED) and (LANES, ROWS, THREADS) in timed


def dequant_route(b: int, q_off: int, out_off: int) -> str:
    """The host's choice of dequantize kernel for q and out ``q_off`` /
    ``out_off`` bytes past a 256-byte boundary."""
    ok = b == B and (BASE + q_off) % 4 == 0 and (BASE + out_off) % 16 == 0
    return "b512" if ok else "general"


def test_dequantize_route_by_width_and_offsets():
    # as dequantize_array calls it: a fresh q and a fresh output
    assert dequant_route(B, 0, 0) == "b512"
    # a row view of q one level in (1 byte off), and 2 / 3 bytes off
    for q_off in (1, 2, 3):
        assert dequant_route(B, q_off, 0) == "general"
    assert dequant_route(B, 4, 0) == "b512"
    for out_off in (4, 8, 12):
        assert dequant_route(B, 0, out_off) == "general"
    for b in (100, 256, 511, 513, 1024):
        assert dequant_route(b, 0, 0) == "general"


def route(b: int, x_off: int, q_off: int) -> str:
    """The host's choice for x and q ``x_off`` / ``q_off`` bytes past a
    256-byte boundary."""
    ok = b == B and (BASE + x_off) % 16 == 0 and (BASE + q_off) % 4 == 0
    return "b512" if ok else "general"


def test_route_by_width_and_offsets():
    # as quantize_array calls it: a fresh (R, 512) block and q
    assert route(B, 0, 0) == "b512"
    # a row view one float in (x 4 bytes off), and 8 / 12 bytes off
    for x_off in (4, 8, 12):
        assert route(B, x_off, 0) == "general"
    assert route(B, 16, 0) == "b512"
    for q_off in (1, 2, 3):
        assert route(B, 0, q_off) == "general"
    for b in (100, 256, 511, 513, 1024):
        assert route(b, 0, 0) == "general"


def layout(r: int, g: int, rw: int, t: int):
    """Each thread's items of the B = 512 kernel, as arrays over every
    (block, thread, row of its group k, float4 m): the row, the float4
    (and packed word) index in the row, the lane in its group; items of
    rows past r dropped."""
    kl = 128 // g
    blocks = -(-r // (t // g * rw))
    bx, tx, k, m = np.meshgrid(np.arange(blocks), np.arange(t),
                               np.arange(rw), np.arange(kl), indexing="ij")
    lane = tx % g
    row = (bx * (t // g) + tx // g) * rw + k
    f4 = g * m + lane
    live = row < r
    return row[live], f4[live], lane[live]


@pytest.mark.parametrize("shape", [(LANES, ROWS, THREADS), *TIMED])
@pytest.mark.parametrize("r", [1, 7, 8, 9, 37, 4_209])
def test_layout_covers_every_float4_once(r, shape):
    g, rw, t = shape
    row, f4, lane = layout(r, g, rw, t)
    seen = np.bincount(row * 128 + f4, minlength=r * 128)
    assert seen.size == r * 128 and (seen == 1).all()
    # lane l of a group takes lanes 4l .. 4l+3 of each slice of 4G lanes
    assert ((4 * f4) % (4 * g) == 4 * lane).all()
    # a lane's rows and float4s: 128 / G float4 of each of its rows
    assert (np.bincount(f4 // g, minlength=128 // g) == r * g).all()


@pytest.mark.parametrize("shape", [(LANES, ROWS, THREADS), *TIMED])
@pytest.mark.parametrize("r", [1, 7, 9, 37, 4_209])
def test_dequantize_layout_loads_and_stores_every_word_once(r, shape):
    """The B = 512 dequantize kernel's items: lane l of a group loads the
    packed words G*m + l of its rows (4 bytes of 4 levels each; a warp
    load 4G contiguous bytes) and stores float4 G*m + l of the output row
    (the same four levels; a warp store 16G contiguous bytes), each word
    and float4 of every row once, and no item for rows past r."""
    g, rw, t = shape
    row, word, lane = layout(r, g, rw, t)
    seen = np.bincount(row * 128 + word, minlength=r * 128)
    assert seen.size == r * 128 and (seen == 1).all()
    assert (word % g == lane).all()
    # the levels a lane holds: 4l .. 4l+3 of each slice of 4G levels
    levels = 4 * word[:, None] + np.arange(4)
    assert ((levels % (4 * g)) // 4 == lane[:, None]).all()
    # blocks a row group: an exact grid of ceil(r / (T / G * RW)) blocks
    assert -(-r // (t // g * rw)) * (t // g * rw) - r < t // g * rw


def word_levels(words: np.ndarray) -> np.ndarray:
    """``word_levels``: each packed word's four levels as floats, byte j
    of the word XORed with 0x80 under the exponent byte 0x4B (the
    selector 0x7650 + j takes byte j of the first operand and bytes 1-3
    of 0x4B000000), less 2^23 + 128 in f32."""
    u = np.asarray(words, "<u4") ^ np.uint32(0x80808080)
    out = np.empty(u.shape + (4,), np.float32)
    for j in range(4):
        bits = byte_perm(u, np.full_like(u, 0x4B000000), 0x7650 + j)
        out[..., j] = (bits.view(np.float32)
                       - np.float32(8388736.0)).astype(np.float32)
    return out


def test_byte_permute_levels_of_every_byte():
    """All 256 bytes, in each of the four byte positions: the levels
    equal f32(q) bitwise (+0.0 for 0, -128.0 for 0x80)."""
    q = np.arange(-128, 128, dtype=np.int8)
    for j in range(4):
        b = np.zeros((256, 4), np.int8)
        b[:, j] = q
        b[:, (j + 1) % 4] = q[::-1]  # a neighbour byte that varies too
        words = np.ascontiguousarray(b).view("<u4")[:, 0]
        got = word_levels(words)
        want = b.astype(np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    assert word_levels(np.array([0x80], "<u4"))[0, 0] == np.float32(-128.0)
    z = word_levels(np.array([0], "<u4"))[0]
    assert (z == 0).all() and not np.signbit(z).any()


def model_dequant_b512(q: np.ndarray, s: np.ndarray,
                       g: int = LANES) -> np.ndarray:
    """The B = 512 dequantize kernel: lane l of a row's group reads
    words G*m + l, makes their levels and stores float4 G*m + l = levels
    times the row's scale, each product rounded once (f32 multiply)."""
    r = q.shape[0]
    words = np.ascontiguousarray(q).view("<u4").reshape(r, 128 // g, g)
    lv = word_levels(words)  # (row, m, lane, 4)
    with np.errstate(invalid="ignore", over="ignore"):
        out = (lv * s[:, None, None, None]).astype(np.float32)
    return out.reshape(r, B)


def _dequant_inputs(r: int, seed: int):
    """Random int8 rows holding -128 and +-127, a zero row, and scales
    with a NaN, an Inf, a -Inf, a zero and a negative scale."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (r, B)).astype(np.int8)
    q[0] = 0
    q[1, :4] = (-128, 127, -127, 0)
    q[2, ::7] = -128
    s = rng.uniform(1e-4, 3.0, r).astype(np.float32)
    s[3] = np.nan
    s[4] = np.inf
    s[5] = -np.inf
    s[6] = 0.0
    s[min(7, r - 1)] = -0.25
    return q, s


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("r", [8, 37, 4_209])
def test_model_dequant_b512_bitwise_plain_and_pallas(r, g):
    q, s = _dequant_inputs(r, seed=r + g)
    got = model_dequant_b512(q, s, g)
    want = tquant.dequantize_int8_plain(torch.from_numpy(q),
                                        torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_array_equal(got[live].view(np.int32),
                                  want[live].view(np.int32))
    # a NaN scale gives NaN lanes, an Inf scale NaN at a level 0
    assert np.isnan(got[3]).all()
    assert np.isnan(got[4][q[4] == 0]).all()
    assert np.isinf(got[4][q[4] != 0]).all()
    assert got[2, 0] == np.float32(-128.0) * s[2]
    if r <= 37:  # interpret mode is slow at the full 4,209 rows
        jw = np.asarray(jquant.dequantize_int8(jnp.asarray(q),
                                               jnp.asarray(s),
                                               interpret=True))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(jw))
        np.testing.assert_array_equal(got[live].view(np.int32),
                                      jw[live].view(np.int32))


def pack(levels: np.ndarray) -> np.ndarray:
    """A float4's four levels (int (..., 4)) as one word, lane 4m + b at
    byte b: what the kernel's byte permutes gather."""
    u = levels.astype(np.int64) & 0xFF
    return (u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16
            | u[..., 3] << 24).astype("<u4")


def byte_perm(a, b, sel: int) -> np.ndarray:
    """``__byte_perm(a, b, sel)``: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the 8 bytes of (a, b)."""
    src = np.stack([np.asarray(a, "<u4"), np.asarray(b, "<u4")],
                   axis=-1).view(np.uint8)  # (..., 8)
    idx = [(sel >> (4 * i)) & 7 for i in range(4)]
    return np.ascontiguousarray(src[..., idx]).view("<u4")[..., 0]


def test_packed_word_byte_order():
    """Lane 4m + b of a float4 at byte b: the byte permutes' gather of
    the low bytes, XORed with 0x80, is the int8 levels in lane order, for
    every level -127 .. 127 (and the 0x80 byte of 2^23 + 128 + -128)."""
    levels = np.arange(-128, 128).reshape(-1, 4)
    words = pack(levels)
    np.testing.assert_array_equal(words.view(np.int8),
                                  levels.reshape(-1).astype(np.int8))
    b = (levels.astype(np.float32) + np.float32(8388736.0)).view(np.uint32)
    got = byte_perm(byte_perm(b[:, 0], b[:, 1], 0x0040),
                    byte_perm(b[:, 2], b[:, 3], 0x0040),
                    0x5410) ^ np.uint32(0x80808080)
    np.testing.assert_array_equal(got, words)


def nan_max(a, b):
    """The kernels' ``nan_max``: a where a > b or a is NaN, else b."""
    return np.where((a > b) | np.isnan(a), a, b)


def shuffle_max(m: np.ndarray, g: int) -> np.ndarray:
    """xor-shuffle steps G/2 .. 1 over the last axis (G lanes)."""
    lanes = np.arange(g)
    off = g // 2
    while off:
        m = nan_max(m, m[..., lanes ^ off])
        off //= 2
    return m


def quant_levels(x: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """``quant_lane``: clip(rint(x / sc), -127, 127), a NaN quotient 0."""
    with np.errstate(invalid="ignore", divide="ignore"):
        y = np.rint(x / sc)
        y = np.where(y > 127, 127, np.where(y < -127, -127, y))
    return np.where(np.isnan(y), 0, y).astype(np.int32)


def row_scale(m: np.ndarray) -> np.ndarray:
    v = (m * np.float32(INV_127)).astype(np.float32)
    return np.where((v >= np.float32(1e-12)) | np.isnan(v), v,
                    np.float32(1e-12)).astype(np.float32)


def abs_bits(x: np.ndarray) -> np.ndarray:
    """``abs_bits``: |x|'s bits, whose integer order is |x|'s, NaN above
    +Inf."""
    return x.view(np.uint32) & np.uint32(0x7FFFFFFF)


def quant_word(f4: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """``quant_word`` of float4s (..., 4) with finite scales: the clipped
    levels (fmaxf / fminf), each as the low byte of 2^23 + 128 + v, the
    four low bytes gathered (lane j at byte j) and XORed with 0x80."""
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.minimum(np.maximum(np.rint(f4 / sc), np.float32(-127)),
                       np.float32(127)).astype(np.float32)
    low = (v + np.float32(8388736.0)).astype(np.float32).view(
        np.uint32) & np.uint32(0xFF)
    return pack(low.astype(np.int64)) ^ np.uint32(0x80808080)


def model_b512(x: np.ndarray, g: int = LANES):
    """The B = 512 kernel: lane l of a row's group holds float4s G*m + l,
    the integer max of their 16 lanes' |x| bits, the shuffle tree, then
    each float4's levels packed into one word at word G*m + l (zeros for
    a row whose scale is Inf or NaN)."""
    r = x.shape[0]
    f4 = x.reshape(r, 128 // g, g, 4)  # (row, m, lane, 4)
    m = abs_bits(f4).max(axis=(1, 3))  # (row, lane)
    lanes = np.arange(g)
    off = g // 2
    while off:
        m = np.maximum(m, m[:, lanes ^ off])
        off //= 2
    assert (m == m[:, :1]).all()
    sc = row_scale(m[:, 0].view(np.float32))
    finite = np.abs(sc) <= np.float32(3.402823466e38)
    words = np.zeros((r, 128 // g, g), np.uint32)
    words[finite] = quant_word(f4[finite], sc[finite, None, None, None])
    return words.reshape(r, 128).view(np.int8).reshape(r, B), sc


def model_general(x: np.ndarray):
    """The general kernel: lane l's running absmax over lanes l, l + 32,
    ..., the shuffle tree, then every lane quantized alone."""
    r, b = x.shape
    m = np.zeros((r, 32), np.float32)
    with np.errstate(invalid="ignore"):
        for i in range(b):
            m[:, i % 32] = nan_max(m[:, i % 32], np.abs(x[:, i]))
    sc = row_scale(shuffle_max(m, 32)[:, 0])
    return quant_levels(x, sc[:, None]).astype(np.int8), sc


def _rows(r: int, b: int, seed: int) -> np.ndarray:
    """Random rows with a zero row, a row of exact +-0.5 ties (absmax 127,
    so the scale is fl(127 * f32(1/127)) and +-scale/2 divide to +-0.5),
    a row saturating at +-127, a NaN row and a row holding -Inf (an Inf
    scale: its lanes divide to +-0 or NaN, all stored as 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, b)) * rng.uniform(1e-3, 10.0, (r, 1))).astype(
        np.float32)
    s_tie = np.float32(127.0) * np.float32(INV_127)
    x[0] = 0.0
    x[1, 0] = 127.0
    x[1, 1::2] = 0.5 * s_tie
    x[1, 2::2] = -0.5 * s_tie
    x[2, :] = np.linspace(-300.0, 300.0, b, dtype=np.float32)
    x[3, b // 3] = math.nan
    x[4, 5] = -math.inf
    return x


def _same(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want) if want.dtype == np.float32 else np.zeros(
        want.shape, bool)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32 if got.dtype ==
                                                 np.float32 else np.int8),
                                  want[~nan].view(np.int32 if want.dtype ==
                                                  np.float32 else np.int8))


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("r", [7, 37])
def test_model_b512_bitwise_plain_and_pallas(r, g):
    x = _rows(r, B, seed=r + g)
    q, s = model_b512(x, g)
    pq, ps = tquant.quantize_int8_plain(torch.from_numpy(x))
    _same(q, pq.numpy())
    _same(s, ps.numpy())
    assert (q[0] == 0).all() and s[0] == np.float32(1e-12)
    assert s[1] == np.float32(127.0) * np.float32(INV_127)
    assert (q[1, 1:] == 0).all()
    assert q[2].min() == -127 and q[2].max() == 127
    assert np.isnan(s[3]) and (q[3] == 0).all()
    assert np.isinf(s[4]) and (q[4] == 0).all()
    jq, js = jquant.quantize_int8(jnp.asarray(x), interpret=True)
    live = ~np.isnan(s)
    _same(q[live], np.asarray(jq)[live])
    _same(s, np.asarray(js))


def test_model_b512_paper_cnn_rows():
    """The paper CNN's 4,209 blocks of 512, as ``quantize_pytree`` gives
    them to the kernel: bitwise the plain version."""
    x = _rows(4_209, B, seed=5)
    q, s = model_b512(x)
    pq, ps = tquant.quantize_int8_plain(torch.from_numpy(x))
    _same(q, pq.numpy())
    _same(s, ps.numpy())


@pytest.mark.parametrize("b", [100, 512])
def test_model_general_bitwise_plain_and_pallas(b):
    """The general kernel at B = 100 and at B = 512 (as a row view one
    float in takes it): bitwise the plain version and the B = 512
    model."""
    x = _rows(37, b, seed=b)
    q, s = model_general(x)
    pq, ps = tquant.quantize_int8_plain(torch.from_numpy(x))
    _same(q, pq.numpy())
    _same(s, ps.numpy())
    jq, js = jquant.quantize_int8(jnp.asarray(x), interpret=True)
    live = ~np.isnan(s)
    _same(q[live], np.asarray(jq)[live])
    _same(s, np.asarray(js))
    if b == B:
        qv, sv = model_b512(x)
        _same(q, qv)
        _same(s, sv)
