"""The f32 screen's one-launch CUDA design, modelled on the CPU.

``screen_rows`` runs one kernel a call on the card (``csrc/safl_agg.cu``
``screen_f32_kernel``).  The kernel cannot run here, so this file holds a
plain model of it, written from the package's constants
(:data:`SCREEN_F32_WARPS`, :data:`SCREEN_F32_LOADS`,
:data:`SCREEN_CHUNK`, :func:`screen_chunks`, checked against the .cu
text): a row's lanes in groups of 4, chunk c taking the groups from
c * T * L (T threads of L loads), thread t of it the groups c*T*L + j*T +
t; lane e of a thread's groups summed into s_e in load order, then
(s_0 + s_1) + (s_2 + s_3); the shuffle-down tree in each warp and over
the warp sums; then the row's last block's sum of the partials (strided
per thread in index order, the same trees).

The two load paths are modelled as the kernel takes them from a buffer:
float4 groups where every row of the stack starts 16-byte aligned, else
lane by lane (the ragged last group always lane by lane), with the
host's choice of path from the rows' start and stride.  Rows 1, 2 and 3
lanes off a boundary must give the aligned row's sums bitwise, and the
model is held against ``screen_rows_plain``, the reference's oracle
``screen_sumsq_ref`` and its Pallas ``screen_rows`` (interpret mode) on
clean, corrupted (NaN / Inf lanes), Byzantine and all-zero rows at the
paper CNN's D = 2,154,730 and a ragged D = 4,099: isfinite verdicts
exact, finite sums within ``rtol=1e-5`` (the orders differ).
``chip_smoke.py`` holds the kernel itself against the plain version on
the card, on every path.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import safl_agg as jk  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

CU = Path(tk.__file__).resolve().parent / "csrc" / "safl_agg.cu"
D_FULL, D_RAGGED = 2_154_730, 4_099
#: threads a block and float4 loads a thread of the package's kernel
T = tk.SCREEN_F32_WARPS * 32
L = tk.SCREEN_F32_LOADS


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CU.read_text()).group(1))


def test_cu_constants_match_the_scratch_sizes():
    """The kernel's kScreenF32Warps and kScreenF32Loads are the wrapper's,
    which size ``part`` (SCREEN_CHUNK lanes a chunk, 4 a load)."""
    assert _const("kScreenF32Warps") == tk.SCREEN_F32_WARPS
    assert _const("kScreenF32Loads") == tk.SCREEN_F32_LOADS
    assert tk.SCREEN_CHUNK == T * L * 4
    # the main path's row: 264 blocks of 256 threads, 2 an H100 SM
    assert tk.screen_chunks(D_FULL) == 264
    for d in (1, 4, tk.SCREEN_CHUNK - 1, tk.SCREEN_CHUNK,
              tk.SCREEN_CHUNK + 1, D_RAGGED, D_FULL):
        chunks = tk.screen_chunks(d)
        assert (chunks - 1) * tk.SCREEN_CHUNK < d <= chunks * tk.SCREEN_CHUNK


def path_of(start_lanes: int, k: int, d: int) -> int:
    """The host's choice of load (``launch_screen_f32``): 4 (float4)
    where every row starts 16-byte aligned, else 1 (lane by lane);
    ``start_lanes`` is the first row's offset in f32 lanes from a 16-byte
    boundary."""
    return 4 if start_lanes % 4 == 0 and (k == 1 or d % 4 == 0) else 1


def load_groups(buf: np.ndarray, start: int, d: int, vec: int) -> np.ndarray:
    """The (groups, 4) lanes a row of ``d`` lanes at ``buf[start:]``
    loads on path ``vec``, the missing lanes of a short last group 0.
    Path 4 reads float4 groups of ``buf`` (``start`` a multiple of 4), 1
    single lanes."""
    ng = -(-d // 4)
    whole = d // 4  # groups with all 4 lanes in the row
    out = np.zeros((ng, 4), np.float32)
    if vec == 4:
        assert start % 4 == 0
        out[:whole] = buf[:(buf.size // 4) * 4].reshape(-1, 4)[
            start // 4 + np.arange(whole)]
    else:
        lanes = np.arange(4 * whole)
        out[:whole] = buf[start + lanes].reshape(-1, 4)
    for e in range(d - 4 * whole):  # the short last group, lane by lane
        out[whole, e] = buf[start + 4 * whole + e]
    return out


def _warp_sums(v: np.ndarray) -> np.ndarray:
    """Lane 0 of ``warp_sum`` over the last axis (32 f32 lanes): the
    shuffle-down tree."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _block_sums(v: np.ndarray) -> np.ndarray:
    """``block_sum`` over the last axis (T threads): each warp's tree,
    then the tree over the warp sums padded with 0."""
    warps = _warp_sums(v.reshape(*v.shape[:-1], -1, 32))
    pad = np.zeros((*warps.shape[:-1], 32 - warps.shape[-1]), np.float32)
    return _warp_sums(np.concatenate([warps, pad], axis=-1))


def screen_model(groups: np.ndarray, d: int) -> np.float32:
    """The kernel's sum of one row's loaded (groups, 4) lanes."""
    chunks = tk.screen_chunks(d)
    v = np.zeros((chunks * L * T, 4), np.float32)
    v[:groups.shape[0]] = groups
    v = v.reshape(chunks, L, T, 4)
    with np.errstate(invalid="ignore", over="ignore"):
        sq = v * v
        s = np.zeros((chunks, T, 4), np.float32)
        for j in range(L):  # a thread's loads in order, per lane e
            s = s + sq[:, j]
        s = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
        part = _block_sums(s)
        per = np.zeros(T, np.float32)
        for r in range(-(-chunks // T)):  # the last block: strided, in order
            i = r * T + np.arange(T)
            per = np.where(i < chunks,
                           per + part[np.minimum(i, chunks - 1)], per)
        return _block_sums(per)


def model_rows(u: np.ndarray, start: int = 0) -> np.ndarray:
    """The kernel's sums of the (K, D) rows ``u`` laid out from lane
    ``start`` of a buffer (its 16-byte boundary at lane 0), each row on
    the path the host picks for the stack."""
    k, d = u.shape
    buf = np.zeros(start + k * d + 4, np.float32)
    buf[start:start + k * d] = u.reshape(-1)
    vec = path_of(start, k, d)
    return np.array([screen_model(load_groups(buf, start + i * d, d, vec), d)
                     for i in range(k)], np.float32)


def _rows(d: int, seed: int) -> np.ndarray:
    """Five rows of d lanes: clean, corrupted (the reference's applier:
    NaN and Inf lanes), Byzantine (x -10), all zero, and clean rows of
    large and tiny magnitude."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(5, d)).astype(np.float32)
    u = np.asarray(jfaults.apply_faults_flat(
        u, [False, True, False, False, False],
        [False, False, True, False, False],
        np.float32([0.3, 0.37, 0.5, 0.1, 0.9]), 10.0)).copy()
    u[3] = 0.0
    u[4] *= np.float32(1e3) ** rng.integers(-2, 3, size=d)
    return u


def _assert_sums(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("d", [D_FULL, D_RAGGED])
def test_model_matches_plain_reference_and_pallas(d):
    u = _rows(d, seed=d % 1000)
    model = model_rows(u)
    _assert_sums(model, tk.screen_rows_plain(torch.from_numpy(u)).numpy())
    _assert_sums(model, jref.screen_sumsq_ref(u))
    _assert_sums(model, jk.screen_rows(u, interpret=True))
    # the corrupt row is non-finite, the zero row sums to +0
    np.testing.assert_array_equal(np.isfinite(model),
                                  [True, False, True, True, True])
    assert model[3] == 0.0 and not np.signbit(model[3])


@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("d", [D_FULL, D_RAGGED, 4_100])
def test_every_path_gives_the_aligned_sums_bitwise(d, k, start):
    """A stack or a row 0-3 lanes off a 16-byte boundary, each row on the
    path the host picks (float4 only for aligned rows of a 16-byte
    stride, else lane by lane): the sums of each row alone on the float4
    path, bitwise."""
    u = _rows(d, seed=7 + k)[:k]
    u[:, -3:] = np.float32([3.0, -2.5, 1e-3])  # the ragged end counts
    alone = np.array([model_rows(u[i:i + 1])[0] for i in range(k)],
                     np.float32)
    got = model_rows(u, start)
    np.testing.assert_array_equal(got.view(np.int32), alone.view(np.int32))


def test_host_takes_float4_only_where_every_row_allows():
    # the engine's upload (K = 1) from an aligned allocation: float4
    assert path_of(0, 1, D_FULL) == 4
    # a stack at D mod 4 = 2: odd rows 8 bytes off, so lane by lane
    assert path_of(0, 4, D_FULL) == 1
    assert path_of(0, 4, 4_100) == 4
    for start in (1, 2, 3):
        assert path_of(start, 1, D_FULL) == 1
        assert path_of(start, 4, 4_100) == 1
    assert path_of(0, 4, D_RAGGED) == 1  # odd D: rows 4 bytes apart
