"""The top-k kernels' one-launch CUDA designs, modelled on the CPU.

``safl_fold_topk`` and ``safl_aggregate_topk`` run one kernel a call on
the card (``csrc/safl_agg.cu`` ``fold_topk_kernel``,
``aggregate_topk_kernel``).  The kernels cannot run here, so this file
holds plain models of them, written from the .cu constants (checked
against the source text):

* the lane partition of a sparse row (``topk_span``): a scalar head up
  to the first lane whose idx and qv addresses are vector-aligned,
  vectors of V lanes (the fold's ``kTopkFoldVec``, the K-row sum's
  ``kTopkAggVec``, and 1-8 in the timed variants), a scalar tail, every lane alone where
  the two rows sit at different offsets or a qblock is narrower than a
  vector; each vector's one or two scales.  It must cover every lane
  exactly once, at the paper CNN's nk = 215,552 and at short rows, for
  rows starting 0-3 lanes off their boundaries, and the fold's exact
  grid must cover every item;
* the K-row sum's phases: the first ``kTopkPrefetch`` rows' items of
  each thread loaded before the zeros, the zeros, then the rows in
  order, each row's items cut into one run of whole warps a block, rows
  past the prefetch loaded as they go, row 0 stored as +0 + v over the
  zeros without reading them back.  The model is held bitwise
  against ``safl_aggregate_topk_plain``, the chain of
  ``safl_fold_topk_plain`` from zeros and the reference's oracles
  (``topk_weighted_sum_ref`` / ``fold_topk_ref``) at K = 1, 4, 5 and 17,
  with coordinates colliding across rows, an empty row and pad lanes.

``chip_smoke.py`` holds the kernels themselves against the plain versions
on the card.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

CU = Path(tk.__file__).resolve().parent / "csrc" / "safl_agg.cu"
#: the kernels' kTopkFoldVec, kTopkThreads, kTopkAggVec, kTopkAggThreads
#: and kTopkPrefetch
FOLD_VEC, THREADS, VEC, AGG_THREADS, PREFETCH = 1, 128, 2, 512, 4
QB = 512
D = 4099
#: resident grids the model's K-row sum is cut for: one block (every
#: thread takes many items a row), a few, and an H100's 132 x 8
GRIDS = (1, 7, 1056)


def test_cu_constants_match_the_models():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kTopkFoldVec") == FOLD_VEC
    assert const("kTopkThreads") == THREADS
    assert const("kTopkAggVec") == VEC
    assert const("kTopkAggThreads") == AGG_THREADS
    assert const("kTopkPrefetch") == PREFETCH


def topk_span(idx_off: int, qv_off: int, nk: int, qblock: int,
              v: int = VEC):
    """``topk_span``: (head, nv, items) of a row whose idx starts
    ``idx_off`` lanes past a 4v-byte boundary and whose qv starts
    ``qv_off`` bytes past a v-byte boundary."""
    a, b = idx_off % v, qv_off % v
    head = min((v - a) % v if a == b and qblock >= v else nk, nk)
    nv = (nk - head) // v
    return head, nv, nk - (v - 1) * nv


def item_lanes(span, v: int = VEC) -> np.ndarray:
    """(items, v) lanes of each item of ``span``, -1 where an item (a
    scalar one) has no lane: vectors first, then the head, then the
    tail."""
    head, nv, items = span
    out = np.full((items, v), -1, np.int64)
    out[:nv] = head + v * np.arange(nv)[:, None] + np.arange(v)
    u = np.arange(items - nv)
    out[nv:, 0] = np.where(u < head, u, u + v * nv)
    return out


@pytest.mark.parametrize("v", [1, 2, 4, 8])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("nk", [215_552, 4_608, 520, 8])
def test_fold_partition_covers_every_lane_once(nk, off, v):
    """Rows starting ``off`` lanes off (idx and qv alike): every lane in
    exactly one item, each vector's idx and qv aligned, at most two
    scales a vector (the split the kernel takes), and the fold's exact
    grid of THREADS covering every item."""
    span = topk_span(off, off, nk, QB, v)
    head, nv, items = span
    lanes = item_lanes(span, v)
    got = np.sort(lanes[lanes >= 0])
    np.testing.assert_array_equal(got, np.arange(nk))
    j0 = lanes[:nv, 0]
    assert ((off + j0) % v == 0).all()
    assert head == min((v - off % v) % v, nk)
    qs = QB.bit_length() - 1
    split = ((j0 >> qs) + 1 << qs) - j0
    for lane in range(v):
        block = np.where(lane < split, j0 >> qs, (j0 + v - 1) >> qs)
        np.testing.assert_array_equal(block, (j0 + lane) >> qs)
    blocks = max(1, -(-items // THREADS))
    assert (blocks - 1) * THREADS < max(items, 1) <= blocks * THREADS


@pytest.mark.parametrize("idx_off,qv_off,qblock,v", [
    (1, 0, QB, 4), (0, 3, QB, 4), (2, 1, QB, 4), (0, 0, 2, 4), (1, 0, QB, 2),
    (1, 1, 1, 2)])
def test_fold_partition_scalar_when_rows_disagree(idx_off, qv_off, qblock,
                                                  v):
    """idx and qv at different lane offsets mod a vector, or a qblock
    narrower than a vector: every lane alone, still each once."""
    nk = 4_608 if qblock == QB else 520
    span = topk_span(idx_off, qv_off, nk, qblock, v)
    assert span == (nk, 0, nk)
    lanes = item_lanes(span, v)
    np.testing.assert_array_equal(np.sort(lanes[lanes >= 0]),
                                  np.arange(nk))


def _rows(k: int, nk: int, seed: int, empty=()):
    """k sparse rows over D: the top-|x| nk lanes of random padded rows
    by a stable descending sort (nk > D ranks pad lanes >= D),
    coordinate 5 in every row and 6 in all but the last (rows collide
    there; at nk = Dq on every coordinate), random int8 values and
    scales; rows in ``empty`` are the buffer's empty rows (idx = D,
    values and scales 0)."""
    rng = np.random.default_rng(seed)
    dq = -(-D // QB) * QB
    x = np.zeros((k, dq), np.float32)
    x[:, :D] = rng.normal(size=(k, D))
    x[:, 5] = 50.0 + np.arange(k)
    x[:-1, 6] = -40.0
    idx = np.argsort(-np.abs(x), axis=1, kind="stable")[:, :nk]
    idx = idx.astype(np.int32)
    q = rng.integers(-127, 128, size=(k, nk)).astype(np.int8)
    s = rng.uniform(1e-3, 0.5, size=(k, nk // QB)).astype(np.float32)
    for r in empty:
        idx[r], q[r], s[r] = D, 0, 0.0
    w = rng.uniform(0.2, 4.0, size=k).astype(np.float32)
    return idx, q, s, w


def _load(idx, q, s, lanes, qs):
    """The model's loads of some items' lanes: (coordinates, values,
    scales), -1 coordinates where a lane is absent."""
    valid = lanes >= 0
    j = np.where(valid, lanes, 0)
    return (np.where(valid, idx[j], -1), q[j], s[j >> qs])


def _scatter(out, loaded, w, zero=False):
    """``scatter_topk_item`` over loaded items: out[i] = out[i] + w*(q*s)
    in f32 for the lanes with 0 <= i < d (distinct within a row); with
    ``zero`` the coordinates hold +0 and are not read: +0 + w*(q*s)."""
    i, q, s = (a.reshape(-1) for a in loaded)
    keep = (i >= 0) & (i < out.size)
    assert np.unique(i[keep]).size == keep.sum()
    v = np.float32(w) * (q[keep].astype(np.float32) * s[keep])
    if zero:
        assert not out[i[keep]].view(np.int32).any()
        out[i[keep]] = np.float32(0.0) + v
    else:
        out[i[keep]] = out[i[keep]] + v


def aggregate_model(idx, q, s, w, d, grid, idx_off=0, qv_off=0):
    """The K-row sum as ``aggregate_topk_kernel`` orders it on a grid of
    ``grid`` blocks of AGG_THREADS: phase 0 loads each thread's first
    item of rows < PREFETCH, then the zeros, then row by row (after a
    grid barrier) each thread's items: the prefetched first, the rest
    loaded then; rows >= PREFETCH loaded as they go."""
    k, nk = idx.shape
    qs = QB.bit_length() - 1
    plans = []
    for r in range(k):
        span = topk_span(idx_off + r * nk, qv_off + r * nk, nk, QB)
        run = -(-span[2] // grid)
        run = -(-run // 32) * 32
        owner = np.full(span[2], -1, np.int64)  # which (block, thread)
        first = np.zeros(span[2], bool)
        for b in range(grid):
            lo, hi = b * run, min(b * run + run, span[2])
            its = np.arange(lo, max(lo, hi))
            assert (owner[its] == -1).all()
            owner[its] = b * AGG_THREADS + (its - lo) % AGG_THREADS
            first[its] = its - lo < AGG_THREADS
        assert (owner >= 0).all()
        plans.append((item_lanes(span), first))
    pre = [_load(idx[r], q[r], s[r], lanes[first], qs)
           for r, (lanes, first) in enumerate(plans[:PREFETCH])]
    out = np.zeros(d, np.float32)
    for r, (lanes, first) in enumerate(plans):
        zero = r == 0  # +0 + v: the zeros are not read back
        if r < PREFETCH:
            _scatter(out, pre[r], w[r], zero)
            _scatter(out, _load(idx[r], q[r], s[r], lanes[~first], qs), w[r],
                     zero)
        else:
            _scatter(out, _load(idx[r], q[r], s[r], lanes, qs), w[r])
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("offs", [(0, 0), (1, 1), (1, 0)])
@pytest.mark.parametrize("nk", [1_024, 4_608])
@pytest.mark.parametrize("k", sorted({1, 4, PREFETCH, PREFETCH + 1, 17}))
def test_aggregate_model_matches_plain_chain_and_reference(k, nk, offs):
    idx, q, s, w = _rows(k, nk, seed=k * 31 + nk,
                         empty=(1,) if k >= 4 else ())
    if nk > D:  # pad lanes ranked, to be dropped
        assert (idx >= D).any()
    hits = np.bincount(idx[idx < D], minlength=D)
    assert hits.max() == k - (k >= 4)  # coordinate 5 in every kept row
    plain = tk.safl_aggregate_topk_plain(_t(idx), _t(q), _t(s), _t(w), D,
                                         qblock=QB).numpy()
    chain = torch.zeros(D)
    for r in range(k):
        chain = tk.safl_fold_topk_plain(chain, _t(idx[r]), _t(q[r]),
                                        _t(s[r]), w[r], qblock=QB)
    oracle = np.asarray(jref.topk_weighted_sum_ref(
        jnp.asarray(idx), jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), D,
        QB))
    acc = jnp.zeros(D, jnp.float32)
    for r in range(k):
        acc = jref.fold_topk_ref(acc, jnp.asarray(idx[r]), jnp.asarray(q[r]),
                                 jnp.asarray(s[r]), w[r], QB)
    for grid in GRIDS:
        model = aggregate_model(idx, q, s, w, D, grid, *offs)
        for want in (plain, chain.numpy(), oracle, np.asarray(acc)):
            np.testing.assert_array_equal(model.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_fold_model_matches_plain_and_reference(off, beta):
    """The fold as the kernel partitions one row (beta*acc first where
    beta != 1, as its dense pass), bitwise the plain version and the
    reference's oracle."""
    idx, q, s, w = _rows(1, 4_608, seed=off)
    acc = np.random.default_rng(off).normal(size=D).astype(np.float32)
    out = np.float32(beta) * acc if beta != 1.0 else acc.copy()
    lanes = item_lanes(topk_span(off, off, 4_608, QB, FOLD_VEC), FOLD_VEC)
    _scatter(out, _load(idx[0], q[0], s[0], lanes, QB.bit_length() - 1),
             w[0])
    plain = tk.safl_fold_topk_plain(_t(acc), _t(idx[0]), _t(q[0]), _t(s[0]),
                                    w[0], beta, qblock=QB).numpy()
    oracle = np.asarray(jref.fold_topk_ref(
        jnp.asarray(acc), jnp.asarray(idx[0]), jnp.asarray(q[0]),
        jnp.asarray(s[0]), w[0], QB, beta))
    np.testing.assert_array_equal(out.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(out.view(np.int32), oracle.view(np.int32))
