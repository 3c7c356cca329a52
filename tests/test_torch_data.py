"""repro_torch.data against repro.data: equal arrays for equal seeds."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro_torch import data as tdata  # noqa: E402


def _assert_ds_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.n_classes == b.n_classes and a.kind == b.kind
    if a.roles is None:
        assert b.roles is None
    else:
        np.testing.assert_array_equal(a.roles, b.roles)


@pytest.mark.parametrize("name,kw", [
    ("cifar10", {"hw": 8}), ("cifar100", {"hw": 8}), ("femnist", {"hw": 8}),
    ("shakespeare", {}), ("sentiment140", {})])
def test_synthetic_equal(name, kw):
    _assert_ds_equal(jdata.make_dataset(name, n=120, seed=3, **kw),
                     tdata.make_dataset(name, n=120, seed=3, **kw))


@pytest.mark.parametrize("scheme,kw", [
    ("iid", {}), ("shards", {"n_labels": 2}),
    ("unbalanced_dirichlet", {"sigma": 0.5}),
    ("hetero_dirichlet", {"alpha": 0.3}),
    ("lognormal_text", {"sigma": 0.5})])
def test_partition_equal(scheme, kw):
    labels = np.random.default_rng(1).integers(0, 10, 500).astype(np.int32)
    a = jdata.partition(scheme, labels, 7, seed=2, **kw)
    b = tdata.partition(scheme, labels, 7, seed=2, **kw)
    assert len(a) == len(b) == 7
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


def test_by_role_partition_equal():
    ds = jdata.make_dataset("shakespeare", n=200, seed=0)
    a = jdata.partition("by_role", ds.y, 5, roles=ds.roles, seed=1)
    b = tdata.partition("by_role", ds.y, 5, roles=ds.roles, seed=1)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


def test_split_and_shards_equal():
    ds_j = jdata.make_dataset("cifar10", n=300, seed=0, hw=8)
    ds_t = tdata.make_dataset("cifar10", n=300, seed=0, hw=8)
    (trj, tej), (trt, tet) = (jdata.train_test_split(ds_j),
                              tdata.train_test_split(ds_t))
    _assert_ds_equal(trj, trt)
    _assert_ds_equal(tej, tet)
    sj = jdata.build_client_shards(trj, "hetero_dirichlet", 6, 16, seed=0,
                                   alpha=0.3)
    st = tdata.build_client_shards(trt, "hetero_dirichlet", 6, 16, seed=0,
                                   alpha=0.3)
    assert len(sj) == len(st) == 6
    for a, b in zip(sj, st):
        assert a["n"] == b["n"]
        for key in ("xs", "ys", "mask"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
