"""The sharding rules (``repro_torch.sharding.rules``) and the activation
constraints (``repro_torch.sharding.ctx``) against the reference's:

  * ``param_specs`` leaf for leaf, exactly, for all ten ``ARCHS`` at full
    width (the reference's shapes from ``jax.eval_shape`` of its init, the
    port's from ``init_params`` on the meta device), on a 16 x 16 and a
    2 x 16 x 16 stub mesh and a (1, 4) debug mesh (the reference's rules
    on a device-less ``AbstractMesh``);
  * ``batch_spec`` on those meshes and on (edge, pod) meshes;
  * ``cache_specs`` of every arch's decode caches (``decode_32k``,
    ``long_500k``; the reference's from ``eval_shape`` of its prefill, the
    port's from its prefill on the meta device) on both production
    meshes: the port's stacked decoder cache takes the spec of each of
    the reference's ``layers_dense`` / ``layers_moe`` stacks, no stacked
    layer count equals the decode batch where it shards, and the
    per-device cache bytes are the reference's;
  * the ctx functions are identities, enabled or not.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import ctx, rules  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)


class StubMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "debug1x4": dict(data=1, model=4)}


def abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


_PARAMS = {}


def params(arch):
    """(the reference's param ShapeDtypeStructs, the port's meta params) at
    full width, once per arch."""
    if arch not in _PARAMS:
        _PARAMS[arch] = (jspecs.param_structs(jbuild(jget_config(arch))),
                         tspecs.param_structs(build_model(get_config(arch))))
    return _PARAMS[arch]


def flat(tree):
    """{dot-joined path: leaf} of a nested dict."""
    out = {}
    rules.map_with_path(lambda p, v: out.__setitem__(p, v), tree)
    return out


def jflat(tree):
    """{dot-joined path: leaf} of a jax tree (the reference's paths)."""
    return {jrules._path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(arch, mesh):
    jp, tp = params(arch)
    want = jflat(jrules.param_specs(jp, jget_config(arch),
                                    abstract(MESHES[mesh])))
    got = flat(rules.param_specs(tp, get_config(arch),
                                 StubMesh(**MESHES[mesh])))
    jshapes = jflat(jp)
    assert sorted(got) == sorted(want)
    for path, ns in want.items():
        assert tuple(flat(tp)[path].shape) == jshapes[path].shape, path
        assert isinstance(got[path], rules.Spec)
        assert tuple(got[path]) == tuple(ns.spec) + (None,) * (
            len(jshapes[path].shape) - len(ns.spec)), (path, got[path],
                                                       ns.spec)


def test_production_and_debug_meshes():
    assert tmesh.make_production_mesh().shape == MESHES["16x16"]
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == MESHES["2x16x16"]
    assert list(multi.shape) == ["pod", "data", "model"]
    assert tmesh.make_debug_mesh(4).shape == MESHES["debug1x4"]
    assert (tmesh.mesh_chips(tmesh.make_production_mesh()),
            tmesh.mesh_chips(multi)) == (256, 512)
    # the roofline's link rates: the 16-wide data axis and the pod axis
    # leave an 8-GPU node; a (1, 4) mesh fits in one
    assert [tmesh.axis_bw(multi, a) for a in ("pod", "data", "model")] == [
        tmesh.IB_BW, tmesh.IB_BW, tmesh.IB_BW]
    assert tmesh.axis_bw(tmesh.make_debug_mesh(4), "model") == \
        tmesh.NVLINK_BW
    assert tmesh.axis_bw(tmesh.AxisMesh({"data": 2, "model": 4}),
                         "model") == tmesh.NVLINK_BW


@pytest.mark.parametrize("shape", [
    dict(data=16, model=16), dict(pod=2, data=16, model=16),
    dict(data=1, model=4), dict(edge=2, pod=4), dict(model=8),
    dict(edge=2, pod=2, data=4, model=2)])
def test_batch_spec_matches_reference(shape):
    want = tuple(jrules.batch_spec(abstract(shape)))
    assert tuple(rules.batch_spec(StubMesh(**shape))) == want


def test_spec_for_path_and_add_fsdp_match_reference():
    """The reference tests' cases (a non-divisible dim, fsdp, expert
    tables), both packages on the stub mesh."""
    mesh = StubMesh(data=16, model=16)
    for path, shape, policy, expert in [
            ("embed", (163840, 7168), "megatron", False),
            ("layers_dense.attn.wq", (2, 100, 100), "megatron", False),
            ("layers_dense.attn.wq", (28, 7168, 7168), "fsdp", False),
            ("layers_moe.moe.w1", (60, 384, 7168, 2048), "fsdp", True),
            ("mamba.ssm.in_proj", (9, 5, 2560, 10448), "megatron", False),
            ("sblocks.cell.r", (6, 4, 4, 192, 192), "fsdp", False)]:
        assert tuple(rules.spec_for_path(path, shape, mesh, policy,
                                         expert)) == tuple(
            jrules.spec_for_path(path, shape, mesh, policy, expert)), path
    assert rules.add_fsdp([None, None], (3, 7), 0, mesh) == [None, None]


def _bytes(shape, spec, mesh, itemsize):
    return math.prod(tspecs.local_shape(shape, spec, mesh)) * itemsize


_CACHES = {}


def caches(arch, shape_name):
    """The port's cache of a decode shape (its prefill on the meta
    device, once per arch and shape) and ``decode_cache_structs``'s specs
    on the 16 x 16 mesh."""
    if (arch, shape_name) not in _CACHES:
        cfg = get_config(arch)
        tc, tcs, _, _ = tspecs.decode_cache_structs(
            cfg, build_model(cfg), shape_name, StubMesh(**MESHES["16x16"]))
        _CACHES[arch, shape_name] = tc, tcs
    return _CACHES[arch, shape_name]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape_name", [
    (arch, shape_name) for arch in ARCHS
    for shape_name in ("decode_32k", "long_500k")
    # the enc-dec speech model has no 500k-token decode (the reference's
    # sanctioned SKIP)
    if (arch, shape_name) != ("seamless-m4t-medium", "long_500k")])
def test_cache_specs_match_reference(arch, shape_name, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = MESHES[mesh]
    B = INPUT_SHAPES[shape_name].global_batch
    jc, _, _ = jspecs.decode_cache_structs(jcfg, jbuild(jcfg), shape_name,
                                           abstract(shape))
    tc, tcs = caches(arch, shape_name)
    mesh_ = StubMesh(**shape)
    want = jflat(jc)
    got = flat(tc)
    gspecs = flat(rules.cache_specs(tc, mesh_, B))
    if mesh == "16x16":
        assert flat(tcs) == gspecs
    if cfg.family in ("dense", "moe", "vlm"):
        # one stack over all layers against the reference's split stacks
        stacks = [n for n in ("layers_dense", "layers_moe")
                  if f"{n}.k" in want]
        assert sum(want[f"{n}.k"].shape[0] for n in stacks) == \
            got["k"].shape[0] == cfg.n_layers
        # a stack whose layer count equals the batch, where the batch
        # shards, would take the batch's spec on its dim 0 (the rule
        # looks from dim 0)
        btotal = math.prod(v for a, v in shape.items() if a != "model")
        if B % btotal == 0 and B >= btotal:
            assert got["k"].shape[0] != B
            assert B not in {want[f"{n}.k"].shape[0] for n in stacks}
        for kv in ("k", "v"):
            for n in stacks:
                w = want[f"{n}.{kv}"]
                assert tuple(got[kv].shape[1:]) == w.shape[1:]
                assert tuple(gspecs[kv]) == tuple(w.sharding.spec) + (
                    None,) * (len(w.shape) - len(w.sharding.spec))
    else:
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert tuple(got[path].shape) == w.shape, path
            assert tuple(gspecs[path]) == tuple(w.sharding.spec) + (
                None,) * (len(w.shape) - len(w.sharding.spec)), path
    jbytes = sum(_bytes(w.shape, tuple(w.sharding.spec) + (None,) * (
        len(w.shape) - len(w.sharding.spec)), mesh_, w.dtype.itemsize)
        for w in want.values())
    assert tspecs.tree_bytes(tc, rules.cache_specs(tc, mesh_, B),
                             mesh_) == jbytes
    assert jbytes > 0


def test_ctx_is_identity():
    x = torch.randn(4, 2, 8, 8)
    assert ctx.constrain_batch(x) is x
    assert ctx.constrain_scores(x, 2) is x
    with ctx.activation_sharding(("data",), 16, 16):
        assert ctx.constrain_batch(x, 0) is x
        assert ctx.constrain_scores(x, 2) is x
    ctx.enable(("pod", "data"), 16, 32)
    assert ctx.constrain_batch(x) is x
    ctx.disable()
    assert np.array_equal(ctx.constrain_scores(x, 16).numpy(), x.numpy())
