"""The dry run (``repro_torch.launch.dryrun``), its specs
(``launch.specs``) and its cost counter (``launch.cost``) against the
reference's parts (its end-to-end dry run has no passing oracle):

  * ``INPUT_SHAPES`` equal; ``model_flops`` exact for the 10 x 4 pairs
    (the reference's run with 64-bit ints: in int32 its leaf sizes wrap
    for kimi-k2 and internvl2);
  * per-device argument and output bytes exact against the same formula
    over the reference's specs and ``eval_shape`` structs, for each arch
    (reduced: the full widths' specs are held in
    ``test_torch_sharding_rules.py``) on ``train_4k``, ``prefill_32k`` and
    ``decode_32k``, on both production meshes.  The step number and the
    decode position are host integers in the port (the reference's 4-byte
    scalar arguments are left out of its sum);
  * ``cost.analyze``'s FLOPs of each reduced config's ``value_and_grad``
    (B 2 x 32) against ``hlo_cost.analyze`` of the reference's jitted
    one-device compile: exact for six, and exact for the other four once
    each named difference is added back (below);
  * the trip count of the sLSTM's time loop: FLOPs, bytes and peak equal
    to the full loop's at small S, in the forward and in
    ``value_and_grad`` (remat on and off); real tensors refused;
  * the meta route: inside ``meta_trace`` a meta prefill counts what the
    CPU prefill counts; outside it meta still raises;
  * ``op_bytes`` of one matmul against a hand count;
  * the CLI on two pairs (xlstm's ``prefill_32k`` on both meshes), its
    default ``--out`` not the reference's ``experiments/dryrun``, a
    variant of a field the port does not read refused by name, and the
    full-width qwen3-1.7b ``train_4k`` record.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import _train_common as tc  # noqa: E402
import _zoo_common as zc  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import IB_BW  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model, xlstm  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

# the reference's dryrun sets XLA_FLAGS for a 512-device host platform
# when imported; this process's jax is already up, and the flag must not
# reach the subprocesses of tests that run after this file
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

MESHES = {"single": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}


class StubMesh:
    def __init__(self, **shape):
        self.shape = shape


def test_input_shapes_match_reference():
    assert list(INPUT_SHAPES) == list(JSHAPES)
    for name, sh in INPUT_SHAPES.items():
        assert dataclasses.asdict(sh) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_exact(arch):
    """The reference's ``model_flops`` sizes a leaf by ``jnp.prod`` of its
    shape, in int32 unless 64-bit ints are on: it wraps for a leaf of
    2**31 elements or more (kimi-k2's expert tables, internlm2's and
    internvl2's stacked MLP weights).  With 64-bit ints it counts
    exactly, and the port's Python ints agree."""
    big = any(leaf.numel() >= 2 ** 31 for leaf in cost._tensors(
        tspecs.param_structs(build_model(get_config(arch)))))
    for shape in INPUT_SHAPES:
        with jax.enable_x64(True):
            want = jdryrun.model_flops(jget_config(arch), shape)
        assert dryrun.model_flops(get_config(arch), shape) == want, shape
    wrapped = jdryrun.model_flops(jget_config(arch), shape)
    assert (wrapped != want) == big


# ---------------------------------------------------------------------------
# per-device argument and output bytes
# ---------------------------------------------------------------------------


def _spec(ns, ndim):
    """A reference sharding (or None: replicated) -> a full-length
    tuple."""
    spec = tuple(ns.spec) if ns is not None else ()
    return spec + (None,) * (ndim - len(spec))


def jbytes(structs, shardings, mesh):
    """The formula over the reference's structs: each leaf's per-device
    bytes under its sharding (None: replicated)."""
    leaves = jax.tree_util.tree_leaves(structs)
    specs = (jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
        if shardings is not None else [None] * len(leaves))
    assert len(specs) == len(leaves)
    return sum(int(np.prod(tspecs.local_shape(
        l.shape, _spec(s, len(l.shape)), mesh))) * l.dtype.itemsize
        for l, s in zip(leaves, specs))


def reference_bytes(jcfg, shape_name, mesh_shape):
    """(argument bytes, output bytes) per device of the reference's step,
    its arguments as ``build_lowered`` gives them (the step number left
    out), its outputs from ``eval_shape``: params and optimizer state
    keep their specs, logits their batch's, caches ``cache_specs``."""
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    stub = StubMesh(**mesh_shape)
    sh = JSHAPES[shape_name]
    model = jbuild(jcfg)
    params = jspecs.param_structs(model)
    pspecs = jrules.param_specs(params, jcfg, mesh)

    def strip(tree):
        return jax.tree_util.tree_map(
            lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), tree)

    def shardings(tree):
        return jax.tree_util.tree_map(lambda l: l.sharding, tree)

    if sh.kind == "train":
        batch = jspecs.train_batch_structs(jcfg, shape_name, mesh)
        if "pod" in mesh_shape:
            n = mesh_shape["pod"]
            step_fn, opt = jsteps.make_fl_train_step(model, jcfg)
            params = jspecs.stack_structs(params, n)
            pspecs = jspecs.prepend_pod(pspecs, mesh)
            extra = (jax.ShapeDtypeStruct((n,), jnp.float32),)
        else:
            step_fn, opt = jsteps.make_train_step(model, jcfg)
            extra = ()
        ostate = jax.eval_shape(opt.init, params)
        ospecs = {k: pspecs for k in ostate}
        args = ((params, pspecs), (ostate, ospecs),
                (batch, shardings(batch))) + tuple((e, None) for e in extra)
        out = jax.eval_shape(step_fn, params, ostate, strip(batch),
                             jax.ShapeDtypeStruct((), jnp.int32), *extra)
        outs = [(out[0], pspecs), (out[1], ospecs), (out[2], None)]
    elif sh.kind == "prefill":
        batch = jspecs.prompt_batch_structs(jcfg, sh.global_batch,
                                            sh.seq_len, mesh)
        args = ((params, pspecs), (batch, shardings(batch)))
        logits, cache = jax.eval_shape(jsteps.make_prefill_step(model),
                                       params, strip(batch))
        bs = jrules.batch_spec(stub)
        outs = [(logits, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(*bs))),
            (cache, jrules.cache_specs(cache, mesh, sh.global_batch))]
    else:
        cache, pos, _ = jspecs.decode_cache_structs(jcfg, model, shape_name,
                                                    mesh)
        win = jspecs.decode_window(jcfg, shape_name)
        B = sh.global_batch
        dsize = mesh_shape.get("data", 1)
        tok = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            "data") if B % dsize == 0 and B >= dsize
            else jax.sharding.PartitionSpec())
        tokens = jax.ShapeDtypeStruct((B,), jnp.int32)
        args = ((params, pspecs), (cache, shardings(cache)), (tokens, tok))
        logits, ocache = jax.eval_shape(
            jsteps.make_decode_step(model, window=win), params,
            strip(cache), tokens, pos)
        outs = [(logits, tok), (ocache, shardings(cache))]
    return (sum(jbytes(t, s, stub) for t, s in args),
            sum(jbytes(t, s, stub) for t, s in outs))


def port_bytes(cfg, shape_name, mesh_shape):
    """(argument bytes, output bytes) of the dry run's record."""
    mem = dryrun.measure(cfg, shape_name, StubMesh(**mesh_shape))["memory"]
    return mem["argument_size_B"], mem["output_size_B"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_and_output_bytes_match_reference(arch, mesh):
    jcfg, tcfg = zc.cfgs(arch)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        want = reference_bytes(jcfg, shape_name, MESHES[mesh])
        assert port_bytes(tcfg, shape_name, MESHES[mesh]) == want, \
            shape_name


# ---------------------------------------------------------------------------
# FLOPs against hlo_cost
# ---------------------------------------------------------------------------


def moe_dispatch_flops(cfg, B, S):
    """The reference's dense dispatch (``moe_apply``'s einsums), which the
    port's gather does without a matmul, in a ``value_and_grad`` step: per
    MoE layer, ``expert_in`` and ``y`` (2 forward, 3 backward: 5 x
    2·G·gs·E·C·D), ``dispatch`` (2·G·gs·E·C·K), ``pos`` and ``combine``'s
    gate contraction with its transpose (3 x 2·G·gs·K·E) and ``combine``'s
    backward over the slots (2·G·gs·E·C)."""
    gs = min(cfg.moe_group_size, B * S)
    G, E, K, D = B * S // gs, cfg.n_experts, cfg.top_k, cfg.d_model
    C = jmoe._capacity(cfg, gs)
    per_layer = (5 * 2 * G * gs * E * C * D + 2 * G * gs * E * C * K
                 + 3 * 2 * G * gs * K * E + 2 * G * gs * E * C)
    return (cfg.n_layers - cfg.first_k_dense) * per_layer


def slstm_initial_carry_flops(cfg, B, S):
    """The reference's scan transposes every step alike, so its backward
    also forms the cotangent of the initial carry h_0 (a zero constant):
    one recurrent einsum, 2·B·4·H·hd² (H = 4 sLSTM heads), per sLSTM
    layer.  Autograd skips it: h_0 needs no gradient."""
    hd = cfg.d_model // xlstm.SLSTM_HEADS
    return (cfg.n_layers // 2) * 2 * B * 4 * xlstm.SLSTM_HEADS * hd * hd


def ssd_einsum_flops(cfg, B, S):
    """The SSD's three-operand einsums (``y_off``, ``chunk_states``):
    torch contracts an elementwise pair first, and autograd
    differentiates that pair by a multiply and a sum, where XLA's
    transpose forms dots: ``y_off``'s gradients of C and of the decay
    (2 x 2·B·S·N·H) and ``chunk_states``' gradient of the decay
    (2·B·S·H·P), per Mamba layer."""
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.hybrid_attn_every
    return n_mamba * 2 * B * S * H * (2 * N + P)


#: each named difference: what the reference's HLO counts and the port's
#: dispatched ops do not
NAMED = {"kimi-k2-1t-a32b": moe_dispatch_flops,
         "granite-moe-1b-a400m": moe_dispatch_flops,
         "xlstm-125m": slstm_initial_carry_flops,
         "zamba2-2.7b": ssd_einsum_flops}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_flops_match_hlo_cost(arch):
    jcfg, tcfg, jm, jp, jvg = tc.ref(arch)
    jb, tb = tc.batches(tcfg, 0)
    want = hlo_cost.analyze(jvg.lower(jp, jb).compile().as_text())["flops"]
    model = build_model(tcfg)
    params = model.init_params(prng_key(0), "meta")
    batch = {k: torch.empty(v.shape, dtype=torch.int32 if k == "tokens"
                            else v.dtype, device="meta")
             for k, v in tb.items()}
    got = cost.analyze(tsteps.value_and_grad(model.train_loss), params,
                       batch)["flops"]
    named = NAMED.get(arch, lambda *a: 0)(tcfg, tc.B, tc.S)
    assert got + named == want, (got, named, want)
    if arch in NAMED:
        assert named > 0


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


#: (B, S) of each trip-count case: the sLSTM loops over S steps (below 6
#: every step runs)
TRIP_SHAPES = ((2, 3), (2, 9), (16, 24))


@pytest.mark.parametrize("remat", [False, True])
def test_trip_count_equals_the_full_loop(remat):
    cfg = dataclasses.replace(zc.cfgs("xlstm-125m")[1], remat=remat)
    model = build_model(cfg)
    params = model.init_params(prng_key(0), "meta")
    fwd = torch.no_grad()(model.forward)
    vg = tsteps.value_and_grad(model.train_loss)
    for B, S in TRIP_SHAPES:
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device="meta")}
        for fn in (fwd, vg):
            got = cost.analyze(fn, params, batch)
            want = cost.analyze(fn, params, batch, trip_count=False)
            for k in ("flops", "bytes", "peak_live_B"):
                assert got[k] == want[k], (B, S, fn, k)


def test_trips_is_range_outside_the_counter():
    assert list(checks.trips(7)) == list(range(7))
    seen = []
    cost.analyze(lambda: seen.extend(checks.trips(9)))
    assert seen == [0, 1, 2, 7, 8]
    seen.clear()
    cost.analyze(lambda: seen.extend(checks.trips(5)))
    assert seen == list(range(5))
    seen.clear()
    with checks.meta_trace():  # no counter: every step
        seen.extend(checks.trips(9))
    assert seen == list(range(9))


def test_trip_count_refuses_real_tensors():
    """Trip counting skips steps, which would leave a real tensor's rows
    unwritten: it takes meta tensors only."""
    with pytest.raises(ValueError, match="meta tensors, not cpu"):
        cost.analyze(lambda x: x + 1, torch.zeros(3))
    assert cost.analyze(lambda x: x + 1, torch.zeros(3),
                        trip_count=False)["bytes"] == 2 * 3 * 4


class HostCopies(TorchDispatchMode):
    """Sums the operand and result bytes of copies from the CPU to
    another device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default and \
                args[0].device.type == "cpu" and out.device.type != "cpu":
            self.bytes += 2 * cost.tensor_bytes(out)
        return out


def test_meta_route_counts_what_the_cpu_counts():
    """The same prefill on the CPU and on meta: the same FLOPs, peak and
    bytes, but for the host-made constants (RoPE's frequencies) that a
    device run copies over and a CPU run uses where they are."""
    cfg = zc.cfgs("qwen3-1.7b")[1]
    model = build_model(cfg)
    step = tsteps.make_prefill_step(model)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    cpu = cost.analyze(step, model.init_params(prng_key(0), "cpu"),
                       {"tokens": torch.from_numpy(toks)}, trip_count=False)
    params = model.init_params(prng_key(0), "meta")
    meta_batch = {"tokens": torch.empty((2, 16), dtype=torch.int64,
                                        device="meta")}
    with HostCopies() as copies:
        meta = cost.analyze(step, params, meta_batch)
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["peak_live_B"] == cpu["peak_live_B"]
    assert meta["bytes"] == cpu["bytes"] + copies.bytes
    # q's and k's frequencies in each layer, f32, read and written
    assert copies.bytes == cfg.n_layers * 2 * 4 * (cfg.hd // 2) * 2
    # outside the context the kernels refuse the meta device
    with pytest.raises(ValueError, match="unsupported device meta"):
        step(params, meta_batch)


def test_op_bytes_of_one_matmul():
    M, K, N = 64, 48, 32
    a = torch.empty((M, K), device="meta")
    b = torch.empty((K, N), device="meta")
    res = cost.analyze(lambda x, y: x @ y, a, b)
    assert res["flops"] == 2 * M * K * N
    assert res["bytes"] == 4 * (M * K + K * N + M * N)
    assert res["peak_live_B"] == 4 * (M * K + K * N + M * N)
    # a view moves nothing
    assert cost.analyze(lambda x: x.t(), a)["bytes"] == 0


# ---------------------------------------------------------------------------
# the CLI and records
# ---------------------------------------------------------------------------


def test_cli_writes_records_to_its_own_directory(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    dryrun.main(["--arch", "xlstm-125m", "--shape", "prefill_32k",
                 "--mesh", "single,multi"])
    out = tmp_path / "experiments" / "dryrun_torch"
    assert not (tmp_path / "experiments" / "dryrun").exists()
    recs = [json.loads((out / f"xlstm-125m__prefill_32k__{m}.json")
                       .read_text()) for m in ("single", "multi")]
    for rec, m in zip(recs, MESHES.values()):
        assert rec["status"] == "OK" and rec["mesh"] == m
        assert rec["model_flops"] == jdryrun.model_flops(
            jget_config("xlstm-125m"), "prefill_32k")
        assert rec["flops_global"] > rec["model_flops"] * 0.1
        assert rec["flops_per_device"] * (256 if m == MESHES["single"]
                                          else 512) == rec["flops_global"]
        assert rec["bottleneck"] in rec["roofline"]
        assert rec["collective_bytes"] == {}
    assert capsys.readouterr().out.count("[OK] xlstm-125m") == 2
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-1.7b", "--variant", "unroll"])
    assert "scan_layers" in capsys.readouterr().err


def test_qwen3_train_record():
    rec = dryrun.measure(get_config("qwen3-1.7b"), "train_4k",
                         StubMesh(**MESHES["single"]))
    assert rec["model_flops"] == 6 * 2_038_555_648 * 1_048_576
    assert round(rec["flops_global"] / 1e12) == 17_003
    assert abs(rec["useful_flops_ratio"] - 0.754) < 5e-4
    assert rec["collective_bytes"]["data_all_reduce"] > 0
    # the 16-wide data axis leaves a node: InfiniBand's rate
    assert rec["roofline"]["collective_s"] == \
        rec["collective_bytes"]["data_all_reduce"] / IB_BW
    assert rec["peak_live_B_global"] > rec["memory"]["argument_size_B"]
