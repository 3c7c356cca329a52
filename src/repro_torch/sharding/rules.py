"""Path-based sharding rules: params tree -> spec tree (the reference's
``repro/sharding/rules.py``), as pure Python over shapes.

A spec (:class:`Spec`, a tuple) has one entry per dim: ``None``
(replicated), an axis name, or a tuple of axis names (the content of the
reference's ``PartitionSpec``).  A mesh is anything with ``.shape``, a mapping from
axis name to size (:func:`repro_torch.launch.mesh.make_production_mesh`,
or the reference tests' ``StubMesh``): the rules read nothing else.

Two policies (selected per arch config):

  * ``megatron`` — tensor parallel on the "model" axis:
      column-parallel: wq/wk/wv, mlp w1/w3, ssm in_proj, xlstm up/w
      row-parallel:    wo, mlp w2, ssm out_proj, xlstm down
      vocab-parallel:  embed/head on the (padded) vocab dim
      MoE:             expert dim on "model" (expert parallelism)
  * ``fsdp`` — megatron + every parameter additionally sharded on "data"
      over its largest still-replicated divisible dim (ZeRO-3).

Leading *scan* dims (stacked layers; zamba2 has two: groups x per-group) are
never sharded.  Non-divisible dims fall back to replication.  The port's
``init_params`` draws the reference's tree, so the dot-joined paths
(``layers_dense.attn.wq``) are the reference's.
"""
from __future__ import annotations

import re
from typing import Callable, Tuple



class Spec(tuple):
    """A tuple of spec entries, one a dim; a leaf of a spec tree (where
    a plain tuple is a node)."""

    def __add__(self, other) -> "Spec":
        return Spec(tuple(self) + tuple(other))

    def __radd__(self, other) -> "Spec":
        return Spec(tuple(other) + tuple(self))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)}"


# container name -> number of leading stacked (scan) dims to skip
_SCAN_CONTAINERS = {
    "layers_dense": 1, "layers_moe": 1, "mamba": 2, "mblocks": 1,
    "sblocks": 1, "enc": 1, "dec": 1,
}

# (regex on the dot-joined path, spec for the *trailing* dims)
# "C" = column-parallel (shard last dim), "R" = row-parallel (shard dim 0 of
# the trailing shape), "V" = vocab-parallel, "E" = expert-parallel, None = rep
_RULES = [
    (r"(^|\.)embed$", "V"),
    (r"(^|\.)head$", "C"),
    (r"\b(wq|wk|wv)$", "C"),
    (r"\bwo$", "R"),
    (r"\b(w1|w3)$", "_moe_or_col"),
    (r"\bw2$", "_moe_or_row"),
    (r"\brouter$", None),
    (r"\bin_proj$", "C"),
    (r"\bout_proj$", "R"),
    (r"\bconv_w$", "C"),
    (r"\b(up|ff1)$", "C"),
    (r"\b(down|ff2)$", "R"),
    (r"\bw$", "C"),  # slstm input weights
    (r"\bprojector$", "C"),
]

# data-parallel mesh axes, outermost first: the hierarchical SAFL "edge"
# axis nests outside its "pod" sub-axis, and the production serve meshes
# carry "data"
_DATA_AXES = ("edge", "pod", "data")


def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(dot-joined path, leaf)`` over a tree of dicts, lists and
    tuples (a :class:`Spec` is a leaf), keeping its structure (list and
    tuple indices join as numbers, as the reference's ``_path_str`` joins
    them)."""
    join = (lambda k: f"{path}.{k}") if path else str
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _n_scan_dims(path_s: str) -> int:
    for name, n in _SCAN_CONTAINERS.items():
        if re.search(rf"(^|\.){name}(\.|$)", path_s):
            return n
    return 0


def _divisible(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.shape and dim % mesh.shape[axis] == 0


def spec_for_path(path_s: str, shape: Tuple[int, ...], mesh, policy: str,
                  is_moe_expert_table: bool) -> Spec:
    n_scan = _n_scan_dims(path_s)
    trail = shape[n_scan:]
    spec: list = [None] * len(shape)

    kind = None
    for pat, k in _RULES:
        if re.search(pat, path_s):
            kind = k
            break
    if kind == "_moe_or_col":
        kind = "E" if is_moe_expert_table else "C"
    if kind == "_moe_or_row":
        kind = "E" if is_moe_expert_table else "R"

    if kind and len(trail) >= 1:
        if kind == "C" and _divisible(trail[-1], mesh, "model"):
            spec[len(shape) - 1] = "model"
        elif kind == "R" and len(trail) >= 2 and _divisible(
                trail[0], mesh, "model"):
            spec[n_scan] = "model"
        elif kind in ("V", "E") and _divisible(trail[0], mesh, "model"):
            spec[n_scan] = "model"  # vocab / expert dim

    if policy == "fsdp":
        spec = add_fsdp(spec, shape, n_scan, mesh)
    return Spec(spec)


def add_fsdp(spec: list, shape: Tuple[int, ...], n_scan: int,
             mesh) -> list:
    """Shard the largest still-replicated, divisible trailing dim on
    "data"."""
    if "data" not in mesh.shape:
        return spec
    cands = [(shape[i], i) for i in range(n_scan, len(shape))
             if spec[i] is None and _divisible(shape[i], mesh, "data")]
    if cands:
        _, i = max(cands)
        spec[i] = "data"
    return spec


def param_specs(params, cfg, mesh):
    """The spec tree matching ``params`` (tensors or anything with
    ``.shape``)."""

    def one(ps, leaf):
        is_expert = bool(re.search(r"(^|\.)moe\.", ps)) and \
            re.search(r"\bw[123]$", ps) is not None
        return spec_for_path(ps, tuple(leaf.shape), mesh, cfg.sharding,
                             is_expert)

    return map_with_path(one, params)


def _batch_entry(mesh):
    axes = tuple(a for a in _DATA_AXES if a in mesh.shape)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_spec(mesh) -> Spec:
    """Global batch dim over all data-parallel axes present (the batch
    lays over the flattened (edge, pod) axis on a hierarchical mesh)."""
    return Spec((_batch_entry(mesh),))


def cache_specs(cache, mesh, batch: int):
    """KV/state caches: batch dim on the data-parallel axes when divisible,
    else the largest divisible dim on "data"; then the largest remaining
    dim of at least 16,384 on "model" (KV capacity; ring-buffer windows
    stay replicated).  Cache leaves: (L, B, C, H, hd) attn; (L/G, B, H,
    P, N) ssm states; xlstm states (B, H, ...).  The batch dim is the
    first dim equal to ``batch``, dim 0 included: a stacked layer count
    equal to the batch would take the batch's spec."""
    dsize = mesh.shape.get("data", 1)
    msize = mesh.shape.get("model", 1)
    btotal = 1
    for a in _DATA_AXES:
        btotal *= mesh.shape.get(a, 1)
    bspec = _batch_entry(mesh)

    def one(_, leaf):
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        spec: list = [None] * ndim
        if ndim >= 2:
            for i in range(ndim):
                if shape[i] == batch and batch % btotal == 0 and \
                        batch >= btotal:
                    spec[i] = bspec
                    break
            else:
                cands = [(shape[i], i) for i in range(1, ndim)
                         if shape[i] % dsize == 0 and shape[i] >= dsize]
                if cands:
                    _, i = max(cands)
                    spec[i] = "data"
            cands = [(shape[i], i) for i in range(1, ndim)
                     if spec[i] is None and shape[i] % msize == 0
                     and shape[i] >= max(msize, 16_384)]
            if cands:
                _, i = max(cands)
                spec[i] = "model"
        return Spec(spec)

    return map_with_path(one, cache)

