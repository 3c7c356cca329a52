"""Pytree checkpointing (npz + json treedef) with step retention, in the
reference's format.

Leaves go into one ``ckpt_{step:08d}.npz`` as ``leaf_{i}`` in
:func:`repro_torch.tree.tree_leaves`'s sorted-key order (``jax.tree_util``'s
for dicts), beside a ``ckpt_{step:08d}.json`` of the treedef and leaf
dtypes; the engine's host state goes into ``engine_{step:08d}.json``
(:func:`save_state_json`).  Each file is written to a temp file and
renamed.  The ``.json`` of the checkpoint is written last: it is the
commit record :func:`latest_steps` keys on.  Tensors pass through numpy
(``.cpu().numpy()``); bf16 leaves are stored as f32 and cast back on
load.  A leaf may also be a Python int or float (the server's optimizer
step count), stored as a 0-d array and loaded back as its type.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as treemod

Tree = Any

#: numpy dtypes stored as they are; any other (bf16) is stored as f32
_NATIVE = (np.float64, np.float32, np.float16, np.int64, np.int32,
           np.int16, np.int8, np.uint8, np.bool_)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    a = np.asarray(leaf)
    return a if a.dtype in _NATIVE else a.astype(np.float32)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    keep: int = 3) -> str:
    """Write ``tree``'s leaves as step ``step`` and keep the newest
    ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, treedef = treemod.tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(flat)}
    meta = {"step": step, "n_leaves": len(flat),
            "treedef": json.dumps(treedef, sort_keys=True),
            "dtypes": [_dtype_name(leaf) for leaf in flat]}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    # the temp name ends in ".npz" so np.savez writes this file and adds
    # no second suffix
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.json")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".json")
    _gc(ckpt_dir, keep)
    return path


def _gc(ckpt_dir: str, keep: int) -> None:
    """Remove every step but the newest ``keep``, sidecar included."""
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        for name in (f"ckpt_{s:08d}.npz", f"ckpt_{s:08d}.json",
                     f"engine_{s:08d}.json"):
            p = os.path.join(ckpt_dir, name)
            if os.path.exists(p):
                os.remove(p)


def save_state_json(ckpt_dir: str, step: int, state: Any) -> str:
    """Write the engine's host-state sidecar ``engine_{step:08d}.json``.
    Python's json round-trips floats exactly (repr-based), so simulated
    clocks and heap times survive bit for bit.  :func:`_gc` removes the
    sidecar of a dropped step with its arrays."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"engine_{step:08d}.json")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.json")
    with os.fdopen(fd, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
    return path


def load_state_json(ckpt_dir: str, step: int) -> Any:
    with open(os.path.join(ckpt_dir, f"engine_{step:08d}.json")) as f:
        return json.load(f)


def latest_steps(ckpt_dir: str):
    """The committed steps (those whose checkpoint ``.json`` exists),
    ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("ckpt_") and f.endswith(".json"):
            out.append(int(f[5:13]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, template: Tree,
                    step: Optional[int] = None) -> Tuple[Tree, int]:
    """Restore into the structure of ``template``: each tensor leaf on
    the template leaf's device, its shape and dtype checked against the
    template's; a Python scalar leaf as its type."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    flat, treedef = treemod.tree_flatten(template)
    with open(path + ".json") as f:
        dtypes = json.load(f)["dtypes"]
    if len(flat) != len(dtypes):
        raise ValueError(f"leaf count mismatch: {len(flat)} vs "
                         f"{len(dtypes)}")
    want = [_dtype_name(leaf) for leaf in flat]
    if dtypes != want:
        raise ValueError(f"leaf dtypes {dtypes} != the template's {want}")
    leaves = []
    with np.load(path + ".npz") as data:
        for i, ref in enumerate(flat):
            a = data[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: {a.shape} != "
                                     f"{tuple(ref.shape)}")
                leaves.append(torch.from_numpy(np.array(a)).to(
                    device=ref.device, dtype=ref.dtype))
            else:
                if a.shape != ():
                    raise ValueError(f"leaf {i}: {a.shape} is not a "
                                     "scalar")
                leaves.append(type(ref)(a.item()))
    return treemod.tree_unflatten(treedef, leaves), step
