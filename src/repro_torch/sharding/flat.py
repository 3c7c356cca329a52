"""The pod and (edge, pod) meshes of the flat (K, D) SAFL channel, on one
controller.

One process runs the scheduler, the engine and every host decision (the
schedule, each upload's shard, the weights) once, as the reference's
single-controller program does; a mesh only says where each shard's rows
live and in which order the shards' partials add.

  * **1-D "pod" mesh** (``FLConfig.devices``, :func:`make_pod_mesh`):
    shard s holds rows [s*K/N, (s+1)*K/N) of the channel; the server
    round is a per-shard partial weighted sum, and the N partials add in
    shard order (:func:`mesh_reduce`).
  * **2-D (edge, pod) mesh** (``FLConfig.mesh_shape=(E, P)``,
    :func:`make_hier_mesh`): shard (e, p) is number e*P + p.  The P
    partials of an edge add in the XOR pairing of recursive doubling
    (round r adds partner i ^ 2**r: bitwise the reference's
    ``ref.xor_tree_sum_ref``), then the E edge partials add in edge
    order, so only E operands cross the edge boundary (the traffic model
    :func:`edge_traffic`).  ``edges == 1`` builds the 1-D pod mesh
    itself, so ``mesh_shape=(1, P)`` is the ``devices=P`` path bit for
    bit.

A shard's device is explicit: ``devices`` is a list (the reference's
``devices=`` argument), ``"cpu"`` puts all N shards on the one CPU device
(the counterpart of ``--xla_force_host_platform_device_count``), and
``None`` or ``"cuda"`` takes the first N visible GPUs and raises when
there are fewer.  N shards on one card take ``[torch.device("cuda:0")] *
N``; nothing picks that silently.  A partial that leaves its device to
be added moves with ``Tensor.to`` (what ``ppermute`` is between
devices); with every shard on one device the move is a no-op and the
order still holds.  The host's weight masses (np.float32) follow the
same tree as the sums.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

POD_AXIS = "pod"
EDGE_AXIS = "edge"


class Mesh:
    """E x P shards, shard (e, p) number e*P + p on ``devices[e*P + p]``.
    ``axis_names`` are the reference mesh's: ``("pod",)`` on the 1-D
    mesh, ``("edge", "pod")`` on the 2-D one.  Shard 0's device is the
    controller's home: the server's state and the reduced sums live
    there."""

    def __init__(self, devices: Sequence[torch.device], edges: int,
                 pods: int):
        self.devices = tuple(devices)
        if len(self.devices) != edges * pods:
            raise ValueError(f"{len(self.devices)} devices for an "
                             f"{edges}x{pods} mesh")
        self.edges, self.pods = int(edges), int(pods)
        self.axis_names = ((EDGE_AXIS, POD_AXIS) if self.edges > 1
                           else (POD_AXIS,))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.edges}x{self.pods}, "
                f"{[str(d) for d in self.devices]})")


def _pool(n: int, devices) -> List[torch.device]:
    """The first ``n`` devices of ``devices`` (see the module doc)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = torch.device("cuda" if devices is None else devices)
        if dev.type == "cpu":
            return [torch.device("cpu")] * n
        if dev.type != "cuda" or dev.index is not None:
            if n != 1:
                raise ValueError(f"a mesh of {n} shards on the one device "
                                 f"{dev}: pass the shards' devices as a "
                                 "list")
            return [resolve_device(dev)]
        resolve_device(dev)  # raises without a GPU
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} devices needs {n} visible GPUs, {have} "
                "visible; put several shards on one card with an explicit "
                "device list, or run on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"requested {n} mesh devices, have {len(devs)}")
    devs = devs[:n]
    for d in devs:
        resolve_device(d)
    # a bare "cuda" names the current card, as a tensor made there says
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def make_pod_mesh(n_devices: int, devices=None) -> Mesh:
    """1-D mesh of ``n_devices`` shards, axis "pod"."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1")
    return Mesh(_pool(n_devices, devices), 1, n_devices)


def make_hier_mesh(edges: int, pods: int, devices=None) -> Mesh:
    """2-D (edge, pod) mesh of ``edges * pods`` shards; ``edges == 1``
    returns the 1-D pod mesh.  ``pods`` must be a power of two (the
    intra-edge tree pairs shards by XOR rounds)."""
    if edges < 1 or pods < 1:
        raise ValueError(f"mesh ({edges}, {pods}) needs edges, pods >= 1")
    if pods & (pods - 1):
        raise ValueError(f"pod group size {pods} must be a power of two "
                         "(tree reduce)")
    if edges == 1:
        return make_pod_mesh(pods, devices)
    return Mesh(_pool(edges * pods, devices), edges, pods)


def is_hier(mesh: Optional[Mesh]) -> bool:
    """True for a 2-D (edge, pod) mesh (E > 1)."""
    return mesh is not None and EDGE_AXIS in mesh.axis_names


def mesh_shape(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(E, P): edge groups x pod shards per group (1-D mesh -> (1, P))."""
    if mesh is None:
        return (1, 1)
    return (mesh.edges, mesh.pods)


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def sum_in_order(w) -> np.float32:
    """np.float32 sum of ``w`` taken k = 0..K-1: the order one shard (or
    the single device) sums its weights in, which is the order the
    aggregate kernels and their plain versions sum theirs (numpy's own
    sum is pairwise above 8 elements)."""
    s = np.float32(0.0)
    for x in np.asarray(w, np.float32):
        s = np.float32(s + x)
    return s


def xla_sum(w) -> np.float32:
    """np.float32 sum of the host vector ``w`` in the order the
    reference's jitted ``jnp.sum`` takes on XLA's CPU backend: up to 32
    elements one after another from 0 (:func:`sum_in_order`); beyond, the
    vector zero-padded (half the padding in front, the odd one behind) to
    windows of 32, each window summed so, and the window sums reduced the
    same way (XLA's tree-reduction rewrite).  The int8-dot regime's mean
    normalizes its weights by it (``FlatServer``)."""
    w = np.asarray(w, np.float32).reshape(-1)
    while len(w) > 32:
        n = -(-len(w) // 32)
        pad = n * 32 - len(w)
        x = np.concatenate([np.zeros(pad // 2, np.float32), w,
                            np.zeros(pad - pad // 2, np.float32)])
        w = np.array([sum_in_order(x[i * 32:(i + 1) * 32])
                      for i in range(n)], np.float32)
    return sum_in_order(w)


def _add(a, b):
    """a + b, ``b`` first moved to ``a``'s device where it is a tensor."""
    if isinstance(b, torch.Tensor):
        # the partner's partial leaves its device to be added
        b = b.to(a.device)
    return a + b


def mesh_reduce(mesh: Mesh, parts: Sequence):
    """The mesh's fold of one partial a shard (tensors on the shards'
    devices, or host np.float32 masses), in shard number order: within
    each edge the XOR pairing of recursive doubling (round r adds shard i
    and i ^ 2**r; the sum lands on the edge's first shard), then the edge
    partials in edge order.  On the 1-D mesh (one edge) that is every
    shard in order.  The result is on shard 0's device."""
    parts = list(parts)
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} partials for {mesh.size} shards")
    if not is_hier(mesh):
        total = parts[0]
        for p in parts[1:]:
            total = _add(total, p)
        return total
    edge_sums = []
    for e in range(mesh.edges):
        grp = parts[e * mesh.pods:(e + 1) * mesh.pods]
        shift = 1
        while shift < mesh.pods:
            # every member of the group holds the same sum after a round
            # (float addition commutes); the first of each pair is kept
            for i in range(0, mesh.pods, 2 * shift):
                grp[i] = _add(grp[i], grp[i + shift])
            shift *= 2
        edge_sums.append(grp[0])
    total = edge_sums[0]
    for p in edge_sums[1:]:
        total = _add(total, p)
    return total


def shard_rows(x, mesh: Optional[Mesh]):
    """A K-row tensor (or tuple of them, a quantized or sparse payload) ->
    the list of each shard's row block on its device (``x`` itself
    without a mesh)."""
    if mesh is None:
        return x
    if isinstance(x, tuple):
        return [tuple(parts) for parts in
                zip(*(shard_rows(a, mesh) for a in x))]
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    return [x[s * per:(s + 1) * per].to(mesh.devices[s]) for s in range(n)]


def shard_weights(mesh: Mesh, shard_bufs: Sequence,
                  wvec: np.ndarray) -> List[np.ndarray]:
    """The full host weight vector (shard-major) cut into each shard's
    slice, ``len(wvec) / N`` long."""
    n = mesh.size
    wvec = np.asarray(wvec, np.float32)
    if len(shard_bufs) != n or len(wvec) % n:
        raise ValueError(f"{len(shard_bufs)} shard buffers and "
                         f"{len(wvec)} weights for {n} shards")
    per = len(wvec) // n
    return [wvec[s * per:(s + 1) * per] for s in range(n)]


def mesh_max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise max of one tensor a shard, on shard 0's device
    (the reference's ``pmax`` over every mesh axis; max is exact, so the
    order does not matter)."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(out.device))
    return out


def podwise_sums(mesh: Mesh, partial_fn: Callable) -> Callable:
    """The server reduction over the mesh: ``partial_fn(rows_s, w_s,
    **kw) -> (gsum_s, wsum_s)`` is one shard's unnormalized weighted row
    sum (on its device) and weight mass (host np.float32); the returned
    callable maps the per-shard rows and the full host weight vector
    (:func:`shard_weights`), and keyword arguments every shard gets, to
    the reduced ``(gsum, wsum)`` (:func:`mesh_reduce`)."""
    def reduce(shard_bufs: Sequence, wvec: np.ndarray, **kw):
        parts = [partial_fn(buf, w, **kw) for buf, w in
                 zip(shard_bufs, shard_weights(mesh, shard_bufs, wvec))]
        return (mesh_reduce(mesh, [g for g, _ in parts]),
                mesh_reduce(mesh, [m for _, m in parts]))

    return reduce


def podwise_bank_sums(mesh: Mesh) -> Callable:
    """The streaming server reduction: each shard's partial is its (1, D)
    bank row, folded on ingest, and its mass the in-order sum of its
    slice of the zero-padded ingest weights; on the 2-D mesh each edge's
    P rows are that edge's own accumulator (fold-at-edge)."""
    return podwise_sums(
        mesh, lambda row, w: (row.reshape(-1), sum_in_order(w)))


def lane_groups(mesh: Mesh, shards: Sequence[int]
                ) -> List[Tuple[torch.device, List[int]]]:
    """The lanes of a wave by the device of the shard that owns each
    lane's row: ``[(device, lane indices)]`` in first-seen order (one
    group when every shard is on one device)."""
    groups: Dict[torch.device, List[int]] = {}
    for lane, s in enumerate(shards):
        groups.setdefault(mesh.devices[s], []).append(lane)
    return list(groups.items())


def edge_traffic(mesh, partial_nbytes: int) -> Dict:
    """Cross-edge traffic model for one server reduction (the reference's
    record key for key).  ``mesh`` is a :class:`Mesh`, None, or a bare
    ``(E, P)`` tuple.  The unit of exchange is a partial of
    ``partial_nbytes`` plus its f32 weight mass; a flat reduction over N
    = E*P shards sends all N partials across, the hierarchical fold one
    per edge, so ``cross_edge_reduction`` = P on a 2-D mesh and 1.0 on a
    1-D (or absent) one."""
    if isinstance(mesh, tuple):
        edges, pods = mesh
        hier = edges > 1
    else:
        edges, pods = mesh_shape(mesh)
        hier = is_hier(mesh)
    n = edges * pods
    per_partial = int(partial_nbytes) + 4
    flat = n * per_partial
    cross = edges * per_partial if hier else flat
    return {
        "mesh_shape": (edges, pods),
        "cross_edge_partials": edges,
        "cross_edge_bytes": cross,
        "flat_cross_bytes": flat,
        "cross_edge_reduction": (flat / cross) if cross else 1.0,
    }
