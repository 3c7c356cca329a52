"""Mesh construction: the multi-device SAFL engine's meshes, the zoo's
production and debug meshes for the sharding rules and the dry run, and
the roofline constants of one H100.

``make_pod_mesh`` / ``make_hier_mesh`` build the meshes of
:mod:`repro_torch.sharding.flat` (``FLConfig.devices`` /
``FLConfig.mesh_shape``); :func:`cross_edge_time_s` turns a server's
cross-edge bytes (``FlatServer.traffic["cross_edge_bytes"]``) into
seconds over one link.  :func:`make_production_mesh` and
:func:`make_debug_mesh` are axis-size meshes (:class:`AxisMesh`): the
sharding rules (:mod:`repro_torch.sharding.rules`) read only their
``shape``, and the dry run (:mod:`repro_torch.launch.dryrun`) places
nothing on a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.sharding import flat

# Roofline constants of one NVIDIA H100 SXM5 ("NVIDIA H100 80GB HBM3,
# 700.00 W" as nvidia-smi --query-gpu=name,power.limit gives them), from
# NVIDIA's H100 data sheet at the 700 W limit: dense bf16 tensor-core
# peak (without sparsity), HBM3 bandwidth, and NVLink 4 (18 links, 900
# GB/s per GPU in both directions together, 450 GB/s each way)
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s
# Between nodes, from NVIDIA's DGX H100 data sheet: 8 GPUs a node on
# NVLink, and one single-port ConnectX-7 400 Gb/s InfiniBand adapter a
# GPU (50 GB/s each way)
GPUS_PER_NODE = 8
IB_BW = 50e9  # B/s


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """A mesh as the sharding rules see it: ``shape``, axis name -> size
    (in axis order)."""
    shape: Dict[str, int]


def make_production_mesh(*, multi_pod: bool = False) -> AxisMesh:
    """Single pod: 16 x 16 over ("data", "model"); multi-pod: 2 x 16 x 16
    over ("pod", "data", "model"), the "pod" axis carrying the paper's
    federated aggregation."""
    if multi_pod:
        return AxisMesh({"pod": 2, "data": 16, "model": 16})
    return AxisMesh({"data": 16, "model": 16})


def make_debug_mesh(n_devices: int = 1) -> AxisMesh:
    """(1, n) over ("data", "model")."""
    return AxisMesh({"data": 1, "model": n_devices})


def mesh_chips(mesh) -> int:
    return math.prod(mesh.shape.values())


def axis_bw(mesh, axis: str) -> float:
    """One direction's link rate a device for a collective over ``axis``:
    NVLink when the axis's ranks share a node (the last axis varies
    fastest, and ``GPUS_PER_NODE`` consecutive devices make a node),
    else the node's InfiniBand (``IB_BW``)."""
    names = list(mesh.shape)
    span = math.prod(mesh.shape[a] for a in names[names.index(axis):])
    return NVLINK_BW if span <= GPUS_PER_NODE else IB_BW


def make_pod_mesh(n_devices: int, devices=None) -> flat.Mesh:
    """1-D mesh over the "pod" axis (``FLConfig.devices``): the channel
    rows and the wave lanes over ``n_devices`` shards
    (:func:`repro_torch.sharding.flat.make_pod_mesh`; ``devices="cpu"``
    puts every shard on the CPU)."""
    return flat.make_pod_mesh(n_devices, devices)


def make_hier_mesh(edges: int, pods: int, devices=None) -> flat.Mesh:
    """2-D (edge, pod) mesh (``FLConfig.mesh_shape=(E, P)``): the pod
    partials of an edge tree-reduce first, then the E edge partials add
    (:mod:`repro_torch.sharding.flat`); ``edges == 1`` is the 1-D pod
    mesh (the ``devices=P`` alias)."""
    return flat.make_hier_mesh(edges, pods, devices)


def cross_edge_time_s(cross_edge_bytes: int,
                      link_bw: float = NVLINK_BW) -> float:
    """Roofline seconds for one aggregation's cross-edge traffic over one
    link (default: an H100 SXM's NVLink, one direction; a real edge
    uplink is slower still)."""
    return float(cross_edge_bytes) / float(link_bw)

