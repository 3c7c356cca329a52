"""Mesh construction for the multi-device SAFL engine, and the
cross-edge roofline over an H100's NVLink.

``make_pod_mesh`` / ``make_hier_mesh`` build the meshes of
:mod:`repro_torch.sharding.flat` (``FLConfig.devices`` /
``FLConfig.mesh_shape``); :func:`cross_edge_time_s` turns a server's
cross-edge bytes (``FlatServer.traffic["cross_edge_bytes"]``) into
seconds over one link.  The LLM's production and debug meshes come with
its sharding rules.
"""
from __future__ import annotations

from repro_torch.sharding import flat

# NVIDIA H100 SXM5's documented NVLink 4: 18 links, 900 GB/s per GPU in
# both directions together, 450 GB/s each way
NVLINK_BW = 450e9  # B/s


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

