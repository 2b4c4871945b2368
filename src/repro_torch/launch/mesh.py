"""Production device meshes as ``torch.distributed`` ``DeviceMesh``es,
mirroring ``repro.launch.mesh``.

Defined as FUNCTIONS so importing this module starts no process group:
the caller (a launcher on a real cluster, or the dry-run on a fake group)
initializes ``torch.distributed`` first.
"""

from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.launch.sharding import axis_names


def production_shape(multi_pod: bool = False) -> tuple:
    """The production mesh's device counts: (16, 16) or (2, 16, 16), or
    REPRO_MESH_SHAPE's (e.g. "4,8" or "2,4,4") for fast debugging
    iterations."""
    env = os.environ.get("REPRO_MESH_SHAPE")
    if env:
        return tuple(int(x) for x in env.split(","))
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 H100s) or 2x16x16 multi-pod (512 H100s), with
    the reference's axis names: ("data", "model") or ("pod", "data",
    "model"), as many as ``production_shape`` has entries.  The GPUs sit 8
    to a node (NVLink within a node, InfiniBand across nodes), so one
    16-wide "model" row spans two nodes.  The world size of the
    initialized process group must equal the mesh's device count.
    """
    shape = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=(
        "pod", "data", "model")[-len(shape):])


def make_host_mesh(device="cuda") -> DeviceMesh:
    """Degenerate 1x1 ("data", "model") mesh on a one-rank process group
    (started here on a free localhost port when none is initialized):
    the sharded code paths on one device, as the reference's host mesh."""
    device_type = str(device).split(":")[0]
    if not dist.is_initialized():
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    assert dist.get_world_size() == 1, "the host mesh is one device"
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
