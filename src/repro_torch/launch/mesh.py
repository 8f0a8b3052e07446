"""Production mesh definitions for the NVIDIA H100 target.

Single pod: 16x16 = 256 cards, axes (data, model).
Multi-pod:  2 pods x 256 = 512 cards, axes (pod, data, model).

The meshes are ``torch.distributed.device_mesh.DeviceMesh``es with the
JAX package's shapes and axis names. They are built by functions (never
module-level constants), so importing this module touches no device and
no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# H100 SXM5 80GB at its 700 W limit, NVIDIA's data sheet (dense rates, no
# sparsity); the names are the JAX module's, so the roofline reads alike
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per card, bf16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
# NVLink 4 (data sheet): 18 links, 900 GB/s per card both ways together,
# so 450 GB/s each way. An 8-card node joins its cards all to all through
# NVSwitch; a 16-way ``model`` axis spans two such nodes, so half of its
# peers sit across the node boundary (InfiniBand, ~50 GB/s per card each
# way with one 400 Gb/s NIC a card), and its ring runs at that rate. The
# roofline takes the NVLink figure, as the JAX module takes one ICI link.
ICI_BW = 450e9               # bytes/s per card, each way


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """The 16x16 (or 2x16x16) mesh over the default process group, which
    must hold 256 (or 512) ranks: a real job's, or the ``"fake"`` group
    the dry-run initialises (with ``device_type="cpu"``: it traces fake
    tensors, card or not). ``device_type`` defaults to the card where
    there is one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_devices: int | None = None, *,
                    device_type: str | None = None) -> DeviceMesh:
    """A ``(1, n)`` mesh over the default process group (tests / smoke);
    ``n`` defaults to the group's size. Without a group, a one-rank group
    is created first, over a ``HashStore`` (no address, no port): nccl on
    the card, gloo on the CPU."""
    dt = _device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dt == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = n_devices or dist.get_world_size()
    return init_device_mesh(dt, (1, n), mesh_dim_names=("data", "model"))
