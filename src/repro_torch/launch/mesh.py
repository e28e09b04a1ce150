"""Production mesh builders over DeviceMesh.

The reference lays 256 or 512 placeholder XLA host devices out as its
TPU pods (`--xla_force_host_platform_device_count=512`, set process-wide
before jax loads).  Here a production mesh lives over a fake process
group of as many ranks (`torch.testing`'s "fake" backend: collectives
complete at once and move nothing) for as long as the `with` lasts, and
the group is destroyed on exit, so the two meshes' world sizes never meet
and no group outlives its caller.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.common import axis_names

POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@contextlib.contextmanager
def fake_mesh(shape, names):
    """Yield a CPU DeviceMesh of `shape` with axis `names` over a fake
    process group of prod(shape) ranks (this process is rank 0),
    destroyed on exit.  Refuses to start while another process group is
    live: a leftover group would carry its world size into the next
    mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already live; a fake mesh"
                           " starts a group of its own and cannot share"
                           " one")
    world = 1
    for s in shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)
    try:
        yield flatten_runs(init_device_mesh("cpu", tuple(shape),
                                            mesh_dim_names=tuple(names)))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """A context manager yielding the 16 x 16 ("data", "model") mesh, or
    with `multi_pod` the 2 x 16 x 16 ("pod", "data", "model") one, over a
    fake group of 256 or 512 ranks on the CPU (`fake_mesh`)."""
    return fake_mesh(*(MULTI_POD if multi_pod else POD))


def make_local_mesh(model: int = 1, data: int = 1, *, device: str = "cuda"):
    """A ("data", "model") mesh over the ranks of the live process group
    (data x model of them): a small mesh for tests and single-host runs.
    The caller starts the group (`torch.distributed.init_process_group`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a live process group")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model}"
                         f" ranks, the group has {dist.get_world_size()}")
    return flatten_runs(init_device_mesh(device, (data, model),
                                         mesh_dim_names=("data", "model")))


def flatten_runs(mesh):
    """`mesh`, with the flattened mesh of every run of two or more
    adjacent dimensions of more than one rank registered with it
    ("data_model"; on 2 x 16 x 16 also "pod_data" and "pod_data_model"):
    DTensor then runs a collective over several mesh dimensions as one
    over their flattened group, where it ran one a dimension, each moving
    the whole tensor (a pure-DP gradient, partial over `data` and `model`,
    was all-reduced twice; ROADMAP C26)."""
    names = mesh.mesh_dim_names
    for i in range(len(names)):
        for j in range(i + 2, len(names) + 1):
            if all(mesh.size(k) > 1 for k in range(i, j)):
                mesh[names[i:j]]._flatten()
    return mesh


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a mesh ('pod' folds into data-parallel)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
