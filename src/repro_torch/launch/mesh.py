"""Production mesh shapes for the launch tooling's dry run, and the
device mesh that traces a step as one device of them.

Counterpart of ``repro/launch/mesh.py``. Single pod: 16 x 16 = 256 devices,
axes (data, model). Multi-pod: 2 x 16 x 16 = 512 devices, axes (pod, data,
model). ``MeshShape`` is a shape with named axes and no device state, for
the byte accounting of ``launch.sharding``. ``fake_mesh`` makes a
``DeviceMesh`` of that shape over torch's fake process group, as rank 0 of
``size`` ranks in one process: its collectives return at once and move no
data, so a step traced on it runs rank 0's share of the partitioned step,
collectives included, on one card or on the meta device.
"""
from __future__ import annotations

import contextlib


class MeshShape:
    """Ordered axis name -> size, read through ``.shape`` as a
    ``jax.sharding.Mesh``'s is."""

    def __init__(self, sizes, axes):
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for axes {axes}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in sizes)))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def name(self) -> str:
        return "x".join(str(v) for v in self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_test_mesh(n_devices: int = 8) -> MeshShape:
    """A small (n / 2, 2) mesh over (data, model)."""
    return MeshShape((n_devices // 2, 2), ("data", "model"))


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over the fake
    backend, this process as rank 0 of ``mesh.size``: the default process
    group is made on entry and destroyed on exit. ``device_type`` is the
    mesh's: "cpu" for meta or CPU local tensors, "cuda" for the card's. A
    process holds one default group, so this raises if one is up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    _elementwise_gradients()
    try:
        with _all_to_all_on_cpu():
            yield init_device_mesh(device_type, tuple(mesh.shape.values()),
                                   mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def _elementwise_gradients() -> None:
    """softplus's gradient is elementwise, as softplus is, but DTensor
    lists only the forward among its pointwise ops and runs the gradient
    on whole tensors, gathering the batch (RWKV6's decay, Mamba2's dt).
    Registered as pointwise here, once, where this torch's DTensor has the
    registry (its layout is private and moves between versions)."""
    import torch
    try:
        from torch.distributed.tensor._ops import _pointwise_ops as pw
        register = pw._register_single_dim_pointwise
    except (ImportError, AttributeError):
        return
    op = torch.ops.aten.softplus_backward.default
    if op not in pw.pointwise_ops:
        pw.pointwise_ops.append(op)
        register(op)


@contextlib.contextmanager
def _all_to_all_on_cpu():
    """DTensor moves a shard from one dim to another with one all-to-all
    (``_dtensor.shard_dim_alltoall``) on a CUDA mesh, and with an
    all-gather and a chunk on a CPU mesh, since gloo has no all-to-all.
    The fake group moves no data on either, so here a CPU mesh issues the
    all-to-all too, and a step counts the same collectives on meta as on
    the card."""
    import torch
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig
