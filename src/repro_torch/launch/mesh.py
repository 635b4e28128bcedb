"""Production mesh shapes for the launch tooling's dry run.

Counterpart of ``repro/launch/mesh.py``. Single pod: 16 x 16 = 256 devices,
axes (data, model). Multi-pod: 2 x 16 x 16 = 512 devices, axes (pod, data,
model). A mesh here is a shape with named axes and no device state: the
port runs one card per process, and the dry run only divides tensors over
the axes (``launch.sharding``) to count bytes per device.
"""
from __future__ import annotations


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
