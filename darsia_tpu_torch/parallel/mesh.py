"""Device meshes and the placement of a global tensor over one.

Counterpart of :mod:`darsia_tpu.parallel.mesh`.  A :class:`Mesh` is an
n-d array of ``torch.device`` with one name per axis, as
``jax.sharding.Mesh`` is: a ``batch`` axis for the time series and a
``space`` axis for the domain decomposition of one image.  A device may
appear several times: a mesh that names ``cuda:0`` eight times runs every
shard, halo and reduction of an 8-device mesh on one card, as the JAX
package's tests run theirs on 8 virtual CPU devices.

A sharded array is a nested list of tensors with the mesh's shape, each on
its position's device.  A :class:`Placement` (the counterpart of
``NamedSharding``) names, per tensor axis, the mesh axis it is split over
(or None), and splits a global tensor into shards and joins them back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Placement", "batch_sharding", "create_mesh"]


def _check_device(device: torch.device) -> torch.device:
    """``device`` if it exists in this process, else raise: a mesh never
    falls back to another device."""
    device = torch.device(device)
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh device {device} is absent: this process sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA devices"
            )
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise RuntimeError(f"mesh device {device}: only cpu and cuda devices are supported")
    return device


class Mesh:
    """An n-d array of devices with named axes.

    Attributes:
        devices: numpy object array of ``torch.device``.
        axis_names: one name per axis.
        shape: ``{name: size}``, as ``jax.sharding.Mesh.shape``.
    """

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array, {len(axis_names)} axis names")
        checked = np.empty(devices.size, dtype=object)
        for k, device in enumerate(devices.reshape(-1)):
            checked[k] = _check_device(device)
        self.devices = checked.reshape(devices.shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def line(self, name: str) -> list:
        """The devices along axis ``name`` of a mesh whose other axes have
        size 1 (the one-axis solvers' meshes)."""
        others = [n for n in self.axis_names if n != name and self.shape[n] > 1]
        if others:
            raise ValueError(f"axes {others} besides {name!r} must have size 1")
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def create_mesh(
    mesh_shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("batch", "space"),
    devices=None,
) -> Mesh:
    """Create a device mesh.

    Args:
        mesh_shape: per-axis device counts; defaults to all devices on the
            first axis.
        axis_names: logical axis names (default ("batch", "space")).
        devices: explicit device list, a device may repeat (defaults to
            every CUDA device; without one that raises).

    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "create_mesh: no CUDA device; name the devices (e.g. "
                'devices=["cpu"] * 8) to build a mesh on the CPU'
            )
        devices = [torch.device("cuda", k) for k in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh shape {mesh_shape} incompatible with {n} devices")
    array = np.empty(n, dtype=object)
    for k, device in enumerate(devices):
        array[k] = device
    return Mesh(array.reshape(mesh_shape), axis_names)


def _nest(fn, shape: tuple, prefix: tuple = ()):
    """Nested list of ``fn(position)`` over the positions of ``shape``."""
    if len(prefix) == len(shape):
        return fn(prefix)
    return [_nest(fn, shape, prefix + (k,)) for k in range(shape[len(prefix)])]


def at(nested, position: tuple):
    """The entry of a nested list at ``position``."""
    for k in position:
        nested = nested[k]
    return nested


class Placement:
    """Which mesh axis each tensor axis is split over (None: not split).

    Axes of the mesh that ``spec`` does not name hold replicas.  The
    counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``.
    """

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]]) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)
        for name in self.spec:
            if name is not None and name not in mesh.shape:
                raise ValueError(f"mesh has no axis {name!r}")

    def split(self, x) -> list:
        """A global tensor (or numpy array) as a nested list of shards, each
        on its mesh position's device (a view where the device is the
        tensor's own)."""
        mesh = self.mesh
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        sizes = []
        for axis, name in enumerate(self.spec):
            if name is None:
                continue
            parts = mesh.shape[name]
            if x.shape[axis] % parts:
                raise ValueError(
                    f"axis {axis} of shape {tuple(x.shape)} does not divide into {parts} shards"
                )
            sizes.append((axis, mesh.axis(name), x.shape[axis] // parts))

        def shard(position):
            local = x
            for axis, mesh_axis, size in sizes:
                local = local.narrow(axis, position[mesh_axis] * size, size)
            return local.to(mesh.devices[position], non_blocking=True)

        return _nest(shard, tuple(mesh.devices.shape))

    def join(self, shards) -> torch.Tensor:
        """The global tensor of ``shards``, on the mesh's first device (the
        first replica along every axis that ``spec`` does not name)."""
        mesh = self.mesh
        first = mesh.devices.reshape(-1)[0]
        split_axes = {mesh.axis(name): axis for axis, name in enumerate(self.spec) if name}

        def gather(prefix: tuple):
            mesh_axis = len(prefix)
            if mesh_axis == len(mesh.axis_names):
                return at(shards, prefix).to(first, non_blocking=True)
            if mesh_axis not in split_axes:
                return gather(prefix + (0,))
            parts = [gather(prefix + (k,)) for k in range(mesh.devices.shape[mesh_axis])]
            return torch.cat(parts, dim=split_axes[mesh_axis])

        return gather(())

    def split_line(self, x) -> list:
        """:meth:`split` as a flat line, for a mesh with one axis of size
        above 1 (the one-axis solvers' meshes)."""
        return flatten(self.split(x))

    def join_line(self, line: list) -> torch.Tensor:
        """:meth:`join` of a flat line of shards (see :meth:`split_line`)."""
        it = iter(line)
        return self.join(_nest(lambda _: next(it), tuple(self.mesh.devices.shape)))


def flatten(nested) -> list:
    """The shards of a nested list, in mesh order."""
    if not isinstance(nested, list):
        return [nested]
    return [s for item in nested for s in flatten(item)]


def batch_sharding(mesh: Mesh, num_spatial_axes: int = 2) -> Placement:
    """Placement of a batch of images: batch axis + leading spatial axis."""
    axis_names = mesh.axis_names
    spec = [axis_names[0]]
    if len(axis_names) > 1 and mesh.shape[axis_names[1]] > 1:
        spec.append(axis_names[1])
        spec.extend([None] * (num_spatial_axes - 1))
    else:
        spec.extend([None] * num_spatial_axes)
    return Placement(mesh, spec)
