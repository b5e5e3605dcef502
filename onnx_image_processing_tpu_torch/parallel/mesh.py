"""Batch data parallelism over devices (port of
``onnx_image_processing_tpu/parallel/mesh.py``).

The matchers have no weights to shard and a pair's state fits one card, so
the one parallel axis is the batch: B stacked pairs split into equal
shards, shard i on device i of a 1-D mesh, each shard run through the
pipeline on its own device. Pairs never interact, so no value crosses
between devices.

``Mesh`` is a tuple of ``torch.device``s and an axis name. A mesh may
repeat ``torch.device("cpu")``: the CPU tests run on 8 of them, as the JAX
package's run on a virtual 8-device CPU host. ``device_put_batch`` and
``shard_batch`` give :class:`ShardedTensor` values (one shard per mesh
device); ``ShardedTensor.gather(device)`` concatenates them.

Each CUDA shard runs with its device made current, and every kernel op
launches on the device of its input tensor (``kernels/*.py``), so a shard
on a second card runs on that card's context and stream. As the JAX
package jits the sharded function, ``shard_batch`` calls each device's
replica through ``core.jit``: one CUDA graph per device and per shard
signature, captured with that device current.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..core.jit import Jitted, _leaves, _unflatten, jit


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices in shard order and the name of their axis."""

    devices: tuple[torch.device, ...]
    axis_name: str = "batch"

    def __len__(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class BatchSharding:
    """The placement that splits axis 0 into ``len(mesh)`` equal shards,
    shard i on ``mesh.devices[i]``."""

    mesh: Mesh
    axis_name: str = "batch"


@dataclass(frozen=True)
class ShardedTensor:
    """A batch split over a mesh: ``shards[i]`` lies on ``sharding.mesh.devices[i]``."""

    shards: tuple[torch.Tensor, ...]
    sharding: BatchSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return (sum(s.shape[0] for s in self.shards), *self.shards[0].shape[1:])

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The shards concatenated on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in self.shards])


def _normalized(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: Sequence[str | torch.device] | None = None,
              axis_name: str = "batch") -> Mesh:
    """A 1-D mesh over every CUDA device, or over ``devices`` in that order.
    With no ``devices`` and no CUDA device it raises: it never falls back
    to the CPU (pass ``[torch.device("cpu")] * n`` for a CPU mesh)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh(): no CUDA device; pass the devices "
                               "explicitly for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_normalized(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh(): a mesh needs at least one device")
    return Mesh(devices, axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> BatchSharding:
    """The placement that splits axis 0 (the batch) across the mesh."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return BatchSharding(mesh, axis_name)


def _check_divisible(n: int, mesh: Mesh) -> None:
    if n % len(mesh) != 0:
        raise ValueError(f"batch {n} not divisible by mesh size {len(mesh)}")


def _split(x, sharding: BatchSharding) -> ShardedTensor:
    """``x`` (numpy or tensor) split into equal shards over the mesh; a
    :class:`ShardedTensor` on the same mesh is taken as it is."""
    mesh = sharding.mesh
    if isinstance(x, ShardedTensor):
        if x.sharding.mesh != mesh:
            raise ValueError("a sharded argument lies on another mesh")
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    _check_divisible(t.shape[0], mesh)
    return ShardedTensor(tuple(part.to(dev) for part, dev in
                               zip(t.chunk(len(mesh)), mesh.devices)), sharding)


def device_put_batch(x, mesh: Mesh, axis_name: str = "batch") -> ShardedTensor:
    """Place a numpy array or tensor split over the batch axis: shard i
    (rows i * B / n ... (i + 1) * B / n) on device i."""
    return _split(x, batch_sharding(mesh, axis_name))


def _on(device: torch.device):
    """``device`` made current for the enclosed launches (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _replicas(fn: Callable, devices: tuple[torch.device, ...]) -> dict[torch.device, Jitted]:
    """``jit(fn)`` for each distinct device: a module is copied to each
    device it does not lie on (the copy starts with no graph); a plain
    function is shared, its graphs cached per device."""
    shared = jit(fn)
    out = {}
    for dev in dict.fromkeys(devices):
        if isinstance(shared.module, nn.Module) and getattr(shared.module, "device", None) != dev:
            out[dev] = copy.deepcopy(shared).to(dev)
        else:
            out[dev] = shared
    return out


def shard_batch(fn: Callable, mesh: Mesh, axis_name: str = "batch",
                method: str = "shard_map") -> Callable:
    """``fn`` with every input and output split over the batch axis.

    ``fn`` must treat axis 0 of every argument as the batch; arguments are
    trees of tuples and lists (the streaming split's feature tuples) whose
    leaves are tensors, numpy arrays or :class:`ShardedTensor` values on
    this mesh. Every leaf's batch must be a multiple of the mesh size.
    The outputs have ``fn``'s structure, each leaf a :class:`ShardedTensor`.

    ``method="shard_map"`` (default) runs ``fn`` once per device on that
    device's shard, with the device current: all shards are enqueued
    before any result is read, and no value crosses between devices, so
    the outputs equal the unsharded call's wherever ``fn`` is batch-
    independent. An ``nn.Module`` (or the module of a ``Jitted``) is copied
    once to each mesh device it does not lie on; a plain function must
    accept tensors on every mesh device. Each device's replica is
    ``core.jit`` of it: on the card a CUDA graph per shard signature,
    captured on that device's first call; the returned function's
    ``replicas`` maps each device to its ``Jitted``.

    ``method="jit"`` is kept for functions that reduce across the batch
    (JAX's SPMD composition): ``fn`` runs once on the whole batch gathered
    on the first device and its outputs are split again. That costs a copy
    of every other shard to the first device and back, and one device does
    all the work; its replica is the first device's.
    """
    if method not in ("shard_map", "jit"):
        raise ValueError(f"unknown shard_batch method {method!r} "
                         "(expected 'shard_map' or 'jit')")
    sharding = batch_sharding(mesh, axis_name)
    replicas = _replicas(fn, mesh.devices)

    def wrapped(*args):
        leaves = [_split(x, sharding) for x in _leaves(args)]
        if method == "jit":
            first = mesh.devices[0]
            whole = _unflatten(args, iter([x.gather(first) for x in leaves]))
            with _on(first):
                out = replicas[first](*whole)
            return _unflatten(out, iter([_split(t, sharding) for t in _leaves(out)]))
        outs = []
        for i, dev in enumerate(mesh.devices):
            shard_args = _unflatten(args, iter([x.shards[i] for x in leaves]))
            with _on(dev):
                outs.append(replicas[dev](*shard_args))
        per_device = [_leaves(o) for o in outs]
        merged = [ShardedTensor(tuple(parts), sharding) for parts in zip(*per_device)]
        return _unflatten(outs[0], iter(merged))

    wrapped.replicas = replicas
    return wrapped
