"""Device meshes, row-sharded values and the mesh's two collectives.

PyTorch counterpart of ``trueno_rag_tpu/parallel/mesh.py``. The JAX
package is single-controller: one process owns every device of the mesh
and ``shard_map`` runs each shard's program. The port keeps that form: a
:class:`Mesh` is a ``(data, model)`` array of :class:`torch.device`, one
process runs each shard's step on its own device, and the merge runs on
the mesh's first device. A device may appear more than once, which is
how one card (``[cuda:0] * 4``) or the CPU (``[cpu] * 8``) holds a mesh
of several shards.

Axis conventions:

- ``data`` shards corpus rows: shard ``i`` of ``s`` holds global rows
  ``[i·rps, (i+1)·rps)`` (:class:`RowSharded`);
- ``model`` is kept in the shape for the JAX package's layouts; the
  serving path replicates over it, so each ``data`` position runs once,
  on the first device of its row.

The tensor- and data-parallel training specs (``encoder_param_specs``,
``shard_params``, ``shard_batch``) are not ported yet: they come with the
sharded train steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError


class Mesh:
    """A ``(data, model)`` grid of devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "model")) -> None:
        if devices.ndim != len(axis_names):
            raise InvalidConfigError(f"a {devices.ndim}-d device array needs {devices.ndim} axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The mesh's first device: where merged results live."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """One device per position along ``axis``: the first device of each
        row of the other axes, where that position's shard lives."""
        a = self.axis_names.index(axis)
        rows = np.moveaxis(self.devices, a, 0).reshape(self.devices.shape[a], -1)
        return [rows[i, 0] for i in range(rows.shape[0])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def create_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """Build a ``("data", "model")`` mesh. ``devices=None`` takes every CUDA
    device (raises without one); a list may name a device more than once.
    ``data`` defaults to all devices on the data axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise InvalidConfigError(
                "no CUDA device found; pass devices=[torch.device('cpu')] * n for a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if model < 1 or n == 0:
        raise InvalidConfigError(f"a mesh needs devices and model >= 1, got {n} devices, model={model}")
    if data is None:
        data = n // model
    if data * model != n:
        raise InvalidConfigError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model))


class RowSharded:
    """A row-sharded value: ``shards[i]`` holds global rows
    ``[i·rps, (i+1)·rps)`` on the i-th device along ``axis``."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> None:
        if len(shards) != mesh.shape[axis]:
            raise InvalidConfigError(f"got {len(shards)} shards for a {mesh.shape[axis]}-shard '{axis}' axis")
        self.shards = list(shards)
        self.mesh = mesh
        self.axis = axis

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self):
        return (len(self.shards) * self.rows_per_shard,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards)

    def numpy(self) -> np.ndarray:
        """The global value on the host (bf16 widened to f32)."""
        return np.concatenate([
            (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy() for t in self.shards
        ])


def shard_rows(x, mesh: Mesh, axis: str = "data") -> RowSharded:
    """Place a global array (numpy or tensor, rows divisible by the axis
    size) row-sharded on the mesh, each shard a fresh copy on its device
    (the counterpart of ``jax.device_put(x, NamedSharding(mesh, P(axis)))``)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    s = mesh.shape[axis]
    if t.shape[0] % s:
        raise InvalidConfigError(f"{t.shape[0]} rows do not split over a {s}-shard '{axis}' axis")
    rps = t.shape[0] // s
    return RowSharded(
        [t[i * rps:(i + 1) * rps].to(dev, copy=True)
         for i, dev in enumerate(mesh.axis_devices(axis))],
        mesh, axis,
    )


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The all-gather along ``data``: per-shard ``[B, w]`` tensors moved to
    the mesh's first device and concatenated along dim 1 in shard order.
    Shard order is global row order, so a selection that keeps the earlier
    of two equal values keeps the lower row."""
    return torch.cat([p.to(mesh.lead) for p in parts], dim=1)


def shard_max(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The max of per-shard values (``lax.pmax``), elementwise, on the
    mesh's first device."""
    return torch.stack([p.to(mesh.lead) for p in parts]).amax(dim=0)
