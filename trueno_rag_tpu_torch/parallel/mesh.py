"""Device meshes, sharded values and the mesh's collectives.

PyTorch counterpart of ``trueno_rag_tpu/parallel/mesh.py``. The JAX
package is single-controller: one process owns every device of the mesh
and ``shard_map`` (serving) or GSPMD (training) runs each shard's program.
The port keeps that form: a :class:`Mesh` is a ``(data, model)`` array of
:class:`torch.device`, one process runs each shard's step on its own
device, and merges run on the mesh's first device. A device may appear
more than once, which is how one card (``[cuda:0] * 4``) or the CPU
(``[cpu] * 8``) holds a mesh of several shards.

Axis conventions:

- ``data`` shards corpus rows and example batches: shard ``i`` of ``s``
  holds global rows ``[i·rps, (i+1)·rps)`` (:class:`RowSharded`,
  :func:`shard_rows`, :func:`shard_batch`);
- ``model`` shards encoder weights for training (:func:`encoder_param_specs`,
  :func:`shard_params`, :class:`ShardedParams`): QKV and MLP-in output
  columns, attention-out and MLP-out input rows, vocabulary rows of the
  token table. The serving path replicates over it, so each ``data``
  position runs once, on the first device of its row.

The collectives: :func:`all_gather` (shard order is global row order),
:func:`shard_max` (``lax.pmax``) and :func:`shard_sum` (``lax.psum``, in a
fixed shard order, so every replica of a sum holds the same bits).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.utils.tree import tree_map


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


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The all-gather along ``data``: per-shard tensors moved to the mesh's
    first device and concatenated along ``dim`` in shard order (``[B, w]``
    candidates along dim 1; a batch's per-shard rows along dim 0). Shard
    order is global row order, so a selection that keeps the earlier of two
    equal values keeps the lower row."""
    return torch.cat([p.to(mesh.lead) for p in parts], dim=dim)


def shard_max(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The max of per-shard values (``lax.pmax``), elementwise, on the
    mesh's first device."""
    return torch.stack([p.to(mesh.lead) for p in parts]).amax(dim=0)


def shard_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of per-shard values (``lax.psum``) on ``device``, added in
    shard order, so every replica that copies it holds the same bits; bf16
    and f16 parts are summed in f32 and rounded once. One part is returned
    as it is."""
    if len(parts) == 1:
        return parts[0].to(device)
    low = parts[0].dtype in (torch.bfloat16, torch.float16)
    acc_dtype = torch.float32 if low else parts[0].dtype
    acc = parts[0].to(device, acc_dtype)
    for p in parts[1:]:
        acc = acc + p.to(device, acc_dtype)
    return acc.to(parts[0].dtype)


# ---------------------------------------------------------------------------
# Training layouts: parameter specs, sharded parameters, sharded batches
# ---------------------------------------------------------------------------


class PartitionSpec:
    """Which mesh axis shards each dimension of a parameter (``None``: not
    sharded; no entries: replicated), the port's counterpart of
    ``jax.sharding.PartitionSpec``. The port keeps per-layer dicts where
    the JAX package stacks the layers, so a layer leaf's spec is the JAX
    spec without its leading layer entry."""

    def __init__(self, *axes: Optional[str]) -> None:
        self.axes = tuple(axes)

    @property
    def sharded_dim(self) -> Optional[int]:
        """The dimension split over ``model``, or ``None``."""
        return self.axes.index("model") if "model" in self.axes else None

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.axes == other.axes

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes}"


P = PartitionSpec
_COLUMN_SHARDED = ("qkv_w", "mlp_w1")  # [H, out]: output columns
_BIAS_SHARDED = ("qkv_b", "mlp_b1")  # [out]
_ROW_SHARDED = ("attn_out_w", "mlp_w2", "tok_emb")  # [in, H] input rows; vocabulary rows


def _spec(name: str) -> PartitionSpec:
    if name in _COLUMN_SHARDED:
        return P(None, "model")
    if name in _BIAS_SHARDED:
        return P("model")
    if name in _ROW_SHARDED:
        return P("model", None)
    return P()  # layer norms, pos_emb, biases of row-sharded products, the SPLADE head


def encoder_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Tensor-parallel specs for the encoder parameter tree
    (:func:`~trueno_rag_tpu_torch.models.encoder.init_encoder_params`' or
    ``init_splade_params``' layout), leaf for leaf.

    Megatron-style, as the JAX package's: QKV and MLP-in shard output
    columns, attention-out and MLP-out shard input rows, so each block
    needs one sum over ``model`` after each row-sharded product; the token
    table shards vocabulary rows. Layer norms and biases of row-sharded
    products stay replicated. Within a sharded dimension a shard takes
    whole sections: its columns of each of q, k and v (of gate and up for
    SwiGLU), which :func:`shard_params` lays out."""
    return {
        k: [{n: _spec(n) for n in layer} for layer in v] if k == "layers" else _spec(k)
        for k, v in params.items()
    }


def _sections(tree: Dict[str, Any]) -> Dict[str, Any]:
    """How many packed sections each leaf's sharded dimension holds: q|k|v
    (3) for ``qkv_*``, gate|up (2) for a SwiGLU ``mlp_w1``/``mlp_b1``, else
    1. Read from the shapes, so it holds for a whole tree and a shard."""
    def layer(lp):
        mlp = lp["mlp_w1"].shape[-1] // lp["mlp_w2"].shape[0]
        return {n: 3 if n in ("qkv_w", "qkv_b") else mlp if n in ("mlp_w1", "mlp_b1") else 1 for n in lp}

    return {k: [layer(lp) for lp in v] if k == "layers" else 1 for k, v in tree.items()}


def _names(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: [{n: n for n in lp} for lp in v] if k == "layers" else k for k, v in tree.items()}


def _shard_of(t: torch.Tensor, spec: PartitionSpec, sections: int, name: str, m: int, n_model: int):
    """Model shard ``m`` of ``n_model`` of a whole leaf: block ``m`` of each
    of its ``sections`` along the sharded dimension."""
    dim = spec.sharded_dim
    if dim is None or n_model == 1:
        return t
    size = t.shape[dim]
    if size % (sections * n_model):
        # the JAX package's device_put raises here too (a dimension that
        # does not divide by the axis size)
        raise InvalidConfigError(
            f"{name}: dimension {dim} ({size // sections} per section) does not divide over a "
            f"{n_model}-shard 'model' axis"
        )
    parts = t.chunk(sections, dim=dim)
    return torch.cat([p.chunk(n_model, dim=dim)[m] for p in parts], dim=dim)


def _whole_of(shards: Sequence[torch.Tensor], spec: PartitionSpec, sections: int) -> torch.Tensor:
    """The inverse of :func:`_shard_of` over every model shard of a leaf."""
    dim = spec.sharded_dim
    if dim is None or len(shards) == 1:
        return shards[0]
    per = [s.chunk(sections, dim=dim) for s in shards]
    return torch.cat([torch.cat([p[i] for p in per], dim=dim) for i in range(sections)], dim=dim)


class ShardedParams:
    """A parameter tree placed on a mesh per :func:`encoder_param_specs`
    (the counterpart of the JAX package's ``shard_params`` output):
    ``local[d][m]`` is a tree in the port's layout on ``mesh.devices[d,
    m]`` holding model shard ``m`` of every sharded leaf and a copy of every
    replicated one. The ``data`` rows are replicas of each other."""

    def __init__(self, local: Sequence[Sequence[Dict[str, Any]]], mesh: Mesh, specs: Dict[str, Any]) -> None:
        n_data, n_model = mesh.devices.shape
        if len(local) != n_data or any(len(row) != n_model for row in local):
            raise InvalidConfigError(f"a {n_data}x{n_model} mesh needs {n_data}x{n_model} local trees")
        self.local = [list(row) for row in local]
        self.mesh = mesh
        self.specs = specs

    def replicas(self):
        """``(d, m, tree)`` over the mesh in row-major order."""
        return [(d, m, t) for d, row in enumerate(self.local) for m, t in enumerate(row)]

    def tree_map(self, fn, *rest: "ShardedParams") -> "ShardedParams":
        """``fn`` over every tensor of every replica, with the sharded trees
        ``rest`` of the same layout alongside; the layout kept (how
        :func:`~trueno_rag_tpu_torch.utils.tree.tree_map` maps a sharded
        tree)."""
        return ShardedParams([[tree_map(fn, t, *(r.local[d][m] for r in rest)) for m, t in enumerate(row)]
                              for d, row in enumerate(self.local)], self.mesh, self.specs)

    def __contains__(self, name: str) -> bool:
        return name in self.local[0][0]

    def gather(self) -> Dict[str, Any]:
        """The whole tree on the mesh's first device, from data row 0."""
        row = self.local[0]
        lead = self.mesh.lead

        def whole(spec, sec, *shards):
            return _whole_of([s.to(lead) for s in shards], spec, sec)

        return tree_map(whole, self.specs, _sections(row[0]), *row)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> ShardedParams:
    """Place a parameter tree on the mesh with tensor-parallel layouts
    (:func:`encoder_param_specs`): every device gets its own copy of its
    model shard of each leaf. Raises :class:`InvalidConfigError` where the
    JAX package's ``device_put`` raises: a sharded dimension (the
    vocabulary, the hidden width, the MLP width) that does not divide by
    the ``model`` axis. Heads need not divide: a shard then holds part of a
    head, and the tensor-parallel trunk gathers the heads it meets."""
    if isinstance(params, ShardedParams):
        return params
    specs = encoder_param_specs(params)
    sections = _sections(params)
    n_data, n_model = mesh.devices.shape
    names = _names(params)
    shard = [tree_map(lambda t, spec, sec, name: _shard_of(t, spec, sec, name, m, n_model),
                      params, specs, sections, names) for m in range(n_model)]
    local = [[tree_map(lambda t: t.detach().to(mesh.devices[d, m], copy=True), shard[m])
              for m in range(n_model)] for d in range(n_data)]
    return ShardedParams(local, mesh, specs)


def place_like(tree, params):
    """``tree`` laid out as ``params``: placed on their mesh
    (:func:`shard_params`) when they are sharded, else as it is."""
    return shard_params(tree, params.mesh) if isinstance(params, ShardedParams) else tree


def gather_params(params) -> Dict[str, Any]:
    """A :class:`ShardedParams` as one tree on the mesh's first device (any
    other tree as it is)."""
    return params.gather() if isinstance(params, ShardedParams) else params


def shard_batch(batch, mesh: Mesh):
    """Shard the leading (batch) axis of every array of ``batch`` (an array,
    or a tuple, list or dict of them) over ``data``: each part on the first
    device of its ``data`` row (:class:`RowSharded`). Raises
    :class:`InvalidConfigError` where the rows do not divide, as the JAX
    package's ``device_put`` raises."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh) for x in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return batch if isinstance(batch, RowSharded) else shard_rows(batch, mesh, "data")
