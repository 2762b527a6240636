"""Training checkpoint and resume.

PyTorch counterpart of ``trueno_rag_tpu/train/checkpoint.py``. The JAX
package saves with orbax, which the port does not use: a state is one
safetensors file (``persist.save_params``) in a directory, holding the
parameters and the AdamW moments in the JAX package's flat f32 layout
(``params/<name>``, ``mu/<name>``, ``nu/<name>``; per-layer weights
stacked on a leading ``[L]`` axis) and the step and moment count in its
metadata. Values are saved exactly, so a resumed state takes the next step
as the saved one would have. A sharded state is saved gathered. Orbax
directories written by the JAX package are not read.
"""

from __future__ import annotations

import os
from typing import Optional

from trueno_rag_tpu_torch.convert import _layered, params_to_jax
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import SerializationError
from trueno_rag_tpu_torch.parallel.mesh import place_like
from trueno_rag_tpu_torch.train.contrastive import AdamState, TrainState, _device_of

STATE_FILE = "train_state.safetensors"
_PARTS = ("params", "mu", "nu")


def save_train_state(path: str, state: TrainState) -> None:
    """Save params, optimizer moments and step under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    from trueno_rag_tpu_torch.persist import save_params

    trees = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu}
    flat = {f"{part}/{k}": v for part in _PARTS for k, v in params_to_jax(trees[part]).items()}
    save_params(os.path.join(path, STATE_FILE), flat,
                meta={"step": str(int(state.step)), "count": str(int(state.opt_state.count))})


def load_train_state(path: str, template: Optional[TrainState] = None, device=None) -> TrainState:
    """Restore a :class:`TrainState` on ``device`` (default: the card, or
    ``template``'s device when one is given; a sharded ``template`` places
    the state on its mesh, as ``parallel.shard_params`` does; ``template``
    is otherwise not needed: the file carries the structure)."""
    from trueno_rag_tpu_torch.models.encoder import LAYER_KEYS
    from trueno_rag_tpu_torch.persist import load_params

    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        raise SerializationError(f"no checkpoint at {path}")
    like = template.params if template is not None else None
    if device is None and like is not None:
        device = _device_of(like)
    device = resolve_device(device)
    flat, meta = load_params(file)
    trees = {}
    for part in _PARTS:
        arrays = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith(part + "/")}
        trees[part] = place_like(_layered(arrays, LAYER_KEYS, (), device), like)
    return TrainState(params=trees["params"],
                      opt_state=AdamState(count=int(meta["count"]), mu=trees["mu"], nu=trees["nu"]),
                      step=int(meta["step"]))
