"""Where the port's tensors live."""

from __future__ import annotations

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`. ``None`` means the current
    CUDA device: the port's entry points run on the card, and the CPU
    (where every kernel runs its plain PyTorch version) must be asked for
    by name. Raises :class:`InvalidConfigError` for ``None`` when no CUDA
    device is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise InvalidConfigError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
