"""Utilities: stage timing and device traces."""

from trueno_rag_tpu_torch.utils.profiling import StageTimer, device_trace

__all__ = ["StageTimer", "device_trace"]
