"""Training: contrastive fine-tuning of the retrieval encoders.

PyTorch counterpart of ``trueno_rag_tpu/train``:
:mod:`~trueno_rag_tpu_torch.train.contrastive` (InfoNCE with in-batch
negatives, the MaxSim and SPLADE objectives, optax's AdamW),
:mod:`~trueno_rag_tpu_torch.train.distill` (cross-encoder → retriever
distillation), :mod:`~trueno_rag_tpu_torch.train.data` (ICT and crop
pairs), :mod:`~trueno_rag_tpu_torch.train.loop` (``fit`` with
retrieval-driven state selection) and
:mod:`~trueno_rag_tpu_torch.train.checkpoint`. On one device, or sharded
data- and tensor-parallel over a mesh (``parallel.shard_params``,
``parallel.shard_batch``; :mod:`trueno_rag_tpu_torch.parallel.train`).
"""

from trueno_rag_tpu_torch.train.contrastive import (
    TrainState,
    contrastive_loss,
    create_train_state,
    train_step,
)
from trueno_rag_tpu_torch.train.loop import (
    EvalSet,
    FitResult,
    build_ict_evalset,
    evaluate_retrieval,
    fit,
)

__all__ = [
    "TrainState",
    "contrastive_loss",
    "create_train_state",
    "train_step",
    "EvalSet",
    "FitResult",
    "build_ict_evalset",
    "evaluate_retrieval",
    "fit",
]
