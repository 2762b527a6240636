"""Cross-encoder → retriever distillation.

PyTorch counterpart of ``trueno_rag_tpu/train/distill.py``: a teacher
(the cross-encoder, or anything with ``score_batch``) scores each query's
candidate slate once, and the student (the dense bi-encoder or the
SPLADE-class learned-sparse encoder) learns the teacher's per-slate score
distribution. Objectives:

- ``kl`` — KL(softmax(teacher/τ_t) ‖ softmax(student/τ_s)) per slate;
- ``margin_mse`` — MSE between the teacher's and the student's score
  margins against the slate's first slot (Margin-MSE).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError, QueryError
from trueno_rag_tpu_torch.models.encoder import EncoderConfig, encoder_pooled, token_states
from trueno_rag_tpu_torch.train.contrastive import AdamW, TrainState, _device_of, _ids, _step

OBJECTIVES = ("kl", "margin_mse")


def distill_objective(student: torch.Tensor, teacher, objective: str = "kl", temperature_s: float = 0.05,
                      temperature_t: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The slate-distillation objective over ``student [B, C]`` and
    ``teacher [B, C]`` scores; the teacher is a constant (no gradient)."""
    teacher = torch.as_tensor(teacher, device=student.device).detach()
    if objective == "kl":
        t_logp = torch.log_softmax(teacher / temperature_t, dim=1)
        s_logp = torch.log_softmax(student / temperature_s, dim=1)
        loss = (torch.exp(t_logp) * (t_logp - s_logp)).sum(dim=1).mean()
    elif objective == "margin_mse":
        if student.shape[1] < 2:
            raise InvalidConfigError(
                "margin_mse needs a slate of >= 2 candidates per query "
                f"(got C={student.shape[1]}); the [B, 0] margin array "
                "would mean-reduce to NaN loss/gradients"
            )
        s_m = student[:, :1] - student[:, 1:]  # [B, C-1]
        t_m = (teacher[:, :1] - teacher[:, 1:]) / temperature_t
        loss = ((s_m - t_m) ** 2).mean()
    else:
        raise InvalidConfigError(f"unknown distillation objective: {objective!r}")
    agreement = (student.argmax(dim=1) == teacher.argmax(dim=1)).float().mean()
    return loss, {"loss": loss, "agreement": agreement}


def _slate_ids(query_ids, cand_ids, params):
    dev = _device_of(params)
    q, c = _ids(query_ids, dev), _ids(cand_ids, dev)
    return q, c.reshape(-1, c.shape[2]), c.shape


def dense_distill_loss(params, query_ids, cand_ids, teacher_scores, config: EncoderConfig, objective: str = "kl",
                       temperature_s: float = 0.05, temperature_t: float = 1.0):
    """The student's ``[B, C]`` cosines of each query against its C
    candidates (``cand_ids [B, C, T]``), distilled."""
    q_ids, flat, (b, c, _) = _slate_ids(query_ids, cand_ids, params)
    q = encoder_pooled(params, q_ids, config)  # [B, H]
    d = encoder_pooled(params, flat, config).reshape(b, c, -1)
    s = torch.einsum("bh,bch->bc", q, d)
    return distill_objective(s, teacher_scores, objective, temperature_s, temperature_t)


def splade_distill_loss(params, query_ids, cand_ids, teacher_scores, config: EncoderConfig, objective: str = "kl",
                        temperature_s: float = 1.0, temperature_t: float = 1.0):
    """The learned-sparse student's slate scores: dense activation dots
    (sparsification stays an inference step), distilled."""
    from trueno_rag_tpu_torch.models.splade import splade_head_grad

    q_ids, flat, (b, c, _) = _slate_ids(query_ids, cand_ids, params)
    qs, qm = token_states(params, q_ids, config)
    q_act = splade_head_grad(params, qs, qm)  # [B, V]
    ds, dm = token_states(params, flat, config)
    d_act = splade_head_grad(params, ds, dm).reshape(b, c, -1)
    s = torch.einsum("bv,bcv->bc", q_act, d_act)
    return distill_objective(s, teacher_scores, objective, temperature_s, temperature_t)


def distill_step(state: TrainState, query_ids, cand_ids, teacher_scores, tx: AdamW, config: EncoderConfig,
                 objective: str = "kl", temperature_s: float = 0.05, temperature_t: float = 1.0,
                 student: str = "dense") -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step distilling teacher slate scores into the
    ``dense`` or ``splade`` student."""
    if student not in ("dense", "splade"):
        raise InvalidConfigError(f"unknown distillation student: {student!r}")
    loss = dense_distill_loss if student == "dense" else splade_distill_loss
    return _step(state, tx, loss, query_ids, cand_ids, teacher_scores, config, objective,
                 temperature_s, temperature_t)


def teacher_slate_scores(reranker, queries: Sequence[str], slates: Sequence[Sequence[str]]) -> np.ndarray:
    """Each query's candidate slate scored by a teacher with
    ``score_batch(query, contents)`` → ``[B, C]`` f32 on the host."""
    if len(queries) != len(slates):
        raise QueryError(f"got {len(slates)} slates for {len(queries)} queries")
    widths = {len(s) for s in slates}
    if len(widths) > 1:
        raise QueryError(f"ragged slates: widths {sorted(widths)}")
    out = np.zeros((len(queries), next(iter(widths), 0)), np.float32)
    for i, (q, slate) in enumerate(zip(queries, slates)):
        out[i] = np.asarray(reranker.score_batch(q, list(slate)))
    return out
