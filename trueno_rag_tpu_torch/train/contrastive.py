"""InfoNCE contrastive training of the port's retrieval encoders.

PyTorch counterpart of ``trueno_rag_tpu/train/contrastive.py``: encode a
batch of (query, document) pairs, score every pair with one matmul, and
cross-entropy against the diagonal (symmetric InfoNCE with in-batch
negatives); the MaxSim (ColBERT) and SPLADE objectives beside it.

Parameters are f32 master copies in the port's layout (per-layer dicts
under ``"layers"``); the trunk casts each matrix to the compute dtype at
its use (:func:`~trueno_rag_tpu_torch.models.encoder._linear`), as the JAX
trunk does, and the loss and softmax statistics stay f32 (TF32 off).

The optimizer is optax's ``adamw(lr, weight_decay=0.01)`` written out in
optax's operation order (:class:`AdamW`): ``torch.optim.AdamW`` computes
the same update in another order (decay applied to the weights before the
step, ``sqrt(v)/sqrt(1-β₂ᵗ)`` instead of ``sqrt(v/(1-β₂ᵗ))``), which
rounds differently in f32. Like optax, it decays every parameter (norms
and biases too) and counts steps from 0 in its state. The data-parallel
mesh of the JAX package is not part of this module.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import EncoderConfig, encoder_pooled, init_encoder_params, token_states
from trueno_rag_tpu_torch.ops.dense import require_fp32


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of a parameter tree (dicts and lists), with
    the same-shaped trees ``rest`` alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: Any  # first moments, the parameters' tree
    nu: Any  # second moments


class AdamW:
    """optax's ``adamw``: ``scale_by_adam`` (β₁ 0.9, β₂ 0.999, ε 1e-8),
    ``add_decayed_weights(weight_decay)``, ``scale(-learning_rate)``, each
    in optax's f32 operation order."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 2e-5, weight_decay: float = 0.01) -> None:
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(count=0, mu=zeros, nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """→ ``(updates, new_state)``; add the updates with :func:`apply_updates`."""
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        # 1 - β^t in f32 on the host (numpy's f32 power equals XLA's here)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        wd, lr = self.weight_decay, self.learning_rate

        def one(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            return -lr * (u + wd * p)

        return tree_map(one, mu, nu, params), AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


class TrainState(NamedTuple):
    params: Dict[str, Any]
    opt_state: AdamState
    step: int


def create_optimizer(learning_rate: float = 2e-5, weight_decay: float = 0.01) -> AdamW:
    return AdamW(learning_rate, weight_decay=weight_decay)


def create_train_state(
    generator: torch.Generator,
    config: EncoderConfig,
    learning_rate: float = 2e-5,
    kind: str = "encoder",
    device=None,
    params=None,
) -> Tuple[TrainState, AdamW]:
    """A fresh state on ``device`` (default: the card) and its optimizer.
    ``kind="encoder"`` draws the bi-encoder trunk from ``generator``;
    ``kind="splade"`` adds the tied-embedding expansion head (needed by
    :func:`splade_train_step` and ``fit(objective="splade")``). ``params``
    (the port's layout, e.g. an ``EncoderEmbedder``'s) starts from given
    weights instead: f32 copies become the master parameters."""
    device = resolve_device(device)
    if params is not None:
        params = tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32, copy=True), params)
    elif kind == "splade":
        from trueno_rag_tpu_torch.models.splade import init_splade_params

        params = init_splade_params(config, generator, device, matrix_dtype=torch.float32)
    elif kind == "encoder":
        params = init_encoder_params(config, generator, device, matrix_dtype=torch.float32)
    else:
        raise InvalidConfigError(f"unknown train-state kind {kind!r} (encoder|splade)")
    tx = create_optimizer(learning_rate)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device)


def _device_of(params) -> torch.device:
    return params["tok_emb"].device


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy with integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    return F.cross_entropy(logits, labels, reduction="none")


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=1) == labels).float().mean()


def _l2(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0.0, torch.ones_like(n), n)


def contrastive_loss(params, query_ids, doc_ids, config: EncoderConfig,
                     temperature: float = 0.05) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE with in-batch negatives over the pooled, L2-normed
    embeddings."""
    require_fp32()
    dev = _device_of(params)
    q = encoder_pooled(params, _ids(query_ids, dev), config)  # [B, H] f32
    d = encoder_pooled(params, _ids(doc_ids, dev), config)
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=dev)
    loss = 0.5 * (_ce(logits, labels).mean() + _ce(logits.T, labels).mean())
    return loss, {"loss": loss, "accuracy": _accuracy(logits, labels)}


def maxsim_contrastive_loss(params, query_ids, doc_ids, config: EncoderConfig,
                            temperature: float = 0.05) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE with in-batch negatives scored by MaxSim over L2-normed token
    states (the ColBERT recipe), each score divided by the query's token
    count; one direction (query over documents), since MaxSim is
    asymmetric."""
    require_fp32()
    dev = _device_of(params)
    q_tok, q_mask = token_states(params, _ids(query_ids, dev), config)
    d_tok, d_mask = token_states(params, _ids(doc_ids, dev), config)
    q_tok, d_tok = _l2(q_tok), _l2(d_tok)
    sim = torch.einsum("bqh,cth->bqct", q_tok, d_tok)  # [B, Tq, B, Td]
    sim = torch.where(d_mask[None, None, :, :], sim, float("-inf"))
    best = sim.amax(dim=3)  # [B, Tq, B]
    best = torch.where(q_mask[:, :, None] & torch.isfinite(best), best, 0.0)
    n_q = torch.clamp(q_mask.sum(dim=1, keepdim=True), min=1)
    logits = best.sum(dim=1) / n_q / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=dev)
    loss = _ce(logits, labels).mean()
    return loss, {"loss": loss, "accuracy": _accuracy(logits, labels)}


def splade_contrastive_loss(params, query_ids, doc_ids, config: EncoderConfig, temperature: float = 1.0,
                            lambda_q: float = 5e-4, lambda_d: float = 1e-4,
                            score_norm: str = "none") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE over the dense ``[B, B]`` activation dots plus the FLOPS
    regularizer ``Σ_v (mean_b w(x)_bv)²`` on each side (the SPLADE recipe;
    sparsification stays an inference step). ``score_norm="cosine"``
    L2-normalizes the activations inside the logits."""
    from trueno_rag_tpu_torch.models.splade import splade_head_grad

    if score_norm not in ("none", "cosine"):
        raise InvalidConfigError(f"unknown score_norm {score_norm!r} (none|cosine)")
    dev = _device_of(params)
    qs, qm = token_states(params, _ids(query_ids, dev), config)
    ds, dm = token_states(params, _ids(doc_ids, dev), config)
    q_act = splade_head_grad(params, qs, qm)  # [B, V] >= 0
    d_act = splade_head_grad(params, ds, dm)
    q_s, d_s = (_l2(q_act), _l2(d_act)) if score_norm == "cosine" else (q_act, d_act)
    logits = (q_s @ d_s.T) / temperature
    labels = torch.arange(logits.shape[0], device=dev)
    ce = _ce(logits, labels).mean()
    flops_q = (q_act.mean(dim=0) ** 2).sum()
    flops_d = (d_act.mean(dim=0) ** 2).sum()
    loss = ce + lambda_q * flops_q + lambda_d * flops_d
    return loss, {
        "loss": loss, "ce": ce, "accuracy": _accuracy(logits, labels),
        "flops_q": flops_q, "flops_d": flops_d,
        "nnz_q": (q_act > 0.0).sum(dim=1).float().mean(),
        "nnz_d": (d_act > 0.0).sum(dim=1).float().mean(),
    }


def loss_and_grads(loss_fn: Callable, params, *args, **kw):
    """``loss_fn(params, *args, **kw) → (loss, metrics)`` and the gradients
    of the loss with respect to every parameter → ``(loss, metrics, grads)``
    (``grads`` in the parameters' tree; zeros where the loss does not
    depend on a parameter). Metrics are detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, *args, **kw)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    grad_tree = tree_map(lambda _: next(it), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad_tree


def _step(state: TrainState, tx: AdamW, loss_fn: Callable, *args, **kw):
    _, metrics, grads = loss_and_grads(loss_fn, state.params, *args, **kw)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(apply_updates(state.params, updates), opt_state, state.step + 1), metrics


def train_step(state: TrainState, query_ids, doc_ids, tx: AdamW, config: EncoderConfig,
               temperature: float = 0.05) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on the pooled InfoNCE objective."""
    return _step(state, tx, contrastive_loss, query_ids, doc_ids, config, temperature)


def maxsim_train_step(state: TrainState, query_ids, doc_ids, tx: AdamW, config: EncoderConfig,
                      temperature: float = 0.05) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on the MaxSim objective."""
    return _step(state, tx, maxsim_contrastive_loss, query_ids, doc_ids, config, temperature)


def splade_train_step(state: TrainState, query_ids, doc_ids, tx: AdamW, config: EncoderConfig,
                      temperature: float = 1.0, lambda_q: float = 5e-4, lambda_d: float = 1e-4,
                      score_norm: str = "none") -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on the SPLADE objective (``state.params`` must
    hold the head: ``create_train_state(kind="splade")``)."""
    return _step(state, tx, splade_contrastive_loss, query_ids, doc_ids, config, temperature,
                 lambda_q, lambda_d, score_norm)
