"""Eval-driven training loop: contrastive fit with retrieval-quality
checkpoint selection.

PyTorch counterpart of ``trueno_rag_tpu/train/loop.py``: train the encoder
on unsupervised pairs from its own corpus, measure *retrieval* quality
every ``eval_every`` steps (encode the corpus, exact top-k, recall/NDCG/MRR
on held-out pseudo-queries) and keep the state that retrieves best.

The numbers run on the parameters' device: the corpus re-encode is a
batched forward, retrieval is :func:`~trueno_rag_tpu_torch.ops.dense.dense_topk`
(pooled), :func:`~trueno_rag_tpu_torch.ops.maxsim.maxsim_scan_topk`
(MaxSim) or the activation dot (SPLADE), and the metrics are one
:func:`~trueno_rag_tpu_torch.ops.metrics.batched_metrics` call. The JAX
package's mesh and data parallelism are not part of this loop.
"""

from __future__ import annotations

import functools
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk, split_sentences
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import EncoderConfig, encoder_forward, encoder_token_states
from trueno_rag_tpu_torch.ops.dense import dense_topk, require_fp32, topk_desc
from trueno_rag_tpu_torch.ops.metrics import batched_metrics
from trueno_rag_tpu_torch.train.contrastive import (
    TrainState,
    _device_of,
    _l2,
    maxsim_train_step,
    splade_train_step,
    train_step,
    tree_map,
)
from trueno_rag_tpu_torch.train.data import PairBatcher, crop_pairs, ict_pairs


@dataclass
class EvalSet:
    """Held-out retrieval probes: ``queries[i]`` should retrieve corpus row
    ``relevant[i]`` (row indices into the chunk list)."""

    queries: List[str]
    relevant: List[List[int]]


def build_ict_evalset(chunks: Sequence[Chunk], n_queries: int, seed: int = 0) -> EvalSet:
    """One sentence per distinct chunk as a pseudo-query whose relevant set
    is that chunk's row (the JAX package's draws for the same seed)."""
    rng = random.Random(seed)
    rows = [i for i, c in enumerate(chunks) if len(split_sentences(c.content)) >= 2]
    rng.shuffle(rows)
    queries: List[str] = []
    relevant: List[List[int]] = []
    for row in rows[:n_queries]:
        spans = split_sentences(chunks[row].content)
        s, e = spans[rng.randrange(len(spans))]
        q = chunks[row].content[s:e].strip()
        if q:
            queries.append(q)
            relevant.append([row])
    return EvalSet(queries=queries, relevant=relevant)


def _batches(config: EncoderConfig, tokenizer, texts: Sequence[str], batch: int, device):
    """Fixed-shape ``[batch, max_len]`` id slabs of ``texts`` (the JAX
    package's one compiled shape) with each slab's count of real rows."""
    for lo in range(0, len(texts), batch):
        ids = tokenizer.encode_batch(texts[lo:lo + batch])
        n = ids.shape[0]
        ids = np.pad(ids, ((0, batch - n), (0, max(0, config.max_len - ids.shape[1]))))[:, :config.max_len]
        yield torch.from_numpy(ids).to(device), n


def _encode_texts(params, config, tokenizer, texts, batch: int = 64) -> torch.Tensor:
    dev = _device_of(params)
    return torch.cat([encoder_forward(params, ids, config)[:n]
                      for ids, n in _batches(config, tokenizer, texts, batch, dev)])


def _encode_token_states(params, config, tokenizer, texts, batch: int = 64):
    """→ ``([N, T, H] f32 L2-normed, [N, T] mask)``."""
    dev = _device_of(params)
    toks, masks = [], []
    for ids, n in _batches(config, tokenizer, texts, batch, dev):
        t, m = encoder_token_states(params, ids, config)
        toks.append(_l2(t)[:n])
        masks.append(m[:n])
    return torch.cat(toks), torch.cat(masks)


def _maxsim_eval_rows(params, config, tokenizer, chunk_texts, evalset, k, encode_batch):
    from trueno_rag_tpu_torch.ops.maxsim import maxsim_scan_topk

    tok, mask = _encode_token_states(params, config, tokenizer, chunk_texts, encode_batch)
    q_tok, q_mask = _encode_token_states(params, config, tokenizer, evalset.queries, encode_batch)
    valid = torch.ones((tok.shape[0],), dtype=torch.bool, device=tok.device)
    return maxsim_scan_topk(q_tok, q_mask, tok, mask, valid, min(k, tok.shape[0]), 128)[1]


def _splade_eval_rows(params, config, tokenizer, chunk_texts, evalset, k, encode_batch):
    """Top-k rows under the untruncated learned-sparse score (the dense
    activation dot the SPLADE loss trains through)."""
    from trueno_rag_tpu_torch.models.splade import splade_activations

    dev = _device_of(params)

    def acts(texts):
        return torch.cat([splade_activations(params, ids, config)[:n]
                          for ids, n in _batches(config, tokenizer, texts, encode_batch, dev)])

    d_act = acts(chunk_texts)  # [N, V]
    q_act = acts(list(evalset.queries))  # [Q, V]
    require_fp32()
    return topk_desc(q_act @ d_act.T, min(k, d_act.shape[0]))[1]


def evaluate_retrieval(params, config: EncoderConfig, tokenizer, chunk_texts: Sequence[str], evalset: EvalSet,
                       k: int = 10, metric: str = "cosine", encode_batch: int = 64,
                       mode: str = "pooled") -> Dict[str, float]:
    """Encode corpus and probes, exact top-k, the metrics' means.
    ``mode``: ``"pooled"`` (cosine, ``dense_topk``), ``"maxsim"`` (exact
    MaxSim over L2-normed token states) or ``"splade"`` (the untruncated
    activation dot; ``params`` need the SPLADE head)."""
    if not evalset.queries or not chunk_texts:
        raise InvalidConfigError(
            "evaluation needs a non-empty corpus and at least one probe "
            "query (ICT probes require chunks with >= 2 sentences)"
        )
    if mode == "maxsim":
        rows = _maxsim_eval_rows(params, config, tokenizer, chunk_texts, evalset, k, encode_batch)
    elif mode == "splade":
        rows = _splade_eval_rows(params, config, tokenizer, chunk_texts, evalset, k, encode_batch)
    elif mode == "pooled":
        matrix = _encode_texts(params, config, tokenizer, chunk_texts, encode_batch)
        qvecs = _encode_texts(params, config, tokenizer, evalset.queries, encode_batch)
        valid = torch.ones((matrix.shape[0],), dtype=torch.bool, device=matrix.device)
        rows = dense_topk(qvecs, matrix, valid, min(k, matrix.shape[0]), metric)[1]
    else:
        raise InvalidConfigError(f"unknown eval mode {mode!r} (pooled|maxsim|splade)")
    width = max(1, max(len(r) for r in evalset.relevant))
    rel = np.full((len(evalset.relevant), width), -1, np.int32)
    for i, r in enumerate(evalset.relevant):
        rel[i, :len(r)] = r
    per_q = batched_metrics(rows, torch.from_numpy(rel), k_values=(1, min(5, k), k))
    return {name: float(v.float().mean()) for name, v in per_q.items()}


@dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]] = field(default_factory=list)
    best_metric: float = float("-inf")
    best_step: int = -1
    best_checkpoint: Optional[str] = None


def fit(
    state: TrainState,
    tx,
    config: EncoderConfig,
    tokenizer,
    chunks: Sequence[Chunk],
    *,
    steps: int = 200,
    batch_size: int = 32,
    max_len: Optional[int] = None,
    eval_every: int = 50,
    eval_queries: int = 64,
    k: int = 10,
    select_metric: str = "recall@10",
    pair_kind: str = "ict",
    objective: str = "pooled",
    temperature: float = 0.05,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    log: Optional[Callable[[str], None]] = None,
    evalset: Optional[EvalSet] = None,
    eval_corpus: Optional[Sequence[str]] = None,
    objective_kwargs: Optional[Dict[str, float]] = None,
) -> FitResult:
    """Train with periodic retrieval evaluation; keep the best state.

    ``select_metric`` names any key of :func:`evaluate_retrieval`'s output.
    With ``checkpoint_dir`` the best state is saved to
    ``<checkpoint_dir>/best`` as it improves (resumable with
    :func:`~trueno_rag_tpu_torch.train.checkpoint.load_train_state`).
    ``evalset``/``eval_corpus`` give a held-out retrieval task (the
    default self-ICT probes are substrings of their positive chunk, which
    even an untrained encoder can find). ``objective_kwargs`` go to the
    objective's train step. The returned ``state`` is the BEST-evaluating
    state seen, not necessarily the last.
    """
    rng = random.Random(seed)
    if objective not in ("pooled", "maxsim", "splade"):
        raise InvalidConfigError(f"unknown objective {objective!r} (pooled|maxsim|splade)")
    pair_fn = {"ict": ict_pairs, "crop": crop_pairs}.get(pair_kind)
    if pair_fn is None:
        raise InvalidConfigError(f"unknown pair_kind {pair_kind!r} (ict|crop)")
    batcher = PairBatcher(tokenizer, batch_size=batch_size, max_len=max_len or config.max_len)
    stream = batcher.batches(pair_fn(chunks, rng))
    if evalset is None:
        evalset = build_ict_evalset(chunks, eval_queries, seed=seed + 1)
    if not evalset.queries:
        raise InvalidConfigError(
            "no evaluation probes could be built: the corpus has no "
            "chunks with >= 2 sentences (ICT needs a sentence to hold "
            "out); use longer chunks or pair_kind='crop' with a custom "
            "EvalSet via evaluate_retrieval"
        )
    chunk_texts = list(eval_corpus) if eval_corpus is not None else [c.content for c in chunks]
    if objective == "splade" and "splade_vocab_bias" not in state.params:
        raise InvalidConfigError(
            "objective='splade' needs SPLADE-head params — build the "
            "state with create_train_state(..., kind='splade')"
        )
    base_step = {"pooled": train_step, "maxsim": maxsim_train_step, "splade": splade_train_step}[objective]
    step_fn = functools.partial(base_step, tx=tx, config=config, temperature=temperature,
                                **(objective_kwargs or {}))

    result = FitResult(state=state)
    best = None

    def maybe_eval(current: TrainState) -> None:
        nonlocal best
        scores = evaluate_retrieval(current.params, config, tokenizer, chunk_texts, evalset, k=k,
                                    mode=objective if objective in ("maxsim", "splade") else "pooled")
        scores["step"] = float(current.step)
        result.history.append(scores)
        if log:
            shown = {m: round(scores[m], 4) for m in (select_metric, "mrr") if m in scores}
            log(f"eval @ step {current.step}: {shown}")
        value = scores.get(select_metric)
        if value is None:
            raise InvalidConfigError(f"select_metric {select_metric!r} not produced; have {sorted(scores)}")
        if value > result.best_metric:
            result.best_metric = value
            result.best_step = current.step
            best = _clone_state(current)
            if checkpoint_dir is not None:
                from trueno_rag_tpu_torch.train.checkpoint import save_train_state

                path = f"{checkpoint_dir}/best"
                save_train_state(path, current)
                result.best_checkpoint = path

    maybe_eval(state)  # baseline: untrained retrieval quality
    for i in range(steps):
        q_ids, d_ids = next(stream)
        state, metrics = step_fn(state, q_ids, d_ids)
        if (i + 1) % eval_every == 0 or i + 1 == steps:
            if log:
                log(f"step {state.step}: loss={float(metrics['loss']):.4f} "
                    f"acc={float(metrics['accuracy']):.2f}")
            maybe_eval(state)
    result.state = state if best is None else best
    return result


def _clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that later steps do not touch."""
    opt = state.opt_state
    return TrainState(tree_map(torch.clone, state.params),
                      opt._replace(mu=tree_map(torch.clone, opt.mu), nu=tree_map(torch.clone, opt.nu)),
                      state.step)
