"""State carried across from the JAX package, given as plain Python and
numpy objects: the retriever's index state (:func:`retriever_from_state`),
a token store's state (:func:`token_store_from_state`,
:func:`late_interaction_from_state`) and the models' parameters (:func:`encoder_params_from_jax`,
:func:`nemotron_params_from_jax`, :func:`cross_encoder_params_from_jax`,
:func:`splade_params_from_jax`; back with
:func:`params_to_jax`, the layout of a checkpoint file) and a training
state (:func:`train_state_from_jax`: f32 params, AdamW moments, count),
and a sharded clustered index's per-shard layout
(:func:`sharded_clustered_from_jax`).

The JAX package's ``HybridRetriever`` exposes everything needed:

- ``registry.chunk_of(row)`` for each row below ``registry.capacity_rows``
  (``None`` for a tombstoned row) — the chunks in row order;
- ``vector_store._host`` and ``vector_store._valid`` — the host matrix
  (cosine rows already normalized) and its valid mask;
- ``sparse_index.state_dict()`` — the BM25 postings and lengths;
- ``registry.tags_host(registry.capacity_rows)`` and
  ``registry.tag_state([])[0]`` — the per-row tag words and the tag
  vocabulary (tag string → bit);
- on the clustered tier, ``vector_store._cluster[0]``, ``[2]`` and ``[3]``
  — the layout's order, centroids and radii, carried as ``cluster=``.

Rows are kept as they are, so both packages answer with the same rows. A
carried clustering is the store's preset: its first clustered build uses
exactly that layout and runs no k-means, so the query path can be compared
bit for bit; any mutation before that build voids it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk, ChunkMetadata, new_chunk_id
from trueno_rag_tpu_torch.embed import Embedder
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.index.vector_store import VectorStoreConfig
from trueno_rag_tpu_torch.retrieve import HybridRetriever, HybridRetrieverConfig


def _port_chunk(c) -> Chunk:
    """A chunk object of either package → the port's :class:`Chunk`: the
    copy ``Chunk.from_dict(c.to_dict())`` makes, without sending the
    embedding through a Python list."""
    return Chunk(
        document_id=c.document_id, content=c.content, start_offset=c.start_offset,
        end_offset=c.end_offset, metadata=ChunkMetadata.from_dict(c.metadata.to_dict()),
        embedding=None if c.embedding is None else np.array(c.embedding, dtype=np.float32),
        id=c.id or new_chunk_id(),
    )


def _tag_words(chunks: Sequence, tag_bits, tag_vocab) -> np.ndarray:
    """The per-row tag words of ``chunks`` (zeros without tags)."""
    if (tag_bits is None) != (tag_vocab is None):
        raise InvalidConfigError("tag_bits and tag_vocab come together")
    if tag_bits is None:
        return np.zeros(len(chunks), np.int64)
    tag_bits = np.asarray(tag_bits).astype(np.int64)
    if tag_bits.shape[0] < len(chunks):
        raise InvalidConfigError("tag_bits must cover every chunk row")
    return tag_bits[: len(chunks)]


def _fill_registry(reg, chunks: Sequence, bits: np.ndarray, tag_vocab) -> None:
    """Put ``chunks`` (``None`` = a free row) into an empty registry at
    their rows, with their tag words and the tag vocabulary."""
    for row, c in enumerate(chunks):
        if c is None:
            reg._row_to_id.append(None)
            reg._chunks.append(None)
            reg._tags.append(0)
            reg._free.append(row)
        else:
            pc = _port_chunk(c)
            reg._row_to_id.append(pc.id)
            reg._chunks.append(pc)
            reg._tags.append(int(bits[row]))
            reg._id_to_row[pc.id] = row
    if tag_vocab is not None:
        reg._tag_bits = {str(t): int(b) for t, b in tag_vocab.items()}
        reg.tags_version += 1


def retriever_from_state(
    embedder: Embedder,
    chunks: Sequence,
    host_matrix: np.ndarray,
    valid: np.ndarray,
    bm25_state: Mapping[str, object],
    config: Optional[HybridRetrieverConfig] = None,
    vector_config: Optional[VectorStoreConfig] = None,
    device=None,
    tag_bits: Optional[np.ndarray] = None,
    tag_vocab: Optional[Mapping[str, int]] = None,
    cluster: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> HybridRetriever:
    """A port :class:`HybridRetriever` holding the given index state.

    ``chunks[row]`` is the chunk at that row or ``None`` for a free row;
    ``host_matrix [capacity, d]`` f32 and ``valid [capacity]`` bool are
    the vector store's host mirror (capacity >= len(chunks));
    ``bm25_state`` is a BM25 ``state_dict()``; ``tag_bits [>= len(chunks)]``
    (int) and ``tag_vocab`` carry the registry's tags, so tag filters
    answer as they did. ``cluster=(order [T·tile] int32, centroids [T, d]
    f32, radii [T] f32)`` is a clustering of exactly this state, built for
    the store's tile (``max(scan_tile_n, 1024)`` rows)."""
    host_matrix = np.asarray(host_matrix, dtype=np.float32)
    valid = np.asarray(valid, dtype=bool)
    if host_matrix.ndim != 2 or valid.shape != (host_matrix.shape[0],):
        raise InvalidConfigError("host_matrix must be [capacity, d] with a [capacity] valid mask")
    if len(chunks) > host_matrix.shape[0]:
        raise InvalidConfigError("more chunk rows than matrix rows")
    bits = _tag_words(chunks, tag_bits, tag_vocab)
    retr = HybridRetriever(embedder, config=config, vector_config=vector_config, device=device)
    if host_matrix.shape[1] != retr.vector_store.config.dimension:
        raise InvalidConfigError(
            f"matrix width {host_matrix.shape[1]} != store dimension "
            f"{retr.vector_store.config.dimension}"
        )
    _fill_registry(retr.registry, chunks, bits, tag_vocab)
    store = retr.vector_store
    store._host = host_matrix.copy()
    store._valid = valid.copy()
    store._count = int(valid.sum())
    store._dirty = True
    store._dirty_rows = None
    if cluster is not None:
        order, centroids, radii = (np.asarray(x) for x in cluster)
        tile = max(store.config.scan_tile_n, 1024)
        if (store.config.scan_tier != "clustered" or order.ndim != 1 or len(order) % tile
                or centroids.shape != (len(order) // tile, host_matrix.shape[1])
                or radii.shape != (len(order) // tile,)):
            raise InvalidConfigError(
                f"cluster= needs scan_tier='clustered' and a layout of {tile}-row tiles "
                f"(order [T*{tile}], centroids [T, d], radii [T])"
            )
        store._cluster_preset = {
            "tile": tile,
            "order": order.astype(np.int32),
            "centroids": centroids.astype(np.float32),
            "radii": radii.astype(np.float32),
        }
    retr.sparse_index.load_state_dict(dict(bm25_state))
    return retr


def _layered(params: Mapping[str, Any], layer_keys, matrices, device) -> Dict[str, Any]:
    """JAX parameters (arrays; per-layer weights stacked on a leading
    ``[L]`` axis) → the port's dict: one entry per layer under ``"layers"``,
    the ``matrices`` in bf16, everything else f32, on ``device``."""
    def put(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)

    out: Dict[str, Any] = {k: put(v) for k, v in params.items() if k not in layer_keys}
    out["layers"] = [
        {k: put(np.asarray(params[k])[i], torch.bfloat16 if k in matrices else torch.float32)
         for k in layer_keys}
        for i in range(np.asarray(params[layer_keys[0]]).shape[0])
    ]
    return out


def params_to_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's parameter dict (per-layer dicts under ``"layers"``; or a
    ``parallel.mesh.ShardedParams``, gathered) → the JAX package's flat
    layout: f32 arrays, per-layer weights stacked on a leading ``[L]`` axis
    (the inverse of ``*_params_from_jax``; a bf16 matrix widens exactly).
    This is the layout of a model checkpoint, so one file serves both
    packages."""
    from trueno_rag_tpu_torch.parallel.mesh import gather_params

    params = gather_params(params)

    def host(t):
        return t.detach().to(torch.float32).cpu().numpy()

    out = {k: host(v) for k, v in params.items() if k != "layers"}
    for k in params["layers"][0]:
        out[k] = np.stack([host(layer[k]) for layer in params["layers"]])
    return out


def encoder_params_from_jax(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """``init_encoder_params``' output of the JAX package (or a loaded
    checkpoint) → :mod:`~trueno_rag_tpu_torch.models.encoder`'s layout. The
    token and position tables stay f32."""
    from trueno_rag_tpu_torch.models.encoder import LAYER_KEYS, MATRICES

    return _layered(params, LAYER_KEYS, MATRICES, device)


def splade_params_from_jax(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """``init_splade_params``' output of the JAX package (the encoder's
    parameters plus the f32 head ``splade_tr_w``/``splade_tr_b``/
    ``splade_ln_scale``/``splade_ln_bias``/``splade_vocab_bias``) →
    :mod:`~trueno_rag_tpu_torch.models.splade`'s layout, every array in
    f32: the trunk casts each matrix to its compute dtype at use, as the
    JAX package does, and :func:`params_to_jax` gives the JAX arrays back
    bit for bit, so ``SpladeEncoder.params_fingerprint`` equals the JAX
    package's. The way back is :func:`params_to_jax`."""
    from trueno_rag_tpu_torch.models.encoder import LAYER_KEYS

    return _layered(params, LAYER_KEYS, (), device)


def train_state_from_jax(state, device, mesh=None):
    """A JAX ``TrainState`` (``train.contrastive.create_train_state``'s,
    optax ``adamw``; sharded or not) → the port's
    :class:`~trueno_rag_tpu_torch.train.contrastive.TrainState` on
    ``device``: the f32 params, the moments ``mu``/``nu`` and the count of
    ``scale_by_adam``'s state, and the step, all as they are (f32 leaves in
    the port's per-layer layout), so one step of either package starts
    from the same numbers. With a ``mesh`` (``parallel.create_mesh``) the
    params and moments are placed on it by ``parallel.shard_params``; the
    way back is :func:`params_to_jax`, which gathers them."""
    from trueno_rag_tpu_torch.models.encoder import LAYER_KEYS
    from trueno_rag_tpu_torch.parallel.mesh import shard_params
    from trueno_rag_tpu_torch.train.contrastive import AdamState, TrainState

    adam = next(s for s in state.opt_state if hasattr(s, "mu"))

    def tree(p):
        out = _layered({k: np.asarray(v) for k, v in p.items()}, LAYER_KEYS, (), device)
        return out if mesh is None else shard_params(out, mesh)

    return TrainState(params=tree(state.params),
                      opt_state=AdamState(count=int(adam.count), mu=tree(adam.mu), nu=tree(adam.nu)),
                      step=int(state.step))


def cross_encoder_params_from_jax(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """The JAX cross-encoder's parameters (the encoder's plus the f32 head
    ``score_w``/``score_b`` and an optional ``pooler_w``/``pooler_b``) →
    :mod:`~trueno_rag_tpu_torch.models.cross_encoder`'s layout."""
    return encoder_params_from_jax(params, device)


def nemotron_params_from_jax(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """``init_nemotron_params``' output of the JAX package (or
    ``load_nemotron_gguf``'s) → :mod:`~trueno_rag_tpu_torch.models.nemotron`'s
    layout; the token table in bf16 (gathering it equals the JAX package's
    cast after the gather)."""
    from trueno_rag_tpu_torch.models.nemotron import LAYER_KEYS, MATRICES

    out = _layered(params, LAYER_KEYS, MATRICES, device)
    out["tok_emb"] = out["tok_emb"].to(torch.bfloat16)
    return out


def _store_config(config):
    """A token store config of either package, or a mapping of its fields
    → the port's :class:`TokenStoreConfig`."""
    from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig

    if config is None or isinstance(config, TokenStoreConfig):
        return config or TokenStoreConfig()
    fields = dict(config) if isinstance(config, Mapping) else dict(vars(config))
    return TokenStoreConfig(**fields)


def token_store_from_state(
    chunks: Sequence,
    tokens: np.ndarray,
    t_mask: np.ndarray,
    valid: np.ndarray,
    config=None,
    device=None,
    tag_bits: Optional[np.ndarray] = None,
    tag_vocab: Optional[Mapping[str, int]] = None,
):
    """A port :class:`~trueno_rag_tpu_torch.index.token_store.TokenVectorStore`
    holding a JAX token store's state: ``chunks[row]`` (``None`` = a free
    row), its host mirror ``tokens [capacity, Lt, H]`` f32 (already
    normalized), ``t_mask [capacity, Lt]`` and ``valid [capacity]``, its
    ``TokenStoreConfig`` (either package's, or a mapping of the fields)
    and the registry's tags (``registry.tags_host(capacity)`` and
    ``registry.tag_state([])[0]``). Rows are kept as they are, so both
    packages answer with the same rows."""
    from trueno_rag_tpu_torch.index.token_store import TokenVectorStore

    cfg = _store_config(config)
    tokens = np.asarray(tokens, dtype=np.float32)
    t_mask = np.asarray(t_mask, dtype=bool)
    valid = np.asarray(valid, dtype=bool)
    cap = tokens.shape[0]
    if (tokens.shape[1:] != (cfg.max_tokens, cfg.hidden_dim) or t_mask.shape != (cap, cfg.max_tokens)
            or valid.shape != (cap,)):
        raise InvalidConfigError(
            f"tokens must be [capacity, {cfg.max_tokens}, {cfg.hidden_dim}] with t_mask [capacity, "
            f"{cfg.max_tokens}] and valid [capacity]"
        )
    if len(chunks) > cap:
        raise InvalidConfigError("more chunk rows than token rows")
    store = TokenVectorStore(cfg, device=device)
    _fill_registry(store.registry, chunks, _tag_words(chunks, tag_bits, tag_vocab), tag_vocab)
    store._host = tokens.copy()
    store._t_mask = t_mask.copy()
    store._valid = valid.copy()
    store._count = int(valid.sum())
    store._dirty = True
    return store


def late_interaction_from_state(
    chunks: Sequence,
    tokens: np.ndarray,
    t_mask: np.ndarray,
    valid: np.ndarray,
    store_config=None,
    encoder_params: Optional[Mapping[str, Any]] = None,
    encoder_config=None,
    max_len: int = 32,
    seed: int = 0,
    device=None,
    tag_bits: Optional[np.ndarray] = None,
    tag_vocab: Optional[Mapping[str, int]] = None,
):
    """A port :class:`~trueno_rag_tpu_torch.models.late_interaction.LateInteractionRetriever`
    over :func:`token_store_from_state`'s store, with the JAX retriever's
    encoder parameters (``retr.params``, carried by
    :func:`encoder_params_from_jax`; seeded weights when ``None``) and
    ``encoder_config`` (the port's :class:`EncoderConfig`)."""
    from trueno_rag_tpu_torch.models.late_interaction import LateInteractionRetriever

    store = token_store_from_state(chunks, tokens, t_mask, valid, store_config, device, tag_bits, tag_vocab)
    params = None if encoder_params is None else encoder_params_from_jax(encoder_params, store.device)
    # a one-row placeholder store, replaced by the carried one
    retr = LateInteractionRetriever(config=encoder_config, params=params, seed=seed, max_len=max_len,
                                    store_config=dataclasses.replace(store.config, initial_capacity=1),
                                    device=store.device)
    retr.store = store
    return retr


def sharded_clustered_from_jax(jax_index, mesh, matrix: Optional[np.ndarray] = None, fetch: str = "auto"):
    """The port's :class:`~trueno_rag_tpu_torch.parallel.clustered.ShardedClusteredIndex`
    over a JAX ``ShardedClusteredIndex``'s per-shard layout: its orders
    (``_orders``), centroids, radii, valid rows and tags, read as numpy, so
    no k-means runs and the two packages' pruned scans see the same tiles.
    ``matrix`` (its rows, in original order) defaults to the JAX index's
    host copy; an index built with ``keep_host=False`` needs it given, and
    the port's index then keeps no host copy either."""
    from trueno_rag_tpu_torch.parallel.clustered import ShardedClusteredIndex

    host = getattr(jax_index, "_host", None)
    keep_host = host is not None
    if matrix is None:
        if host is None:
            raise InvalidConfigError("the JAX index kept no host matrix; pass matrix=")
        matrix = host
    cents = np.asarray(jax_index.centroids, dtype=np.float32)  # [s, T, d]
    radii = np.asarray(jax_index.radii, dtype=np.float32)  # [s, T]
    layouts = [(np.asarray(o, np.int32), cents[i], radii[i]) for i, o in enumerate(jax_index._orders)]
    tags = getattr(jax_index, "_tags_host", None)
    return ShardedClusteredIndex.from_layout(
        np.asarray(matrix, np.float32), mesh, layouts, metric=jax_index.metric,
        valid=np.asarray(jax_index._valid_host, bool), axis=jax_index.axis, rows_normalized=True,
        tile_n=jax_index.tile_n, probe_tiles=jax_index.probe_tiles, fetch=fetch, keep_host=keep_host,
        tags=None if tags is None else np.asarray(tags, np.int32),
    )
