"""Data- and tensor-parallel training over a device mesh.

The PyTorch counterpart of what the JAX package gets from GSPMD when its
train steps (``train/contrastive.py``, ``train/distill.py``) run under
``jit`` over a mesh with the batch sharded ``P("data")`` and the
parameters per ``encoder_param_specs``. The losses and steps of
:mod:`trueno_rag_tpu_torch.train` are written once: their encode helpers
call in here for the embeddings when the parameters are a
:class:`~trueno_rag_tpu_torch.parallel.mesh.ShardedParams`, and their
gradients go through :func:`sum_copies`. One process drives every shard:

- **data**: each ``data`` row runs its part of the batch on its devices;
  the per-row embeddings (pooled vectors, token states, SPLADE
  activations) are gathered along ``data`` in ``mesh.all_gather`` order,
  and the loss runs on the mesh's first device over the global batch, so
  in-batch negatives see every document and the loss is the global mean;
- **model** (Megatron, inside the encoder trunk of each row): each shard
  looks up its own vocabulary rows of ``tok_emb`` (masked) and holds its
  columns of q, k and v and of the MLP input; the partial outputs of
  ``attn_out_w`` and ``mlp_w2`` (and of the token lookup) are summed over
  the row's shards (:func:`~trueno_rag_tpu_torch.parallel.mesh.shard_sum`)
  and their biases added once, after the sum. Layer norms, pooling and
  the SPLADE head's transform run on the row's first device. Where the
  heads do not divide over ``model`` a shard gathers the heads its
  columns meet (the JAX package reshards there too). The SPLADE
  projection is tied to the vocabulary-sharded ``tok_emb``, so its
  activations stay vocabulary shards (:func:`splade_activations`), and
  the SPLADE losses sum their activation dots, norms and FLOPS terms over
  ``model`` (one shard on one device);
- **gradients**: autograd runs through the whole mesh; the gradient of a
  leaf is the sum of its copies' gradients, in mesh order, and every copy
  receives that sum (:func:`sum_copies`). Every replica then applies the
  same AdamW update (``train/contrastive.AdamW`` maps a sharded tree
  replica by replica), so the replicas of a leaf stay bit-identical.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    _heads_attention,
    _linear,
    _mlp_hidden,
    encoder_trunk,
    pool_normalize,
)
from trueno_rag_tpu_torch.models.splade import splade_transform, splade_vocab
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded, ShardedParams, all_gather, shard_rows, shard_sum
from trueno_rag_tpu_torch.utils.tree import tree_leaves, tree_map


class _RowShards:
    """The model shards of one ``data`` row (``trees[m]`` on its device):
    the token lookup and each block's sublayers over them, the hooks of
    :func:`~trueno_rag_tpu_torch.models.encoder.encoder_trunk`."""

    def __init__(self, trees: Sequence[Dict[str, Any]], config: EncoderConfig) -> None:
        self.trees = trees
        self.devices = [t["tok_emb"].device for t in trees]
        self.config = config

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Each shard gathers its own vocabulary rows (zero elsewhere); the
        sum over the shards is the whole table's lookup, bit for bit."""
        parts = []
        for m, (t, dev) in enumerate(zip(self.trees, self.devices)):
            n = t["tok_emb"].shape[0]
            local = ids.to(dev) - m * n
            hit = (local >= 0) & (local < n)
            rows = torch.nn.functional.embedding(local.clamp(0, n - 1), t["tok_emb"])
            parts.append(torch.where(hit[..., None], rows, 0.0))
        return shard_sum(parts, self.devices[0])

    def sublayers(self, i: int):
        layers = [t["layers"][i] for t in self.trees]
        return functools.partial(self._attention, layers), functools.partial(self._mlp, layers)

    def _attention(self, layers, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = x.shape[-1]
        hd, w = h // cfg.num_heads, h // len(layers)  # head width; each shard's columns of q, k, v
        qkv = [_linear(x.to(dev), lp["qkv_w"], lp["qkv_b"]).split(w, dim=-1)
               for lp, dev in zip(layers, self.devices)]
        parts = []
        for m, (lp, dev) in enumerate(zip(layers, self.devices)):
            if w % hd == 0:  # whole heads: attention on the shard's own q, k, v
                ctx = _heads_attention(*qkv[m], mask.to(dev), hd, cfg)
            else:  # the heads meeting columns [m·w, (m+1)·w), gathered from every shard
                h0, h1 = m * w // hd, -(-(m + 1) * w // hd)
                q, k, v = (torch.cat([s[j].to(dev) for s in qkv], dim=-1)[..., h0 * hd:h1 * hd] for j in range(3))
                ctx = _heads_attention(q, k, v, mask.to(dev), hd, cfg)[..., m * w - h0 * hd:(m + 1) * w - h0 * hd]
            parts.append(_linear(ctx, lp["attn_out_w"]))
        return shard_sum(parts, x.device) + layers[0]["attn_out_b"].to(x.dtype)

    def _mlp(self, layers, x: torch.Tensor) -> torch.Tensor:
        parts = [_linear(_mlp_hidden(x.to(dev), lp["mlp_w1"], lp["mlp_b1"], self.config), lp["mlp_w2"])
                 for lp, dev in zip(layers, self.devices)]
        return shard_sum(parts, x.device) + layers[0]["mlp_b2"].to(x.dtype)


def row_parts(x, mesh: Mesh) -> List[torch.Tensor]:
    """A batch array as its ``data`` rows' parts: a :class:`RowSharded`'s
    shards, a list of parts as given, or an array or tensor split by
    :func:`~trueno_rag_tpu_torch.parallel.mesh.shard_rows`."""
    if isinstance(x, RowSharded):
        parts = x.shards
    elif isinstance(x, (list, tuple)):
        parts = list(x)
    else:
        parts = shard_rows(x, mesh).shards
    if len(parts) != mesh.shape["data"]:
        raise InvalidConfigError(f"{len(parts)} batch parts for a {mesh.shape['data']}-shard 'data' axis")
    return parts


def _row_trunk(params: ShardedParams, d: int, ids: torch.Tensor, config: EncoderConfig):
    """Row ``d``'s final states ``[b, T, H]`` and mask, on the row's first
    device."""
    row = params.local[d]
    shards = _RowShards(row, config) if len(row) > 1 else None
    return encoder_trunk(row[0], torch.as_tensor(ids).to(row[0]["tok_emb"].device), config, shards=shards)


def pooled(params: ShardedParams, ids, config: EncoderConfig) -> torch.Tensor:
    """The pooled embeddings ``[B, H]`` of the global batch on the mesh's
    first device (``encoder_pooled`` per row, gathered along ``data``)."""
    outs = [pool_normalize(*_row_trunk(params, d, part, config), config)
            for d, part in enumerate(row_parts(ids, params.mesh))]
    return all_gather(outs, params.mesh, dim=0)


def token_states(params: ShardedParams, ids, config: EncoderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token states ``[B, T, H]`` f32 and mask of the global batch on the
    mesh's first device."""
    outs = [_row_trunk(params, d, part, config) for d, part in enumerate(row_parts(ids, params.mesh))]
    return (all_gather([x.float() for x, _ in outs], params.mesh, dim=0),
            all_gather([m for _, m in outs], params.mesh, dim=0))


def splade_activations(params: ShardedParams, ids, config: EncoderConfig) -> List[torch.Tensor]:
    """The SPLADE activations of the global batch as vocabulary shards: for
    each model shard ``m``, ``[B, V/model]`` over its rows of ``tok_emb``,
    gathered along ``data`` on the mesh's first device."""
    rows = []
    for d, part in enumerate(row_parts(ids, params.mesh)):
        trees = params.local[d]
        x, mask = _row_trunk(params, d, part, config)
        hx = splade_transform(trees[0], x.float())
        acts = []
        for m, t in enumerate(trees):
            dev, n = t["tok_emb"].device, t["tok_emb"].shape[0]
            acts.append(splade_vocab(hx.to(dev), mask.to(dev), t["tok_emb"],
                                     t["splade_vocab_bias"][m * n:(m + 1) * n], m * n))
        rows.append(acts)
    return [all_gather([r[m] for r in rows], params.mesh, dim=0) for m in range(len(rows[0]))]


def sum_copies(grads: ShardedParams, live: ShardedParams) -> ShardedParams:
    """Per-copy gradients (``None`` where the loss did not use a copy) of
    the parameters ``live`` → the leaf's gradient on every copy: the sum
    over the copies that hold the same shard (every ``data`` row; for a
    replicated leaf every device), in mesh order; zeros where no copy was
    used."""
    n_data, n_model = live.mesh.devices.shape
    g = {(d, m): tree_leaves(t) for d, m, t in grads.replicas()}
    p = {(d, m): tree_leaves(t) for d, m, t in live.replicas()}
    out = {key: [None] * len(v) for key, v in p.items()}
    everywhere = [[(d, m) for d in range(n_data) for m in range(n_model)]]
    per_shard = [[(d, m) for d in range(n_data)] for m in range(n_model)]
    for j, spec in enumerate(tree_leaves(live.specs)):
        for group in (per_shard if spec.sharded_dim is not None and n_model > 1 else everywhere):
            home = p[group[0]][j]
            parts = [g[key][j] for key in group if g[key][j] is not None]
            total = shard_sum(parts, home.device) if parts else torch.zeros_like(home)
            for key in group:
                out[key][j] = total.to(p[key][j].device)
    its = {key: iter(v) for key, v in out.items()}
    return ShardedParams([[tree_map(lambda _: next(its[d, m]), live.local[d][m]) for m in range(n_model)]
                          for d in range(n_data)], live.mesh, live.specs)
