"""DeepSeek-V2-Lite as a query/passage embedder: multi-head latent attention
(MLA) and DeepSeekMoE blocks, last-token pooling, as plain PyTorch
functions over a parameter dict.

The architecture of deepseek-ai/DeepSeek-V2-Lite (its ``config.json``;
equations in the DeepSeek-V2 paper, arXiv:2405.04434, §2.1 and §2.2):

- MLA without query compression: ``q = h W_Q`` holds per head a 128-d part
  without position and a 64-d part that takes RoPE; ``[c_kv | k_rope] = h
  W_DKV`` gives a 512-d latent (RMS-normed) and one 64-d RoPE key shared by
  every head; ``c_kv W_UKV`` gives each head's 128-d ``k_nope`` and 128-d
  ``v``. Queries and keys are 192 wide, values 128;
- YaRN RoPE (factor 40 over an original 4,096 positions) on interleaved
  pairs, as DeepSeek's checkpoint lays them out; the softmax scale is
  ``m² / sqrt(192)`` with ``m = 0.1 · mscale_all_dim · ln(factor) + 1``;
- layer 0 a dense SwiGLU; every later layer DeepSeekMoE: a softmax router
  over 64 routed experts, the greedy top 6 without renormalisation, and two
  shared experts run as one SwiGLU of twice the expert width;
- the last real token's state, the final RMSNorm and L2 (as the Nemotron
  embedder pools). No output head is built.

Arithmetic: products take bf16 inputs with f32 accumulation and a bf16
result; RMSNorm, the attention logits and softmax are f32; the router is
an f32 product of the bf16 normed state (PyTorch's default, TF32 off) and
an f32 softmax; each token's six weighted expert outputs are summed in f32
in descending gate order, then rounded to bf16.

The expert layer routes real tokens only (padding is key-masked and never
pooled, so leaving it out is exact): it sorts the (token, expert) pairs by
expert, stably, runs each expert projection as one grouped product over
all experts (``torch._grouped_mm``, a private PyTorch API, with the group
ends on the device); one pass (``ops/kernels/moe_combine.py``, on the card
the kernel ``csrc/moe_combine.cu``) then gathers each token's results back
in a fixed order, sums them and adds the shared experts and the residual.
The forward has no Python loop over experts and no copy to the host: the
host never learns a group's size. The number of real tokens comes from the
host's token ids.

Attention is causal with the key mask and materializes its f32 logits; the
embedder slices a batch so that a slice's logits stay within the
encoder's ``_LOGIT_BYTES``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder, EmbeddingConfig
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import (
    _EMBED_ROWS, _LOGIT_BYTES, MASKED, PAD_ID, HashTokenizer, _normal, _rope_heads, count_tokens,
    pad_batch_pow2,
)
from trueno_rag_tpu_torch.models.nemotron import _rms_norm, pool_last_token
from trueno_rag_tpu_torch.ops.kernels.moe_combine import moe_combine, pair_rows, position_slots
from trueno_rag_tpu_torch.utils import profiling

# e5-mistral's MS MARCO instruction (arXiv:2401.00368); passages are plain
DEEPSEEK_V2_QUERY_PREFIX = (
    "Instruct: Given a web search query, retrieve relevant passages that answer the query\nQuery: ")

__all__ = [
    "DEEPSEEK_V2_QUERY_PREFIX", "DeepseekV2Config", "DeepseekV2Embedder", "deepseek_v2_forward", "dense_mlp",
    "embed", "init_deepseek_v2_params", "mla_attention", "mla_qkv", "moe_mlp", "pool_last_token",
    "real_token_index", "softmax_scale", "yarn_inv_freq",
]


@dataclass(frozen=True)
class DeepseekV2Config:
    """Architecture hyperparameters. ``lite()`` is DeepSeek-V2-Lite at its
    published widths; ``tiny()`` keeps every kind of layer at test size.
    ``max_len`` caps the tokenizer (the YaRN original context): the
    materialized attention holds 4·heads·T² bytes of logits a row."""

    vocab_size: int = 102400
    hidden_dim: int = 2048
    num_layers: int = 27
    first_k_dense: int = 1
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mlp_dim: int = 10944  # the dense layers' SwiGLU width
    expert_dim: int = 1408
    n_routed_experts: int = 64
    experts_per_token: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_len: int = 4096
    normalize: bool = True

    def __post_init__(self) -> None:
        if not 0 <= self.first_k_dense <= self.num_layers:
            raise InvalidConfigError("first_k_dense must lie in [0, num_layers]")
        if not 1 <= self.experts_per_token <= self.n_routed_experts:
            raise InvalidConfigError("experts_per_token must lie in [1, n_routed_experts]")
        if self.qk_rope_head_dim % 2 != 0:
            raise InvalidConfigError("qk_rope_head_dim must be even")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def shared_dim(self) -> int:
        return self.n_shared_experts * self.expert_dim

    @classmethod
    def lite(cls) -> "DeepseekV2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "DeepseekV2Config":
        """Test size: one dense layer, three MoE layers of 8 routed experts
        (top 2, two shared), the nope, rope and v widths apart."""
        return cls(vocab_size=512, hidden_dim=64, num_layers=4, num_heads=4, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12, mlp_dim=96, expert_dim=24,
                   n_routed_experts=8, experts_per_token=2, max_len=128)


def init_deepseek_v2_params(config: DeepseekV2Config, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (default: the generator's):
    ``{"tok_emb", "layers": [per-layer dict], "final_norm"}``. Matrices
    (``[in, out]``) and the token table N(0, 0.02²) in bf16, each drawn in
    f32 and cast; norm scales ones in f32; the routed experts stacked
    ``[E, …]``: ``experts_w13`` packs each expert's ``[gate | up]``."""
    device = torch.device(device) if device is not None else generator.device
    c = config
    h, nh, e, m = c.hidden_dim, c.num_heads, c.n_routed_experts, c.expert_dim
    bf16 = torch.bfloat16

    def mat(*shape):
        return _normal(shape, generator, device, bf16)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    layers = []
    for i in range(c.num_layers):
        lp = {
            "attn_norm": ones(h),
            "q_w": mat(h, nh * c.qk_head_dim),
            "kv_a_w": mat(h, c.kv_lora_rank + c.qk_rope_head_dim),
            "kv_a_norm": ones(c.kv_lora_rank),
            "kv_b_w": mat(c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim)),
            "o_w": mat(nh * c.v_head_dim, h),
            "mlp_norm": ones(h),
        }
        if i < c.first_k_dense:
            lp.update(gate_w=mat(h, c.mlp_dim), up_w=mat(h, c.mlp_dim), down_w=mat(c.mlp_dim, h))
        else:
            lp.update(router_w=mat(h, e), experts_w13=mat(e, h, 2 * m), experts_w2=mat(e, m, h),
                      gate_w=mat(h, c.shared_dim), up_w=mat(h, c.shared_dim), down_w=mat(c.shared_dim, h))
        layers.append(lp)
    return {"tok_emb": mat(c.vocab_size, h), "layers": layers, "final_norm": ones(h)}


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------


def _correction_dim(rotations: float, config: DeepseekV2Config) -> float:
    d = config.qk_rope_head_dim
    return d * math.log(config.rope_original_max / (rotations * 2 * math.pi)) / (2 * math.log(config.rope_theta))


def yarn_correction_range(config: DeepseekV2Config):
    """The rotary lanes ``(low, high)`` between which YaRN blends the
    original and the interpolated frequencies: (10, 23) at the published
    widths."""
    low = math.floor(_correction_dim(config.rope_beta_fast, config))
    high = math.ceil(_correction_dim(config.rope_beta_slow, config))
    return max(low, 0), min(high, config.qk_rope_head_dim - 1)


def yarn_inv_freq(config: DeepseekV2Config, device=None) -> torch.Tensor:
    """YaRN's ``[qk_rope_head_dim / 2]`` f32 inverse frequencies: lane i
    blends ``1/θ^(2i/d)`` (weight ``1 − clamp((i − low)/(high − low), 0,
    1)``) with ``1/(factor·θ^(2i/d))``."""
    d = config.qk_rope_head_dim
    pos = config.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    extra, inter = 1.0 / pos, 1.0 / (config.rope_factor * pos)
    low, high = yarn_correction_range(config)
    span = high - low if high != low else 0.001
    keep = 1.0 - torch.clamp((torch.arange(d // 2, dtype=torch.float32, device=device) - low) / span, 0, 1)
    return inter * (1 - keep) + extra * keep


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(config: DeepseekV2Config) -> float:
    """``m² / sqrt(qk_head_dim)`` with YaRN's ``m``: 0.11472 at the
    published widths. (cos and sin are unscaled: mscale / mscale_all_dim
    is 1.)"""
    m = _yarn_mscale(config.rope_factor, config.rope_mscale_all_dim)
    return config.qk_head_dim ** -0.5 * m * m


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def embed(params: Dict[str, Any], token_ids: torch.Tensor) -> torch.Tensor:
    """ids ``[B, T]`` → the bf16 token rows ``[B, T, H]``."""
    return F.embedding(token_ids, params["tok_emb"])


def mla_qkv(x: torch.Tensor, lp: Dict[str, torch.Tensor], config: DeepseekV2Config,
            inv_freq: torch.Tensor):
    """MLA's per-head queries and keys ``[B, heads, T, 192]`` (nope | rope)
    and values ``[B, heads, T, 128]`` from the residual stream ``x [B, T,
    H]``: RMSNorm, ``q = y W_Q``, ``[c_kv | k_rope] = y W_DKV``, ``[k_nope
    | v] = RMS(c_kv) W_UKV``, YaRN RoPE on ``q_rope`` and the shared
    ``k_rope``."""
    c = config
    b, t, _ = x.shape
    nh, dn, dr, dv = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    y = _rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q = (y @ lp["q_w"]).view(b, t, nh, dn + dr).transpose(1, 2)
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    c_kv, k_rope = (y @ lp["kv_a_w"]).split([c.kv_lora_rank, dr], dim=-1)
    kv = (_rms_norm(c_kv, lp["kv_a_norm"], c.rms_norm_eps) @ lp["kv_b_w"]).view(b, t, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_rope = _rope_heads(q_rope, c.rope_theta, True, inv_freq)
    k_rope = _rope_heads(k_rope.view(b, 1, t, dr), c.rope_theta, True, inv_freq)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, nh, t, dr)], dim=-1)
    return q, k, v


def mla_attention(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor], config: DeepseekV2Config,
                  inv_freq: torch.Tensor) -> torch.Tensor:
    """The attention sublayer on the residual stream ``x [B, T, H]``:
    :func:`mla_qkv`, causal attention over the unmasked keys (f32 logits
    times :func:`softmax_scale`, f32 softmax, bf16 probabilities), the
    output product, the residual add."""
    b, t, _ = x.shape
    q, k, v = mla_qkv(x, lp, config, inv_freq)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * softmax_scale(config)
    pos = torch.arange(t, device=x.device)
    keep = (pos[None, :] <= pos[:, None])[None, None] & mask[:, None, None, :]
    probs = torch.softmax(logits.masked_fill_(~keep, MASKED), dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, -1)
    return x + ctx @ lp["o_w"]


def _swiglu(y: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (F.silu(y @ lp["gate_w"]) * (y @ lp["up_w"])) @ lp["down_w"]


def dense_mlp(x: torch.Tensor, lp: Dict[str, torch.Tensor], config: DeepseekV2Config) -> torch.Tensor:
    """The dense feed-forward sublayer: RMSNorm, SwiGLU, the residual add."""
    return x + _swiglu(_rms_norm(x, lp["mlp_norm"], config.rms_norm_eps), lp)


def real_token_index(mask: torch.Tensor, n_real: int) -> torch.Tensor:
    """Flat positions of the ``n_real`` real tokens of ``mask [B, T]``, in
    order, computed on the device (a stable sort puts them first)."""
    return torch.argsort((~mask).reshape(-1).to(torch.uint8), stable=True)[:n_real]


def moe_mlp(x: torch.Tensor, lp: Dict[str, torch.Tensor], config: DeepseekV2Config, real: torch.Tensor,
            expert_counts: Optional[torch.Tensor] = None, routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The DeepSeekMoE sublayer: RMSNorm; the router (f32 product, softmax,
    greedy top-k, descending); the routed experts of the real tokens
    (``real``, :func:`real_token_index`) as two grouped products over
    expert-sorted (token, expert) pairs; the shared experts; then
    :func:`~trueno_rag_tpu_torch.ops.kernels.moe_combine.moe_combine` (on
    the card one kernel): each token's weighted outputs summed in f32 in
    gate order and rounded to bf16, the shared output and the residual
    added. ``expert_counts [E]`` (int64) gains each expert's tokens;
    ``routes`` gains the real tokens' experts ``[n, k]``. While a span
    recorder is on, its counter ``rag.encode.moe_combine`` gains the
    kernel's launches."""
    c = config
    b, t, h = x.shape
    k, m = c.experts_per_token, c.expert_dim
    y = _rms_norm(x, lp["mlp_norm"], c.rms_norm_eps)
    scores = torch.softmax(y.float() @ lp["router_w"].float(), dim=-1)
    weight, expert = torch.topk(scores.view(b * t, -1), k, dim=-1)
    weight = weight.index_select(0, real) * c.routed_scaling_factor
    expert = expert.index_select(0, real)
    if routes is not None:
        routes.append(expert)
    # (token, rank) pairs sorted by expert; a stable sort keeps each
    # expert's tokens in token order
    pair_expert = expert.reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    group_ends = torch.searchsorted(pair_expert.index_select(0, order),
                                    torch.arange(1, c.n_routed_experts + 1, device=x.device)).to(torch.int32)
    if expert_counts is not None:
        expert_counts.add_(torch.diff(group_ends, prepend=group_ends.new_zeros(1)))
    rows = y.view(b * t, h).index_select(0, real.index_select(0, torch.div(order, k, rounding_mode="floor")))
    gate_up = torch._grouped_mm(rows, lp["experts_w13"], offs=group_ends)
    act = F.silu(gate_up[:, :m]) * gate_up[:, m:]
    out = torch._grouped_mm(act, lp["experts_w2"], offs=group_ends)
    shared = _swiglu(y, lp).view(b * t, h)
    launches = moe_combine.launches
    x = moe_combine(out, pair_rows(order), weight, position_slots(real, b * t), x.reshape(b * t, h), shared)
    rec, launches = profiling.active(), moe_combine.launches - launches
    if rec is not None and launches:  # the kernel ran (the CPU takes its plain version)
        rec.count("rag.encode.moe_combine", launches)
    return x.view(b, t, h)


@torch.no_grad()
def deepseek_v2_forward(params: Dict[str, Any], token_ids: torch.Tensor, config: DeepseekV2Config,
                        n_real: Optional[int] = None, expert_counts: Optional[torch.Tensor] = None,
                        routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """ids ``[B, T]`` (0 = padding, real tokens first in each row) → the
    last real token's state, final RMSNorm, optional L2 → ``[B, H]`` f32.
    ``n_real`` is the number of nonzero ids (counted on the device when
    None, which synchronizes); ``expert_counts [MoE layers, E]`` and
    ``routes`` as :func:`moe_mlp` takes them, per MoE layer."""
    mask = token_ids != PAD_ID
    if n_real is None:
        n_real = int(mask.sum())
    real = real_token_index(mask, n_real)
    inv_freq = yarn_inv_freq(config, token_ids.device)
    x = embed(params, token_ids)
    for i, lp in enumerate(params["layers"]):
        with profiling.span("rag.encode.attention"):
            x = mla_attention(x, mask, lp, config, inv_freq)
        if i < config.first_k_dense:
            with profiling.span("rag.encode.mlp"):
                x = dense_mlp(x, lp, config)
        else:
            with profiling.span("rag.encode.moe"):
                counts = None if expert_counts is None else expert_counts[i - config.first_k_dense]
                x = moe_mlp(x, lp, config, real, counts, routes)
    return pool_last_token(x, mask, params["final_norm"], config)


# ---------------------------------------------------------------------------
# Embedder
# ---------------------------------------------------------------------------


class DeepseekV2Embedder(Embedder):
    """Retrieval embedder over DeepSeek-V2-Lite's trunk: instruction-prefixed
    queries (e5-mistral's MS MARCO instruction by default), plain passages,
    last-token pooling. Runs on ``device`` (default: the card; raises
    without one). ``expert_tokens [MoE layers, E]`` and ``routed_tokens``
    are cumulative device counters of the tokens each expert computed and
    of the real tokens routed (once a forward)."""

    def __init__(self, config: Optional[DeepseekV2Config] = None, params: Optional[Dict[str, Any]] = None,
                 embedding_config: Optional[EmbeddingConfig] = None, seed: int = 0, device=None) -> None:
        super().__init__(embedding_config or EmbeddingConfig(query_prefix=DEEPSEEK_V2_QUERY_PREFIX,
                                                             document_prefix=""))
        self.device = resolve_device(device)
        self.model_config = config or DeepseekV2Config.tiny()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_deepseek_v2_params(self.model_config, gen, self.device)
        self.params = params
        self.tokenizer = HashTokenizer(self.model_config.vocab_size, self.model_config.max_len)
        n_moe = self.model_config.num_layers - self.model_config.first_k_dense
        self.expert_tokens = torch.zeros(n_moe, self.model_config.n_routed_experts, dtype=torch.int64,
                                         device=self.device)
        self.routed_tokens = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def dimension(self) -> int:
        return self.model_config.hidden_dim

    @property
    def model_id(self) -> str:
        return "deepseek-ai/DeepSeek-V2-Lite"

    def _forward_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """One forward per slice of texts, each slice as long as its f32
        attention logits stay within ``_LOGIT_BYTES``; rows are independent,
        so slicing changes no row's embedding."""
        cfg = self.model_config
        out, lo = [], 0
        while lo < len(texts):
            with profiling.span("rag.encode.tokenize"):
                ids = self.tokenizer.encode_batch(texts[lo:lo + _EMBED_ROWS])
                rows = min(len(ids), max(1, _LOGIT_BYTES // (4 * cfg.num_heads * ids.shape[1] ** 2)))
                ids = pad_batch_pow2(ids[:rows])
                n_real = int(np.count_nonzero(ids != PAD_ID))
            count_tokens(ids)
            with profiling.span("rag.encode.forward"):
                ids = torch.from_numpy(ids).to(self.device)
                out.append(deepseek_v2_forward(self.params, ids, cfg, n_real, self.expert_tokens)[:rows])
                self.routed_tokens.add_(n_real)
            lo += rows
        return torch.cat(out)

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dimension), dtype=np.float32)
        emb = self._forward_texts(list(texts))
        with profiling.span("rag.encode.wait"):
            return emb.cpu().numpy()

    def embed_queries_device(self, queries: Sequence[str]) -> torch.Tensor:
        """Device-resident query embeddings."""
        return self._forward_texts([self.config.query_prefix + q for q in queries])
