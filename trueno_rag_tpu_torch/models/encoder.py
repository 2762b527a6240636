"""MiniLM/BGE-class transformer encoder as plain PyTorch functions over a
parameter dict.

PyTorch counterpart of ``trueno_rag_tpu/models/encoder.py``: post-LN
blocks, learned or rotary positions, GELU or SwiGLU MLPs, the four
poolings and the hashed word tokenizer, with the JAX package's numbers:

- every product runs in bf16 on bf16 weights and every bias is added in
  bf16; layer norms, softmax and pooling run in f32. The JAX package keeps
  f32 weights and casts each one to bf16 right before its product, so
  storing the matrices once in bf16 (norm scales and biases in f32) gives
  the same values at half the memory;
- the token and position tables stay f32: the JAX package adds the two
  gathered rows in f32 and casts the sum to bf16, which bf16 tables would
  round differently;
- the layer loop is a Python loop over per-layer weights (the JAX
  package's ``lax.scan`` over layer-stacked arrays).

Bidirectional attention here is materialized, as in the JAX package (no
Pallas kernel there): the encoders run at most ``max_len`` tokens.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder, EmbeddingConfig, PoolingStrategy
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.text import tokenize_simple

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
_RESERVED = 3
MASKED = -1e9  # logit of a padding key
_EMBED_ROWS = 4096  # texts tokenized per forward of an embedder
_LOGIT_BYTES = 1 << 31  # f32 attention logits one forward may hold
LAYER_KEYS = (
    "qkv_w", "qkv_b", "attn_out_w", "attn_out_b", "ln1_scale", "ln1_bias",
    "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2", "ln2_scale", "ln2_bias",
)
MATRICES = ("qkv_w", "attn_out_w", "mlp_w1", "mlp_w2")  # stored in bf16


@dataclass(frozen=True)
class EncoderConfig:
    """Architecture hyperparameters. ``minilm_l6`` mirrors
    sentence-transformers/all-MiniLM-L6-v2's shape (384-d, 6 layers,
    12 heads); ``bge_base`` mirrors BAAI/bge-base-en-v1.5 (768-d)."""

    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 256
    pooling: str = PoolingStrategy.MEAN.value
    normalize: bool = True
    compute_dtype: Any = torch.bfloat16
    # "learned" (BERT/MiniLM/BGE absolute table) or "rotary" (RoPE on q/k
    # per head); rope_interleaved: False = split-half pairs, True = even/odd
    position: str = "learned"
    rope_base: float = 10000.0
    rope_interleaved: bool = False
    # "gelu" (exact erf GELU) or "swiglu" (mlp_w1 packs [gate|up])
    mlp: str = "gelu"

    def __post_init__(self) -> None:
        if self.hidden_dim % self.num_heads != 0:
            raise InvalidConfigError("hidden_dim must be divisible by num_heads")
        if self.position not in ("learned", "rotary"):
            raise InvalidConfigError(f"unknown position {self.position!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise InvalidConfigError(f"unknown mlp {self.mlp!r}")
        if (self.hidden_dim // self.num_heads) % 2 != 0 and self.position == "rotary":
            raise InvalidConfigError("rotary needs an even head dim")

    @classmethod
    def minilm_l6(cls) -> "EncoderConfig":
        return cls(hidden_dim=384, num_layers=6, num_heads=12, mlp_dim=1536)

    @classmethod
    def minilm_l12(cls) -> "EncoderConfig":
        return cls(hidden_dim=384, num_layers=12, num_heads=12, mlp_dim=1536)

    @classmethod
    def bge_small(cls) -> "EncoderConfig":
        return cls(hidden_dim=384, num_layers=12, num_heads=12, mlp_dim=1536)

    @classmethod
    def bge_base(cls) -> "EncoderConfig":
        return cls(hidden_dim=768, num_layers=12, num_heads=12, mlp_dim=3072)

    @classmethod
    def nomic(cls) -> "EncoderConfig":
        """nomic-ai/nomic-embed-text-v1's shape: 768-d, 12 layers, rotary
        positions, SwiGLU MLP, max_len capped at 2048."""
        return cls(vocab_size=30528, hidden_dim=768, num_layers=12,
                   num_heads=12, mlp_dim=3072, max_len=2048,
                   position="rotary", mlp="swiglu")

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Test-size config: real architecture, toy capacity."""
        return cls(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_len=64)


def _normal(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02²) drawn in f32 from ``generator``, stored as ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


def init_encoder_params(config: EncoderConfig, generator: torch.Generator,
                        device=None) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (default: the generator's):
    ``{"tok_emb", "pos_emb" (learned only), "emb_ln_scale", "emb_ln_bias",
    "layers": [per-layer dict]}``. Matrices bf16; tables, norms and biases
    f32."""
    device = torch.device(device) if device is not None else generator.device
    h, m = config.hidden_dim, config.mlp_dim
    m1 = 2 * m if config.mlp == "swiglu" else m
    f32, bf16 = torch.float32, torch.bfloat16

    def zeros(n):
        return torch.zeros(n, dtype=f32, device=device)

    def ones(n):
        return torch.ones(n, dtype=f32, device=device)

    params: Dict[str, Any] = {
        "tok_emb": _normal((config.vocab_size, h), generator, device),
        "emb_ln_scale": ones(h),
        "emb_ln_bias": zeros(h),
    }
    if config.position == "learned":
        params["pos_emb"] = _normal((config.max_len, h), generator, device)
    params["layers"] = [
        {
            "qkv_w": _normal((h, 3 * h), generator, device, bf16), "qkv_b": zeros(3 * h),
            "attn_out_w": _normal((h, h), generator, device, bf16), "attn_out_b": zeros(h),
            "ln1_scale": ones(h), "ln1_bias": zeros(h),
            "mlp_w1": _normal((h, m1), generator, device, bf16), "mlp_b1": zeros(m1),
            "mlp_w2": _normal((m, h), generator, device, bf16), "mlp_b2": zeros(h),
            "ln2_scale": ones(h), "ln2_bias": zeros(h),
        }
        for _ in range(config.num_layers)
    ]
    return params


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics (population variance, as ``jnp.var``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + 1e-12)
    return (y * scale + bias).to(x.dtype)


def _rope_heads(x: torch.Tensor, base: float, interleaved: bool) -> torch.Tensor:
    """Rotary position embedding over ``[B, H, T, hd]`` head states, in f32
    (angles ``pos · base**(-i/half)``). ``interleaved=False`` pairs
    (x[i], x[i+half]); ``True`` pairs even/odd lanes."""
    t, hd = x.shape[2], x.shape[3]
    half = hd // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if interleaved:
        x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
        y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return y.reshape(x.shape).to(x.dtype)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` in the compute dtype, as ``jnp.dot(x, w.astype(x.dtype))
    + b.astype(x.dtype)``."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _attention(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor],
               config: EncoderConfig) -> torch.Tensor:
    """Bidirectional multi-head attention with padding-key masking: f32
    logits divided by sqrt(hd), f32 softmax, bf16 probabilities."""
    b, t, h = x.shape
    nh = config.num_heads
    hd = h // nh
    q, k, v = _linear(x, lp["qkv_w"], lp["qkv_b"]).split(h, dim=-1)

    def heads(a):
        return a.reshape(b, t, nh, hd).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    if config.position == "rotary":
        q = _rope_heads(q, config.rope_base, config.rope_interleaved)
        k = _rope_heads(k, config.rope_base, config.rope_interleaved)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / torch.tensor(np.sqrt(hd).astype(np.float32), device=x.device)
    logits = logits.masked_fill_(~mask[:, None, None, :], MASKED)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(b, t, h)
    return _linear(ctx, lp["attn_out_w"], lp["attn_out_b"])


def _block(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor],
           config: EncoderConfig) -> torch.Tensor:
    """Post-LN transformer block: attention, then a GELU (exact erf) or
    SwiGLU MLP."""
    x = _layer_norm(x + _attention(x, mask, lp, config), lp["ln1_scale"], lp["ln1_bias"])
    pre = _linear(x, lp["mlp_w1"], lp["mlp_b1"])
    if config.mlp == "swiglu":
        gate, up = pre.chunk(2, dim=-1)
        hdn = F.silu(gate) * up
    else:
        hdn = F.gelu(pre, approximate="none")
    out = _linear(hdn, lp["mlp_w2"], lp["mlp_b2"])
    return _layer_norm(x + out, lp["ln2_scale"], lp["ln2_bias"])


def _pool(hidden: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """Padding-aware pooling → [B, H] f32."""
    hidden = hidden.float()
    maskf = mask.float()
    if pooling == PoolingStrategy.CLS.value:
        return hidden[:, 0, :]
    if pooling == PoolingStrategy.LAST_TOKEN.value:
        last = torch.clamp(mask.sum(dim=1) - 1, min=0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    if pooling == PoolingStrategy.WEIGHTED_MEAN.value:
        w = (torch.arange(hidden.shape[1], dtype=torch.float32, device=hidden.device)[None, :] + 1.0) * maskf
        return (hidden * w[..., None]).sum(dim=1) / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return (hidden * maskf[..., None]).sum(dim=1) / torch.clamp(maskf.sum(dim=1, keepdim=True), min=1e-9)


def encoder_trunk(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig,
                  position: Optional[str] = None):
    """Shared trunk: ids → final per-token hidden states (compute dtype) and
    the padding mask. Token (+ learned position) rows are summed in f32 and
    cast before the embedding layer norm. ``position`` overrides
    ``config.position`` for the embedding only (the cross-encoder always
    adds its learned table)."""
    mask = token_ids != PAD_ID
    x = params["tok_emb"][token_ids]
    if (position or config.position) == "learned":
        x = x + params["pos_emb"][: token_ids.shape[1]][None, :, :]
    x = _layer_norm(x.to(config.compute_dtype), params["emb_ln_scale"], params["emb_ln_bias"])
    for lp in params["layers"]:
        x = _block(x, mask, lp, config)
    return x, mask


@torch.no_grad()
def encoder_token_states(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig):
    """Per-token final states ``([B, T, H] f32, mask [B, T])``."""
    x, mask = encoder_trunk(params, token_ids, config)
    return x.float(), mask


@torch.no_grad()
def encoder_forward(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """ids ``[B, T]`` → pooled (optionally L2-normalized) ``[B, hidden_dim]``
    f32 embeddings."""
    x, mask = encoder_trunk(params, token_ids, config)
    pooled = _pool(x, mask, config.pooling)
    if config.normalize:
        n = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / torch.where(n == 0.0, torch.ones_like(n), n)
    return pooled


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------


class HashTokenizer:
    """Deterministic word-level tokenizer: ``id = 3 + blake2b(word) %
    (vocab - 3)``, ``[CLS] tokens... [SEP]``; no vocabulary files."""

    def __init__(self, vocab_size: int, max_len: int) -> None:
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._cache: Dict[str, int] = {}

    def _word_id(self, w: str) -> int:
        if len(self._cache) > 262_144:
            # bounded: dropping the cache wholesale costs ~1 µs per word
            self._cache.clear()
        cached = self._cache.get(w)
        if cached is None:
            digest = hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest()
            cached = _RESERVED + int.from_bytes(digest, "little") % (self.vocab_size - _RESERVED)
            self._cache[w] = cached
        return cached

    def encode(self, text: str) -> List[int]:
        ids = [CLS_ID]
        for w in tokenize_simple(text)[: self.max_len - 2]:
            ids.append(self._word_id(w))
        ids.append(SEP_ID)
        return ids

    def encode_batch(self, texts: Sequence[str], pad_multiple: int = 16) -> np.ndarray:
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        t = min(_round_up(longest, pad_multiple), self.max_len)
        out = np.full((len(texts), t), PAD_ID, dtype=np.int32)
        for i, e in enumerate(encoded):
            e = e[:t]
            out[i, : len(e)] = e
        return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


def pad_batch_pow2(ids: np.ndarray) -> np.ndarray:
    """Pad a token batch with all-PAD rows to a power-of-two row count
    (at least 8), the JAX package's batch buckets, so results match its
    batch composition."""
    b = _round_up_pow2(ids.shape[0])
    return ids if b == ids.shape[0] else np.pad(ids, ((0, b - ids.shape[0]), (0, 0)))


def checkpoint_not_ported(*_args, **_kw):
    raise InvalidConfigError(
        "model checkpoints need persist.py, which is not ported yet (ROADMAP Queue 1)"
    )


# ---------------------------------------------------------------------------
# Embedder wrapper
# ---------------------------------------------------------------------------


class EncoderEmbedder(Embedder):
    """``Embedder`` backed by the encoder forward pass — the counterpart of
    the JAX package's ``JaxEncoderEmbedder``. Tokenize (host) → forward →
    pool → normalize on ``device`` (default: the card; raises without one).
    ``embed_queries_device`` returns the device tensor, for the
    retriever's fused path."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        embedding_config: Optional[EmbeddingConfig] = None,
        seed: int = 0,
        model_name: str = "jax-minilm-l6",
        device=None,
    ) -> None:
        super().__init__(embedding_config)
        self.device = resolve_device(device)
        self.encoder_config = config or EncoderConfig.minilm_l6()
        if embedding_config is not None:
            # only NON-DEFAULT EmbeddingConfig fields override the encoder
            # config (pooling, normalize, truncation), as in the JAX package
            defaults = EmbeddingConfig()
            updates = {}
            if embedding_config.pooling != defaults.pooling:
                updates["pooling"] = embedding_config.pooling.value
            if embedding_config.normalize != defaults.normalize:
                updates["normalize"] = embedding_config.normalize
            if embedding_config.max_length != defaults.max_length:
                updates["max_len"] = min(embedding_config.max_length, self.encoder_config.max_len)
            if updates:
                self.encoder_config = dataclasses.replace(self.encoder_config, **updates)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_encoder_params(self.encoder_config, gen, self.device)
        self.params = params
        self.tokenizer = HashTokenizer(self.encoder_config.vocab_size, self.encoder_config.max_len)
        self._model_name = model_name

    @property
    def dimension(self) -> int:
        return self.encoder_config.hidden_dim

    @property
    def model_id(self) -> str:
        return self._model_name

    def _forward_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """One forward per slice of texts, each slice as long as its f32
        attention logits stay within ``_LOGIT_BYTES``. Rows are independent
        (padding keys get exp(-1e9 - max) = 0, pooling masks them), so the
        slicing does not change any row's embedding."""
        cfg = self.encoder_config
        out, lo = [], 0
        while lo < len(texts):
            ids = self.tokenizer.encode_batch(texts[lo:lo + _EMBED_ROWS])
            rows = min(len(ids), max(1, _LOGIT_BYTES // (4 * cfg.num_heads * ids.shape[1] ** 2)))
            ids = torch.from_numpy(pad_batch_pow2(ids[:rows])).to(self.device)
            out.append(encoder_forward(self.params, ids, cfg)[:rows])
            lo += rows
        return torch.cat(out)

    def embed(self, text: str) -> np.ndarray:
        return self._forward_texts([text])[0].cpu().numpy()

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dimension), dtype=np.float32)
        return self._forward_texts(list(texts)).cpu().numpy()

    def embed_queries_device(self, queries: Sequence[str]) -> torch.Tensor:
        """Device-resident query embeddings for the fused retrieval path."""
        return self._forward_texts([self.config.query_prefix + q for q in queries])

    save_checkpoint = checkpoint_not_ported
    load_checkpoint = classmethod(checkpoint_not_ported)
