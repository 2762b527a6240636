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
  package's ``lax.scan`` over layer-stacked arrays);
- :func:`encoder_trunk`, :func:`encoder_pooled` and
  :func:`token_states` are differentiable: training (``train/``) runs
  them on f32 master weights, which :func:`_linear` casts to the compute
  dtype at each use as the JAX trunk does; the inference entry points
  wrap them in ``no_grad``. ``EncoderConfig.remat`` recomputes each
  block in the backward pass (``torch.utils.checkpoint``).

Bidirectional attention here is materialized, as in the JAX package (no
Pallas kernel there): the encoders run at most ``max_len`` tokens.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder, EmbeddingConfig, PoolingStrategy
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.text import tokenize_simple
from trueno_rag_tpu_torch.utils import profiling

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
    # recompute each block in the backward pass instead of keeping its
    # activations (the JAX package's jax.checkpoint); no effect without grad
    remat: bool = False

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
                        device=None, matrix_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (default: the generator's):
    ``{"tok_emb", "pos_emb" (learned only), "emb_ln_scale", "emb_ln_bias",
    "layers": [per-layer dict]}``. Matrices in ``matrix_dtype`` (bf16; f32
    for training's master weights, the same draws); tables, norms and
    biases f32."""
    device = torch.device(device) if device is not None else generator.device
    h, m = config.hidden_dim, config.mlp_dim
    m1 = 2 * m if config.mlp == "swiglu" else m
    f32, mat = torch.float32, matrix_dtype

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
            "qkv_w": _normal((h, 3 * h), generator, device, mat), "qkv_b": zeros(3 * h),
            "attn_out_w": _normal((h, h), generator, device, mat), "attn_out_b": zeros(h),
            "ln1_scale": ones(h), "ln1_bias": zeros(h),
            "mlp_w1": _normal((h, m1), generator, device, mat), "mlp_b1": zeros(m1),
            "mlp_w2": _normal((m, h), generator, device, mat), "mlp_b2": zeros(h),
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


def _heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, hd: int,
                     config: EncoderConfig) -> torch.Tensor:
    """Bidirectional attention over the heads of width ``hd`` that ``[B, T,
    n·hd]`` q, k and v hold, with padding-key masking: RoPE on q and k
    (rotary configs), f32 logits divided by sqrt(hd), f32 softmax, bf16
    probabilities → the context ``[B, T, n·hd]``."""
    b, t, w = q.shape
    nh = w // hd

    def heads(a):
        return a.reshape(b, t, nh, hd).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    if config.position == "rotary":
        q = _rope_heads(q, config.rope_base, config.rope_interleaved)
        k = _rope_heads(k, config.rope_base, config.rope_interleaved)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    with profiling.span("rag.encode.forward.wait"):  # the scalar's upload synchronizes the stream
        scale = torch.tensor(np.sqrt(hd).astype(np.float32), device=q.device)
    logits = logits / scale
    logits = logits.masked_fill_(~mask[:, None, None, :], MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(b, t, w)


def _attention(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor],
               config: EncoderConfig) -> torch.Tensor:
    """Multi-head self-attention: the packed q|k|v product, the heads, the
    output product."""
    h = x.shape[-1]
    q, k, v = _linear(x, lp["qkv_w"], lp["qkv_b"]).split(h, dim=-1)
    ctx = _heads_attention(q, k, v, mask, h // config.num_heads, config)
    return _linear(ctx, lp["attn_out_w"], lp["attn_out_b"])


def _mlp_hidden(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """The MLP's hidden activations: exact erf GELU, or SwiGLU over the
    ``[gate|up]`` halves of the input product."""
    pre = _linear(x, w1, b1)
    if config.mlp == "swiglu":
        gate, up = pre.chunk(2, dim=-1)
        return F.silu(gate) * up
    return F.gelu(pre, approximate="none")


def _mlp(x: torch.Tensor, lp: Dict[str, torch.Tensor], config: EncoderConfig) -> torch.Tensor:
    return _linear(_mlp_hidden(x, lp["mlp_w1"], lp["mlp_b1"], config), lp["mlp_w2"], lp["mlp_b2"])


def _block(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor], config: EncoderConfig,
           attention: Optional[Callable] = None, mlp: Optional[Callable] = None) -> torch.Tensor:
    """Post-LN transformer block: attention, then the MLP, each added to the
    residual and layer-normed with ``lp``'s norms. ``attention(x, mask)``
    and ``mlp(x)`` stand in for the one-device sublayers (the
    tensor-parallel trunk of ``parallel/train.py`` passes its sharded
    ones)."""
    a = _attention(x, mask, lp, config) if attention is None else attention(x, mask)
    x = _layer_norm(x + a, lp["ln1_scale"], lp["ln1_bias"])
    out = _mlp(x, lp, config) if mlp is None else mlp(x)
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
                  position: Optional[str] = None, shards=None):
    """Shared trunk: ids → final per-token hidden states (compute dtype) and
    the padding mask. Token (+ learned position) rows are summed in f32 and
    cast before the embedding layer norm. ``position`` overrides
    ``config.position`` for the embedding only (the cross-encoder always
    adds its learned table). ``shards`` (``parallel/train.py``) looks the
    tokens up and runs each block's products over model shards;
    ``params`` then gives the replicated norms and position table."""
    mask = token_ids != PAD_ID
    if shards is None:
        x = F.embedding(token_ids, params["tok_emb"])  # a gather whose backward is deterministic on CUDA
    else:
        x = shards.lookup(token_ids)
    if (position or config.position) == "learned":
        x = x + params["pos_emb"][: token_ids.shape[1]][None, :, :]
    x = _layer_norm(x.to(config.compute_dtype), params["emb_ln_scale"], params["emb_ln_bias"])
    remat = config.remat and torch.is_grad_enabled()
    for i, lp in enumerate(params["layers"]):
        hooks = () if shards is None else shards.sublayers(i)
        if remat:
            x = checkpoint(_block, x, mask, lp, config, *hooks, use_reentrant=False)
        else:
            x = _block(x, mask, lp, config, *hooks)
    return x, mask


def token_states(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig):
    """Per-token final states ``([B, T, H] f32, mask [B, T])``, differentiable."""
    x, mask = encoder_trunk(params, token_ids, config)
    return x.float(), mask


def pool_normalize(x: torch.Tensor, mask: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """Final states ``[B, T, H]`` → pooled (optionally L2-normalized)
    ``[B, H]`` f32 embeddings."""
    pooled = _pool(x, mask, config.pooling)
    if config.normalize:
        n = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / torch.where(n == 0.0, torch.ones_like(n), n)
    return pooled


def encoder_pooled(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """ids ``[B, T]`` → pooled (optionally L2-normalized) ``[B, hidden_dim]``
    f32 embeddings, differentiable."""
    return pool_normalize(*encoder_trunk(params, token_ids, config), config)


@torch.no_grad()
def encoder_token_states(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig):
    """Per-token final states ``([B, T, H] f32, mask [B, T])``."""
    return token_states(params, token_ids, config)


@torch.no_grad()
def encoder_forward(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """ids ``[B, T]`` → pooled (optionally L2-normalized) ``[B, hidden_dim]``
    f32 embeddings."""
    return encoder_pooled(params, token_ids, config)


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


def count_tokens(ids: np.ndarray) -> None:
    """Add the real tokens of the ids fed to the trunk and their rows ×
    length to the span recorder's ``rag.encode.tokens`` and
    ``rag.encode.padded_tokens``, while one is on."""
    rec = profiling.active()
    if rec is not None:
        rec.count("rag.encode.tokens", np.count_nonzero(ids != PAD_ID))
        rec.count("rag.encode.padded_tokens", ids.size)


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
            with profiling.span("rag.encode.tokenize"):
                ids = self.tokenizer.encode_batch(texts[lo:lo + _EMBED_ROWS])
                rows = min(len(ids), max(1, _LOGIT_BYTES // (4 * cfg.num_heads * ids.shape[1] ** 2)))
                ids = pad_batch_pow2(ids[:rows])
            count_tokens(ids)
            with profiling.span("rag.encode.forward"):
                ids = torch.from_numpy(ids).to(self.device)
                out.append(encoder_forward(self.params, ids, cfg)[:rows])
            lo += rows
        return torch.cat(out)

    def embed(self, text: str) -> np.ndarray:
        return self._forward_texts([text])[0].cpu().numpy()

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dimension), dtype=np.float32)
        emb = self._forward_texts(list(texts))
        with profiling.span("rag.encode.wait"):
            return emb.cpu().numpy()

    def embed_queries_device(self, queries: Sequence[str]) -> torch.Tensor:
        """Device-resident query embeddings for the fused retrieval path."""
        return self._forward_texts([self.config.query_prefix + q for q in queries])

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Write the parameters as a safetensors file in the JAX package's
        layout (``convert.params_to_jax``): the JAX package's
        ``JaxEncoderEmbedder.load_checkpoint`` reads it, and so does
        :meth:`load_checkpoint`."""
        from trueno_rag_tpu_torch.convert import params_to_jax
        from trueno_rag_tpu_torch.persist import save_params

        save_params(path, params_to_jax(self.params), meta={"model_name": self._model_name})

    @classmethod
    def load_checkpoint(cls, path: str, config: Optional[EncoderConfig] = None, device=None,
                        **kw) -> "EncoderEmbedder":
        """An embedder over a checkpoint of either package (safetensors, the
        JAX layout) on ``device`` (default: the card)."""
        from trueno_rag_tpu_torch.convert import encoder_params_from_jax
        from trueno_rag_tpu_torch.persist import load_params

        params, meta = load_params(path)
        device = resolve_device(device)
        return cls(config=config, params=encoder_params_from_jax(params, device),
                   model_name=meta.get("model_name", "jax-encoder"), device=device, **kw)
