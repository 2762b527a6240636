"""Nemotron-class asymmetric embedding model (NV-Embed-style) as plain
PyTorch functions over a parameter dict.

PyTorch counterpart of ``trueno_rag_tpu/models/nemotron.py``: a decoder
architecture (pre-RMSNorm blocks, split-half RoPE, causal attention,
SwiGLU MLPs) with last-token pooling, a final RMSNorm and L2
normalization; 4096-d output and an 8192-token context at full width.
Instruction-prefixed queries, plain passages.

Numbers follow the JAX package: products in bf16 on bf16 weights (the JAX
package keeps f32 weights and casts each to bf16 right before its product,
and casts the embedding after its gather — the same values, so the port
stores the matrices and the token table once in bf16: 15.8 GB at full
width instead of 31.7 GB of f32), RMSNorm and softmax in f32.

Attention: ``attention_impl="naive"`` materializes ``[B, H, T, T]`` f32
logits (divided by sqrt(hd)); ``"block"`` runs the CUDA kernel
``block_attention`` (K4, ``ops/kernels/attention.py``; its plain version on
CPU tensors), which multiplies by 1/sqrt(hd) as the Pallas kernel does;
``"auto"`` takes the block path at T >= 512. Unlike the JAX package's
block path, which asserts T % 128 == 0, the port answers at every T.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder, EmbeddingConfig
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import (
    MASKED, PAD_ID, HashTokenizer, _normal, _rope_heads, pad_batch_pow2,
)
from trueno_rag_tpu_torch.ops.kernels.attention import block_attention

NEMOTRON_QUERY_PREFIX = "Instruct: Given a query, retrieve relevant documents\nQuery: "
BLOCK_FROM_T = 512  # "auto" takes the block kernel from this many tokens
LAYER_KEYS = ("qkv_w", "attn_out_w", "rms1_scale", "mlp_gate_w", "mlp_up_w", "mlp_down_w", "rms2_scale")
MATRICES = ("qkv_w", "attn_out_w", "mlp_gate_w", "mlp_up_w", "mlp_down_w")  # stored in bf16


@dataclass(frozen=True)
class NemotronConfig:
    """Decoder architecture hyperparameters. ``full()`` is the 4096-d
    NV-Embed-class shape; ``tiny()`` is the test shape."""

    vocab_size: int = 32000
    hidden_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    mlp_dim: int = 14336
    max_len: int = 8192
    rope_theta: float = 10000.0
    normalize: bool = True
    compute_dtype: Any = torch.bfloat16
    attention_impl: str = "auto"  # "naive", "block" or "auto" (block at T >= 512)

    def __post_init__(self) -> None:
        if self.hidden_dim % self.num_heads != 0:
            raise InvalidConfigError("hidden_dim must be divisible by num_heads")
        if self.attention_impl not in ("auto", "naive", "block"):
            raise InvalidConfigError(f"unknown attention_impl {self.attention_impl!r}")

    @classmethod
    def full(cls) -> "NemotronConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "NemotronConfig":
        return cls(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_len=128)


def init_nemotron_params(config: NemotronConfig, generator: torch.Generator,
                         device=None) -> Dict[str, Any]:
    """Seeded random parameters on ``device`` (default: the generator's):
    ``{"tok_emb", "layers": [per-layer dict], "final_rms_scale"}``, matrices
    and the token table in bf16, norm scales in f32. Each matrix is drawn in
    f32 and cast, one at a time."""
    device = torch.device(device) if device is not None else generator.device
    h, m = config.hidden_dim, config.mlp_dim
    bf16 = torch.bfloat16

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    return {
        "tok_emb": _normal((config.vocab_size, h), generator, device, bf16),
        "layers": [
            {
                "qkv_w": _normal((h, 3 * h), generator, device, bf16),
                "attn_out_w": _normal((h, h), generator, device, bf16),
                "rms1_scale": ones(h),
                "mlp_gate_w": _normal((h, m), generator, device, bf16),
                "mlp_up_w": _normal((h, m), generator, device, bf16),
                "mlp_down_w": _normal((m, h), generator, device, bf16),
                "rms2_scale": ones(h),
            }
            for _ in range(config.num_layers)
        ],
        "final_rms_scale": ones(h),
    }


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32: ``(x · rsqrt(mean(x²) + eps)) · scale``."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * scale).to(x.dtype)


def _decoder_block(x: torch.Tensor, mask: torch.Tensor, lp: Dict[str, torch.Tensor],
                   config: NemotronConfig) -> torch.Tensor:
    b, t, h = x.shape
    nh = config.num_heads
    hd = h // nh
    y = _rms_norm(x, lp["rms1_scale"])
    q, k, v = (y @ lp["qkv_w"]).split(h, dim=-1)

    def heads(a):
        return a.reshape(b, t, nh, hd).permute(0, 2, 1, 3)

    # split-half RoPE, as the encoder's non-interleaved pairing
    q = _rope_heads(heads(q), config.rope_theta, interleaved=False)
    k = _rope_heads(heads(k), config.rope_theta, interleaved=False)
    v = heads(v)
    impl = config.attention_impl
    if impl == "auto":
        impl = "block" if t >= BLOCK_FROM_T else "naive"
    if impl == "block":
        ctx = block_attention(q.reshape(b * nh, t, hd), k.reshape(b * nh, t, hd),
                              v.reshape(b * nh, t, hd), mask, causal=True, heads=nh)
        ctx = ctx.reshape(b, nh, t, hd)
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.tensor(np.sqrt(hd).astype(np.float32), device=x.device)
        pos = torch.arange(t, device=x.device)
        keep = (pos[None, :] <= pos[:, None])[None, None] & mask[:, None, None, :]
        logits = logits.masked_fill_(~keep, MASKED)
        probs = torch.softmax(logits, dim=-1).to(y.dtype)
        del logits
        ctx = torch.matmul(probs, v)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, h)
    x = x + ctx @ lp["attn_out_w"]
    y = _rms_norm(x, lp["rms2_scale"])
    gate = F.silu(y @ lp["mlp_gate_w"])
    return x + (gate * (y @ lp["mlp_up_w"])) @ lp["mlp_down_w"]


@torch.no_grad()
def nemotron_forward(params: Dict[str, Any], token_ids: torch.Tensor, config: NemotronConfig) -> torch.Tensor:
    """ids ``[B, T]`` → the last valid token's hidden state, RMSNorm, optional
    L2 → ``[B, H]`` f32."""
    mask = token_ids != PAD_ID
    x = params["tok_emb"][token_ids].to(config.compute_dtype)
    for lp in params["layers"]:
        x = _decoder_block(x, mask, lp, config)
    return pool_last_token(x, mask, params["final_rms_scale"], config)


def pool_last_token(x: torch.Tensor, mask: torch.Tensor, final_rms_scale: torch.Tensor,
                    config: NemotronConfig) -> torch.Tensor:
    """Final hidden states ``[B, T, H]`` → the last valid token's state,
    RMSNorm, optional L2 → ``[B, H]`` f32."""
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)
    pooled = x[torch.arange(x.shape[0], device=x.device), last]
    pooled = _rms_norm(pooled, final_rms_scale).float()
    if config.normalize:
        n = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / torch.where(n == 0.0, torch.ones_like(n), n)
    return pooled


class NemotronEmbedder(Embedder):
    """Asymmetric retrieval embedder: instruction-prefixed queries, plain
    passages, batches of ``batch_size`` texts, each padded to its
    power-of-two bucket. Runs on ``device`` (default: the card; raises
    without one). ``model_id`` is "nvidia/NV-Embed-v2"."""

    def __init__(
        self,
        config: Optional[NemotronConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        embedding_config: Optional[EmbeddingConfig] = None,
        batch_size: int = 8,
        seed: int = 0,
        device=None,
    ) -> None:
        super().__init__(
            embedding_config
            or EmbeddingConfig(query_prefix=NEMOTRON_QUERY_PREFIX, document_prefix="", max_length=8192)
        )
        self.device = resolve_device(device)
        self.nemotron_config = config or NemotronConfig.tiny()
        self.batch_size = batch_size
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_nemotron_params(self.nemotron_config, gen, self.device)
        self.params = params
        self.tokenizer = HashTokenizer(self.nemotron_config.vocab_size, self.nemotron_config.max_len)

    @property
    def dimension(self) -> int:
        return self.nemotron_config.hidden_dim

    @property
    def model_id(self) -> str:
        return "nvidia/NV-Embed-v2"

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dimension), dtype=np.float32)
        out = []
        for i in range(0, len(texts), self.batch_size):
            block = list(texts[i: i + self.batch_size])
            ids = torch.from_numpy(pad_batch_pow2(self.tokenizer.encode_batch(block))).to(self.device)
            out.append(nemotron_forward(self.params, ids, self.nemotron_config)[: len(block)].cpu().numpy())
        return np.concatenate(out, axis=0)

    def save_checkpoint(self, path: str) -> None:
        """Write the parameters as a safetensors file in the JAX package's
        layout (f32, ``convert.params_to_jax``), read by either package's
        ``load_checkpoint``."""
        from trueno_rag_tpu_torch.convert import params_to_jax
        from trueno_rag_tpu_torch.persist import save_params

        save_params(path, params_to_jax(self.params), meta={"model_name": self.model_id})

    @classmethod
    def load_checkpoint(cls, path: str, config: Optional[NemotronConfig] = None, device=None,
                        **kw) -> "NemotronEmbedder":
        """An embedder over a checkpoint of either package on ``device``
        (default: the card)."""
        from trueno_rag_tpu_torch.convert import nemotron_params_from_jax
        from trueno_rag_tpu_torch.persist import load_params

        params, _ = load_params(path)
        device = resolve_device(device)
        return cls(config=config, params=nemotron_params_from_jax(params, device), device=device, **kw)

    @classmethod
    def from_gguf(cls, path: str, config: Optional[NemotronConfig] = None, device=None,
                  **kw) -> "NemotronEmbedder":
        """Load a llama-architecture GGUF model file (``models/gguf.py``:
        F32/F16/Q8_0/Q4_0/Q4_1 and the k-quants, dequantized on the host,
        stored as the port's bf16/f32 parameters on ``device``)."""
        from trueno_rag_tpu_torch.models.gguf import load_nemotron_gguf

        device = resolve_device(device)
        params, cfg = load_nemotron_gguf(path, config, device=device)
        return cls(config=cfg, params=params, device=device, **kw)
