"""Neural models — PyTorch forward passes for query/document embedding and
reranking, the counterparts of the JAX package's ``models``:

- :mod:`~trueno_rag_tpu_torch.models.encoder` — MiniLM/BGE-class
  bidirectional encoder (384/768-d), four poolings, bf16 products;
- :mod:`~trueno_rag_tpu_torch.models.nemotron` — the Nemotron-class
  decoder-style embedder (4096-d, 8192 tokens), whose long-context
  attention is the CUDA kernel ``block_attention``;
- :mod:`~trueno_rag_tpu_torch.models.deepseek_v2` — DeepSeek-V2-Lite's
  trunk as an embedder: latent attention (MLA) with YaRN RoPE and
  DeepSeekMoE (routed experts as grouped products, shared experts),
  last-token pooling;
- :mod:`~trueno_rag_tpu_torch.models.cross_encoder` — the neural
  cross-encoder reranker;
- :mod:`~trueno_rag_tpu_torch.models.late_interaction` — ColBERT-style
  MaxSim: the late-interaction reranker and the corpus-scale retriever
  over the token store (its tiered scan is the CUDA kernels K6/K7);
- :mod:`~trueno_rag_tpu_torch.models.splade` — the SPLADE-class
  learned-sparse expansion encoder and its retriever;
- :mod:`~trueno_rag_tpu_torch.models.gguf` — GGUF model files;
- :mod:`~trueno_rag_tpu_torch.models.gguf_device` — k-quant blocks kept
  on the card and dequantized layer by layer inside the Nemotron forward;
- :mod:`~trueno_rag_tpu_torch.models.hf_import` — local Hugging Face
  BERT/RoFormer/nomic-bert checkpoints and BERT cross-encoders;
- :mod:`~trueno_rag_tpu_torch.models.tokenization` — WordPiece.

Weights: no network here, so constructors draw seeded random weights
from a ``torch.Generator`` on the model's device, or take a parameter
dict (``convert.py`` carries the JAX package's across; ``from_gguf``
reads a model file; ``hf_import`` reads a checkpoint directory).
"""

from trueno_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    EncoderEmbedder,
    HashTokenizer,
    encoder_forward,
    encoder_token_states,
    init_encoder_params,
)
from trueno_rag_tpu_torch.models.nemotron import (
    NEMOTRON_QUERY_PREFIX,
    NemotronConfig,
    NemotronEmbedder,
    init_nemotron_params,
    nemotron_forward,
)
from trueno_rag_tpu_torch.models.deepseek_v2 import (
    DEEPSEEK_V2_QUERY_PREFIX,
    DeepseekV2Config,
    DeepseekV2Embedder,
    deepseek_v2_forward,
    dense_mlp,
    init_deepseek_v2_params,
    mla_attention,
    moe_mlp,
    yarn_inv_freq,
)
from trueno_rag_tpu_torch.models.cross_encoder import (
    CrossEncoderReranker,
    cross_encoder_scores,
    init_cross_encoder_params,
)
from trueno_rag_tpu_torch.models.late_interaction import (
    LateInteractionReranker,
    LateInteractionRetriever,
    late_interaction_scores,
    maxsim,
    maxsim_oracle,
)
from trueno_rag_tpu_torch.models.splade import (
    SpladeEncoder,
    SpladeRetriever,
    init_splade_params,
    splade_activations,
)
from trueno_rag_tpu_torch.models.gguf import load_nemotron_gguf, read_gguf, write_gguf
from trueno_rag_tpu_torch.models.hf_import import (
    load_hf_bert_encoder,
    load_hf_cross_encoder,
    load_hf_rotary_encoder,
)
from trueno_rag_tpu_torch.models.tokenization import WordPieceTokenizer

__all__ = [
    "EncoderConfig",
    "EncoderEmbedder",
    "HashTokenizer",
    "encoder_forward",
    "encoder_token_states",
    "init_encoder_params",
    "NEMOTRON_QUERY_PREFIX",
    "NemotronConfig",
    "NemotronEmbedder",
    "init_nemotron_params",
    "nemotron_forward",
    "DEEPSEEK_V2_QUERY_PREFIX",
    "DeepseekV2Config",
    "DeepseekV2Embedder",
    "deepseek_v2_forward",
    "dense_mlp",
    "init_deepseek_v2_params",
    "mla_attention",
    "moe_mlp",
    "yarn_inv_freq",
    "CrossEncoderReranker",
    "cross_encoder_scores",
    "init_cross_encoder_params",
    "LateInteractionReranker",
    "LateInteractionRetriever",
    "late_interaction_scores",
    "maxsim",
    "maxsim_oracle",
    "SpladeEncoder",
    "SpladeRetriever",
    "init_splade_params",
    "splade_activations",
    "load_nemotron_gguf",
    "read_gguf",
    "write_gguf",
    "load_hf_bert_encoder",
    "load_hf_cross_encoder",
    "load_hf_rotary_encoder",
    "WordPieceTokenizer",
]
