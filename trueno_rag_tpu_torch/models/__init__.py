"""Neural models — PyTorch forward passes for query/document embedding and
reranking, the counterparts of the JAX package's ``models``:

- :mod:`~trueno_rag_tpu_torch.models.encoder` — MiniLM/BGE-class
  bidirectional encoder (384/768-d), four poolings, bf16 products;
- :mod:`~trueno_rag_tpu_torch.models.nemotron` — the Nemotron-class
  decoder-style embedder (4096-d, 8192 tokens), whose long-context
  attention is the CUDA kernel ``block_attention``;
- :mod:`~trueno_rag_tpu_torch.models.cross_encoder` — the neural
  cross-encoder reranker;
- :mod:`~trueno_rag_tpu_torch.models.late_interaction` — ColBERT-style
  MaxSim: the late-interaction reranker and the corpus-scale retriever
  over the token store (its tiered scan is the CUDA kernels K6/K7);
- :mod:`~trueno_rag_tpu_torch.models.gguf` — GGUF model files;
- :mod:`~trueno_rag_tpu_torch.models.tokenization` — WordPiece.

Weights: no network here, so constructors draw seeded random weights
from a ``torch.Generator`` on the model's device, or take a parameter
dict (``convert.py`` carries the JAX package's across; ``from_gguf``
reads a model file). Not ported yet (ROADMAP Queue 1): SPLADE, the
Hugging Face importers and device-side GGUF dequantization.
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
from trueno_rag_tpu_torch.models.gguf import load_nemotron_gguf, read_gguf, write_gguf
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
    "CrossEncoderReranker",
    "cross_encoder_scores",
    "init_cross_encoder_params",
    "LateInteractionReranker",
    "LateInteractionRetriever",
    "late_interaction_scores",
    "maxsim",
    "maxsim_oracle",
    "load_nemotron_gguf",
    "read_gguf",
    "write_gguf",
    "WordPieceTokenizer",
]
