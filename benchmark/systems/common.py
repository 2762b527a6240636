"""What the systems share: the port's encoder configuration from a
configuration file, and the corpus's chunks with their ids."""

from __future__ import annotations


def encoder_config(cfg: dict):
    from trueno_rag_tpu_torch import EncoderConfig

    return EncoderConfig(vocab_size=cfg["vocab_size"], hidden_dim=cfg["hidden_size"],
                         num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
                         mlp_dim=cfg["intermediate_size"], max_len=cfg["max_position_embeddings"])


def chunk_id(row: int) -> str:
    """The id of corpus chunk ``row``: the UUID whose integer is ``row``."""
    h = f"{row:032x}"
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def row_of(cid: str) -> int:
    return int(cid.replace("-", ""), 16)


def chunks_of(texts):
    """One one-chunk document per text. The chunks share one empty metadata
    record (nothing on the query path writes to it), which saves ~5 s of
    set-up at 1M chunks."""
    from trueno_rag_tpu_torch.chunking import Chunk, ChunkMetadata

    meta = ChunkMetadata()
    return [Chunk(f"d{i}", t, 0, len(t), meta, None, chunk_id(i)) for i, t in enumerate(texts)]
