"""The device rule: the port's entry points run on the card unless the
caller asks for the CPU; without a CUDA device, a default device raises
instead of moving to the CPU."""

import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import retriever_from_state
from trueno_rag_tpu_torch.device import resolve_device


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(trag.InvalidConfigError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: trag.VectorStore(trag.VectorStoreConfig(dimension=8)),
    lambda: trag.VectorStore(trag.VectorStoreConfig(dimension=8, scan_tier="clustered")),
    lambda: trag.BM25Index(),
    lambda: trag.HybridRetriever(trag.MockEmbedder(8)),
    lambda: trag.RagPipelineBuilder().with_embedder(trag.MockEmbedder(8)).with_reranker(trag.NoOpReranker()).build(),
    lambda: retriever_from_state(trag.MockEmbedder(8), [], torch.zeros(4, 8).numpy(),
                                 torch.zeros(4, dtype=torch.bool).numpy(), trag.BM25Index(device="cpu").state_dict()),
])
def test_entry_points_default_to_cuda(no_cuda, make):
    with pytest.raises(trag.InvalidConfigError):
        make()


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    store = trag.VectorStore(trag.VectorStoreConfig(dimension=8), device="cpu")
    assert store.device == torch.device("cpu")
    p = (trag.RagPipelineBuilder().with_embedder(trag.MockEmbedder(8))
         .with_reranker(trag.NoOpReranker()).with_device("cpu").build())
    p.index_documents([trag.Document("alpha beta gamma", id="d")])
    assert p.query("alpha", k=1)[0].chunk.document_id == "d"


def test_clustered_store_runs_on_the_cpu_when_asked(no_cuda):
    """The clustered tier on the CPU: its fetch resolves to the copy-and-scan
    form there, and a query answers."""
    import numpy as np

    store = trag.VectorStore(trag.VectorStoreConfig(dimension=8, scan_tier="clustered", scan_tile_n=1024),
                             device="cpu")
    rows = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    store.insert_many([trag.Chunk(id=f"c{i}", document_id="d", content="x", start_offset=0, end_offset=1,
                                  metadata=trag.ChunkMetadata(), embedding=r.tolist()) for i, r in enumerate(rows)])
    hits = store.search(rows[3], 1)
    assert hits[0][0] == "c3"
    assert store._cluster[1].device == torch.device("cpu")


def test_load_nemotron_gguf_defaults_to_cuda(no_cuda, tmp_path):
    """``load_nemotron_gguf`` with no device resolves to the card: without
    one it raises; asked for the CPU it loads there."""
    import numpy as np

    from trueno_rag_tpu_torch.models.gguf import load_nemotron_gguf, write_gguf

    rng = np.random.default_rng(0)
    h, m = 8, 16
    tensors = {"token_embd.weight": rng.standard_normal((32, h)).astype(np.float32),
               "output_norm.weight": np.ones(h, np.float32)}
    for name, shape in (("attn_q", (h, h)), ("attn_k", (h, h)), ("attn_v", (h, h)), ("attn_output", (h, h)),
                        ("ffn_gate", (m, h)), ("ffn_up", (m, h)), ("ffn_down", (h, m))):
        tensors[f"blk.0.{name}.weight"] = rng.standard_normal(shape).astype(np.float32)
    tensors["blk.0.attn_norm.weight"] = tensors["blk.0.ffn_norm.weight"] = np.ones(h, np.float32)
    path = str(tmp_path / "tiny.gguf")
    write_gguf(path, {"general.architecture": "llama", "llama.block_count": 1, "llama.embedding_length": h,
                      "llama.feed_forward_length": m, "llama.attention.head_count": 2}, tensors)
    with pytest.raises(trag.InvalidConfigError, match="device='cpu'"):
        load_nemotron_gguf(path)
    params, config = load_nemotron_gguf(path, device="cpu")
    assert config.num_layers == 1 and params["tok_emb"].device == torch.device("cpu")
