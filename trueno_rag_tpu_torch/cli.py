"""Command-line interface: ``info`` / ``demo`` / ``index`` / ``query`` /
``serve``.

PyTorch-port counterpart of ``trueno_rag_tpu/cli.py``, with the same
commands, options and artifacts (an index written by either package's
CLI is queried by the other's):

- ``info``  — version, the torch device and the component list;
- ``demo``  — TF-IDF pipeline over built-in sample texts, results +
  assembled context + citations;
- ``index`` — walk .txt/.md files, chunk, embed, persist an index
  artifact (:mod:`trueno_rag_tpu_torch.persist`; the v2 streaming writer
  past 50,000 chunks); with ``--with-learned-sparse`` the hybrid index
  gains a learned-sparse (SPLADE-class) third source; ``--multi-vector``
  writes a late-interaction token index instead, ``--learned-sparse`` a
  learned-sparse posting index;
- ``query`` — load an index and run a hybrid, tri-hybrid, MaxSim or
  learned-sparse query, printed as text or JSON;
- ``serve`` — serve an index over HTTP through the micro-batcher
  (:mod:`trueno_rag_tpu_torch.serve`; ``--workers N`` adds N front-end
  processes, ``--autotune`` calibrates the batch size).

Usage: ``python -m trueno_rag_tpu_torch.cli [--device cpu] <command> ...``.
Everything runs on the card unless ``--device`` names another device.
``--embedder semantic --model DIR`` loads a local Hugging Face checkpoint
(:mod:`trueno_rag_tpu_torch.models.hf_import`: ``roformer`` and
``nomic_bert`` through the rotary loader, every other ``model_type``
through the BERT loader).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


DEMO_TEXTS = [
    (
        "Introduction to RAG",
        "Retrieval-Augmented Generation (RAG) combines information retrieval "
        "with language model generation. Documents are chunked, embedded and "
        "indexed; at query time relevant chunks are retrieved and assembled "
        "into grounded context for the model.",
    ),
    (
        "Dense Retrieval",
        "Dense retrieval encodes text into embedding vectors and ranks "
        "documents by vector similarity such as cosine similarity. It "
        "captures semantic matches that keyword search misses.",
    ),
    (
        "Sparse Retrieval",
        "Sparse retrieval like BM25 scores documents by term frequency and "
        "inverse document frequency over an inverted index. It excels at "
        "exact keyword matching and rare terms.",
    ),
    (
        "Hybrid Search",
        "Hybrid search fuses dense and sparse rankings with strategies like "
        "reciprocal rank fusion. Fusion combines the complementary strengths "
        "of semantic and lexical retrieval for better recall.",
    ),
]


def _build_embedder(kind: str, dimension: int, model: Optional[str], seed: int = 0, device=None):
    from trueno_rag_tpu_torch.embed import TfIdfEmbedder

    if kind == "tfidf":
        return TfIdfEmbedder(dimension)
    if kind == "semantic":
        from trueno_rag_tpu_torch.models.encoder import EncoderConfig, EncoderEmbedder

        name = model or "mini-lm"
        if os.path.isdir(name):  # a local Hugging Face checkpoint directory
            from trueno_rag_tpu_torch.errors import SerializationError

            cfg_path = os.path.join(name, "config.json")
            try:
                with open(cfg_path) as f:
                    model_type = json.load(f).get("model_type", "bert")
            except OSError as e:
                raise SerializationError(
                    f"model directory {name!r} has no readable config.json ({e}); "
                    "expected an HF checkpoint directory") from e
            except json.JSONDecodeError as e:
                raise SerializationError(f"unparseable {cfg_path!r}: {e}") from e
            from trueno_rag_tpu_torch.models import hf_import

            if model_type in ("roformer", "nomic_bert"):
                return hf_import.load_hf_rotary_encoder(name, device=device)
            return hf_import.load_hf_bert_encoder(name, device=device)
        configs = {
            "mini-lm": EncoderConfig.minilm_l6,
            "mini-lm-l12": EncoderConfig.minilm_l12,
            "bge-small": EncoderConfig.bge_small,
            "bge-base": EncoderConfig.bge_base,
            "nomic": EncoderConfig.nomic,
        }
        if name not in configs:
            raise SystemExit(f"unknown model {name!r}; choose from {sorted(configs)}")
        return EncoderEmbedder(config=configs[name](), seed=seed, model_name=name, device=device)
    raise SystemExit(f"unknown embedder {kind!r}; choose tfidf or semantic")


def cmd_info(args) -> int:
    import torch

    import trueno_rag_tpu_torch as rag

    print(f"trueno-rag-tpu-torch v{rag.__version__}")
    print()
    print("RAG pipeline framework on PyTorch + CUDA (hand-written kernels for Hopper)")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x cuda ({torch.cuda.get_device_name(0)})")
    else:
        print("devices: no CUDA device (pass --device cpu)")
    print()
    print("components:")
    for line in [
        "  chunking: recursive, fixed-size, sentence, paragraph, structural, semantic",
        "  embedders: mock, tfidf, encoder (MiniLM/BGE-class), nemotron-class",
        "  indexes: dense vector store (card-resident; bf16/int8/compact/clustered tiers),",
        "           BM25 (block table, segment fetch), late-interaction (MaxSim token index),",
        "           learned-sparse (SPLADE)",
        "  fusion: rrf, linear, convex, dbsf, union, intersection",
        "  rerankers: noop, lexical, mmr, mock-cross-encoder, neural cross-encoder, late-interaction",
        "  context: sequential / document-grouped / interleaved assembly + citations",
        "  metrics: recall/precision/NDCG/MRR/MAP/F1/hit-rate @k + aggregation",
        "  preprocessing: hyde, multi-query, keyword/synonym expansion, analyzer, adaptive",
        "  persistence: zstd/zlib/lz4 compressed index artifacts, safetensors checkpoints",
        "  serving: micro-batched HTTP server, worker processes, autotuning",
    ]:
        print(line)
    return 0


def cmd_demo(args) -> int:
    from trueno_rag_tpu_torch import (
        Document,
        FusionStrategy,
        LexicalReranker,
        RagPipelineBuilder,
        RecursiveChunker,
        TfIdfEmbedder,
    )

    docs = [Document(text, title=title) for title, text in DEMO_TEXTS]
    embedder = TfIdfEmbedder(128).fit([d.content for d in docs])
    pipeline = (
        RagPipelineBuilder()
        .with_embedder(embedder)
        .with_reranker(LexicalReranker())
        .with_chunker(RecursiveChunker(chunk_size=256, overlap=32))
        .with_fusion(FusionStrategy.rrf(60.0))
        .with_device(args.device)
        .build()
    )
    n = pipeline.index_documents(docs)
    print(f"indexed {len(docs)} documents ({n} chunks)")
    query = args.query
    print(f"\nquery: {query}\n")
    results = pipeline.query(query, k=args.top_k)
    for i, r in enumerate(results, 1):
        print(f"{i}. [{r.best_score():.4f}] {r.chunk.metadata.title}: {r.chunk.content[:100]}...")
    ctx = pipeline.query_with_context(query, k=args.top_k)
    print("\n--- assembled context ---")
    print(ctx.format_with_citations())
    print("\n--- citations ---")
    print(ctx.citation_list())
    return 0


def _walk_documents(path: str):
    from trueno_rag_tpu_torch import Document

    exts = (".txt", ".md")
    files: List[str] = []
    if os.path.isfile(path):
        files = [path]
    elif os.path.isdir(path):
        for root, _dirs, names in sorted(os.walk(path)):
            for name in sorted(names):
                if name.lower().endswith(exts):
                    files.append(os.path.join(root, name))
    else:
        raise SystemExit(f"error: path does not exist: {path}")
    docs = []
    for f in files:
        try:
            with open(f, "r", encoding="utf-8", errors="replace") as fh:
                content = fh.read()
        except OSError as e:
            print(f"warning: skipping {f}: {e}", file=sys.stderr)
            continue
        if content.strip():
            docs.append(Document(content, title=os.path.basename(f), source=f))
    if not docs:
        raise SystemExit(f"error: no indexable .txt/.md documents under {path}")
    return docs


def _doc_tags_for(docs, args):
    """The index command's document tags (shared by the hybrid and
    multi-vector paths)."""
    base_tags = [t for t in (args.tags or "").split(",") if t]
    if not base_tags and not args.tag_by_dir:
        return None
    doc_tags = []
    root = os.path.abspath(args.path)
    for d in docs:
        tags = list(base_tags)
        if args.tag_by_dir and d.source:
            rel = os.path.relpath(os.path.abspath(d.source), root)
            parent = os.path.dirname(rel)
            if parent and parent != ".":
                tags.append(f"dir:{parent.split(os.sep)[0]}")
        doc_tags.append(tags)
    return doc_tags


def _multi_vector_retriever(device, seed: int = 0):
    """The CLI's late-interaction retriever: the seed-0 tiny encoder, 32
    tokens per chunk, the tiered scan (the JAX CLI's store)."""
    from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig
    from trueno_rag_tpu_torch.models.encoder import EncoderConfig
    from trueno_rag_tpu_torch.models.late_interaction import LateInteractionRetriever

    enc = EncoderConfig.tiny()
    return LateInteractionRetriever(
        config=enc, seed=seed, max_len=32, device=device,
        store_config=TokenStoreConfig(hidden_dim=enc.hidden_dim, max_tokens=32, scan="tiered"),
    )


def _cmd_index_multi_vector(args, docs) -> int:
    """Multi-vector (late-interaction / MaxSim) indexing: chunks store a
    token matrix each; queries run the certified tiered scan. The encoder
    identity is the deterministic seed-0 tiny encoder; checkpoints go
    through the library API (``persist.load_token_index(params=...)``)."""
    from trueno_rag_tpu_torch import RecursiveChunker
    from trueno_rag_tpu_torch.persist import save_token_index

    chunker = RecursiveChunker(chunk_size=args.chunk_size, overlap=args.chunk_overlap)
    retr = _multi_vector_retriever(args.device)
    doc_tags = _doc_tags_for(docs, args)
    n_chunks = 0
    for di, d in enumerate(docs):
        chunks = chunker.chunk(d)
        retr.index_batch(chunks)
        n_chunks += len(chunks)
        if doc_tags is not None and doc_tags[di]:
            for c in chunks:
                retr.store.registry.set_tags(c.id, doc_tags[di])
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, "token_index.trag")
    stats = save_token_index(out_path, retr)
    print(
        f"indexed {len(docs)} documents, {n_chunks} chunks (multi-vector) "
        f"-> {out_path} ({stats['compressed_bytes']} bytes compressed)"
    )
    return 0


def _cmd_index_learned_sparse(args, docs) -> int:
    """Learned-sparse (SPLADE-class) indexing: each chunk stores a top-T
    vocabulary expansion; queries score through the weighted block-gather
    path. The encoder identity is the deterministic seed-0 tiny encoder;
    checkpoints go through the library API
    (``persist.load_splade_index(params=...)``)."""
    from trueno_rag_tpu_torch import RecursiveChunker
    from trueno_rag_tpu_torch.models.splade import SpladeRetriever
    from trueno_rag_tpu_torch.persist import save_splade_index

    chunker = RecursiveChunker(chunk_size=args.chunk_size, overlap=args.chunk_overlap)
    retr = SpladeRetriever(seed=0, device=args.device)
    doc_tags = _doc_tags_for(docs, args)
    n_chunks = 0
    for di, d in enumerate(docs):
        chunks = chunker.chunk(d)
        retr.index_batch(chunks)
        n_chunks += len(chunks)
        if doc_tags is not None and doc_tags[di]:
            for c in chunks:
                retr.registry.set_tags(c.id, doc_tags[di])
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, "splade_index.trag")
    stats = save_splade_index(out_path, retr)
    print(
        f"indexed {len(docs)} documents, {n_chunks} chunks (learned-sparse, "
        f"{stats['postings']} postings) -> {out_path} ({stats['compressed_bytes']} bytes compressed)"
    )
    return 0


def cmd_index(args) -> int:
    from trueno_rag_tpu_torch import NoOpReranker, RagPipelineBuilder, RecursiveChunker
    from trueno_rag_tpu_torch.persist import save_index, save_index_streaming

    if args.multi_vector and args.learned_sparse:
        raise SystemExit("error: --multi-vector and --learned-sparse are mutually exclusive")
    if args.with_learned_sparse and (args.multi_vector or args.learned_sparse):
        raise SystemExit(
            "error: --with-learned-sparse augments the HYBRID index; it "
            "cannot combine with --multi-vector/--learned-sparse"
        )
    docs = _walk_documents(args.path)
    if args.multi_vector:
        return _cmd_index_multi_vector(args, docs)
    if args.learned_sparse:
        return _cmd_index_learned_sparse(args, docs)
    embedder = _build_embedder(args.embedder, args.dimension, args.model, device=args.device)
    if args.embedder == "tfidf":
        embedder.fit([d.content for d in docs])
    builder = (
        RagPipelineBuilder()
        .with_embedder(embedder)
        .with_reranker(NoOpReranker())
        .with_chunker(RecursiveChunker(chunk_size=args.chunk_size, overlap=args.chunk_overlap))
        .with_device(args.device)
    )
    if args.with_learned_sparse:
        # the seed-0 encoder identity; the loader rebuilds it from the
        # artifact's expansion config
        from trueno_rag_tpu_torch.models.splade import SpladeEncoder

        builder = builder.with_learned_sparse(SpladeEncoder(seed=0, device=args.device))
    pipeline = builder.build()
    n_chunks = pipeline.index_documents(docs, tags=_doc_tags_for(docs, args))
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, "index.trag")
    info = {"type": args.embedder, "dimension": embedder.dimension, "model": args.model}
    if args.embedder == "tfidf":
        info["state"] = embedder.state_dict()
    else:
        info["seed"] = 0
    save = save_index_streaming if n_chunks > 50_000 else save_index  # stream large artifacts
    stats = save(out_path, pipeline.retriever, embedder_info=info)
    print(
        f"indexed {len(docs)} documents, {n_chunks} chunks "
        f"-> {out_path} ({stats['compressed_bytes']} bytes compressed)"
    )
    return 0


def _load(index_dir: str, scan_tier=None, device=None):
    """The retriever of an index directory (either package's artifact):
    the hybrid ``index.trag`` (a tri-hybrid's learned source re-attached
    with the seed-0 encoder its config names), the multi-vector
    ``token_index.trag`` or the learned-sparse ``splade_index.trag``."""
    from trueno_rag_tpu_torch.embed import TfIdfEmbedder
    from trueno_rag_tpu_torch.persist import load_index, load_splade_index, load_token_index, read_index_info

    path = os.path.join(index_dir, "index.trag")
    tok_path = os.path.join(index_dir, "token_index.trag")
    splade_path = os.path.join(index_dir, "splade_index.trag")
    if not os.path.exists(path):
        # the CLI's seed-0 encoder identities; a token index's scan tier
        # persisted with its store config
        if os.path.exists(tok_path):
            return load_token_index(tok_path, seed=0, device=device)
        if os.path.exists(splade_path):
            return load_splade_index(splade_path, seed=0, device=device)
        raise SystemExit(f"error: no index found at {path}")
    payload = read_index_info(path)  # header only: both artifact formats
    info = payload.get("embedder", {})
    kind = info.get("type", "tfidf")
    if kind == "tfidf":
        if "state" in info:
            embedder = TfIdfEmbedder.from_state_dict(info["state"])
        else:
            # an artifact without persisted vocabulary: re-fitting on the
            # chunk texts gives another df/idf space than the stored matrix's
            print(
                "warning: index lacks persisted TF-IDF state; re-fitting on "
                "chunks — dense scores may be inconsistent",
                file=sys.stderr,
            )
            embedder = TfIdfEmbedder(info.get("dimension", 128))
            embedder.fit([c["content"] for c in payload["chunks"]])
    else:
        embedder = _build_embedder("semantic", info.get("dimension", 384), info.get("model"),
                                   info.get("seed", 0), device=device)
    learned_encoder = None
    learned = payload.get("learned")
    if learned:
        # a tri-hybrid: the encoder of the saved identity (load_index checks
        # its weights' fingerprint) re-attaches the learned source
        from trueno_rag_tpu_torch.models.splade import SpladeEncoder

        learned_encoder = SpladeEncoder(
            seed=int(learned.get("seed") or 0), max_len=int(learned["max_len"]),
            doc_top=int(learned["doc_top"]), query_top=int(learned["query_top"]), device=device,
        )
    retr, _ = load_index(path, embedder, scan_tier=scan_tier, learned_encoder=learned_encoder, device=device)
    return retr


def cmd_query(args) -> int:
    retr = _load(args.index, scan_tier=args.scan_tier, device=args.device)
    tag_filter = None
    if args.filter_all or args.filter_any or args.filter_none:
        from trueno_rag_tpu_torch.retrieve import TagFilter

        def split(v):
            return tuple(t for t in (v or "").split(",") if t)

        tag_filter = TagFilter(all=split(args.filter_all), any=split(args.filter_any),
                               none=split(args.filter_none))
    results = retr.retrieve(args.query_text, args.top_k, tag_filter=tag_filter)
    if args.format == "json":
        out = [
            {
                "rank": i + 1,
                "score": r.best_score(),
                "dense_score": r.dense_score,
                "sparse_score": r.sparse_score,
                "fused_score": r.fused_score,
                "learned_score": r.learned_score,
                "title": r.chunk.metadata.title,
                "source": r.chunk.metadata.custom.get("source"),
                "content": r.chunk.content,
            }
            for i, r in enumerate(results)
        ]
        print(json.dumps(out, indent=2))
    else:
        if not results:
            print("no results")
        for i, r in enumerate(results, 1):
            title = r.chunk.metadata.title or "untitled"
            print(f"{i}. [{r.best_score():.4f}] {title}")
            print(f"   {r.chunk.content[:160]}")
    return 0


def cmd_serve(args) -> int:
    from trueno_rag_tpu_torch.serve import run_server

    retr = _load(args.index, scan_tier=args.scan_tier, device=args.device)
    run_server(retr, host=args.host, port=args.port,
               max_batch="auto" if args.autotune else args.max_batch, max_wait_ms=args.max_wait_ms,
               latency_budget_ms=args.latency_budget_ms, workers=args.workers,
               # POST /reload re-reads the directory with the same tier
               index_loader=lambda: _load(args.index, scan_tier=args.scan_tier, device=args.device))
    return 0


_SCAN_TIERS = ["none", "auto", "bf16", "int8", "compact", "clustered"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="trueno-rag-tpu-torch",
                                description="RAG pipeline CLI (PyTorch + CUDA)")
    p.add_argument("--device", default=None,
                   help="torch device for the indexes and models (default: the CUDA device)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="show version and components").set_defaults(fn=cmd_info)

    d = sub.add_parser("demo", help="run the built-in demo pipeline")
    d.add_argument("--query", default="How does hybrid search combine retrieval methods?")
    d.add_argument("--top-k", type=int, default=3)
    d.set_defaults(fn=cmd_demo)

    i = sub.add_parser("index", help="index .txt/.md documents")
    i.add_argument("--path", required=True, help="file or directory to index")
    i.add_argument("--output", required=True, help="output directory for the index artifact")
    i.add_argument("--chunk-size", type=int, default=512)
    i.add_argument("--chunk-overlap", type=int, default=64)
    i.add_argument("--dimension", type=int, default=256)
    i.add_argument("--embedder", choices=["tfidf", "semantic"], default="tfidf")
    i.add_argument("--model", default=None, help="semantic model: mini-lm|mini-lm-l12|bge-small|bge-base|nomic")
    i.add_argument("--tags", default=None, help="comma-separated tags applied to every document")
    i.add_argument("--tag-by-dir", action="store_true",
                   help="tag each document dir:<top-level subdirectory>")
    i.add_argument("--multi-vector", action="store_true",
                   help="build a late-interaction (MaxSim) token index instead of the hybrid "
                        "dense+BM25 index; query auto-detects the artifact (token_index.trag)")
    i.add_argument("--learned-sparse", action="store_true",
                   help="build a learned-sparse (SPLADE-class) posting index instead of the hybrid "
                        "dense+BM25 index: every chunk stores a top-T vocabulary expansion; "
                        "query/serve auto-detect the artifact (splade_index.trag)")
    i.add_argument("--with-learned-sparse", action="store_true",
                   help="also attach a learned-sparse (SPLADE-class) third source to the hybrid "
                        "index: queries fuse dense + BM25 + learned expansions N-way; the "
                        "expansions persist inside index.trag and query/serve re-attach them")
    i.set_defaults(fn=cmd_index)

    q = sub.add_parser("query", help="query a persisted index")
    q.add_argument("query_text")
    q.add_argument("--index", required=True, help="directory containing index.trag")
    q.add_argument("--top-k", type=int, default=5)
    q.add_argument("--format", choices=["text", "json"], default="text")
    q.add_argument("--filter-all", default=None, help="comma-separated tags results must ALL carry")
    q.add_argument("--filter-any", default=None, help="comma-separated tags; results need at least one")
    q.add_argument("--filter-none", default=None, help="comma-separated tags results must NOT carry")
    q.add_argument("--scan-tier", choices=_SCAN_TIERS, default=None,
                   help="dense scan tier for the loaded store (default fp32; 'auto' engages the "
                        "certified bf16 tier past ~400k rows, 'compact' serves multi-million-chunk "
                        "indexes without a fp32 matrix on the card)")
    q.set_defaults(fn=cmd_query)

    s = sub.add_parser("serve", help="serve a persisted index over HTTP (micro-batched)")
    s.add_argument("--index", required=True, help="directory containing index.trag")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--max-batch", type=int, default=32)
    s.add_argument("--max-wait-ms", type=float, default=5.0)
    s.add_argument("--autotune", action="store_true",
                   help="calibrate max-batch/max-wait by measurement at startup")
    s.add_argument("--latency-budget-ms", type=float, default=None,
                   help="with --autotune: exclude batch sizes whose p50 exceeds this")
    s.add_argument("--scan-tier", choices=_SCAN_TIERS, default="auto",
                   help="dense scan tier for serving (default 'auto': fp32 below ~400k rows, the "
                        "certified bf16 tier past it)")
    s.add_argument("--workers", type=int, default=0,
                   help="HTTP front-end worker processes (SO_REUSEPORT); 0 = serve HTTP from this process")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:  # downstream pipe (e.g. `| head`) closed early
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
