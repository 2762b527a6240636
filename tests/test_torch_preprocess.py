"""The port's query preprocessing against the JAX package's: every
preprocessor and expander gives the same variants, the analyzer the same
intent, keywords and confidence, the adaptive preprocessor the same
routes and fusion choices; and a pipeline with a preprocessor gives the
same results as the JAX pipeline with it (single and batched queries, a
tag filter), on ``test_torch_pipeline``'s tie-free corpus."""

import pytest

import trueno_rag_tpu as jrag
from trueno_rag_tpu import preprocess as jpre
from trueno_rag_tpu import preprocess_adaptive as jada

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import preprocess as tpre
from trueno_rag_tpu_torch import preprocess_adaptive as tada

from test_torch_pipeline import DIM, QUERIES, _IdChunker, _same_results, _texts

QUERY_SET = [
    "how to install the search service",
    "what is a config file",
    "error when I fix the slow build",
    "compare bm25 vs dense retrieval",
    "why does the delete fail",
    "doc search fast",
    "Error! Fix? create",
    "the of and",
    "w001 w002 w003",
    "overview",
]


def _make(pkg, name):
    """The same preprocessor built from either package's module pair."""
    pre, ada = (tpre, tada) if pkg == "port" else (jpre, jada)
    custom = {"W001": ["w002", "w005"], "fast": ["quick"]}
    return {
        "passthrough": lambda: pre.PassthroughPreprocessor(),
        "hyde": lambda: pre.HydePreprocessor(),
        "hyde_augment": lambda: pre.HydePreprocessor(augment=True),
        "multi_keyword": lambda: pre.MultiQueryPreprocessor(pre.KeywordExpander(max_keyword_variants=2)),
        "multi_synonym": lambda: pre.MultiQueryPreprocessor(pre.SynonymExpander(), max_queries=3),
        "multi_custom": lambda: pre.MultiQueryPreprocessor(pre.SynonymExpander(custom)),
        "multi_one": lambda: pre.MultiQueryPreprocessor(pre.KeywordExpander(), max_queries=1),
        "chained": lambda: pre.ChainedPreprocessor(
            [pre.HydePreprocessor(augment=True), pre.MultiQueryPreprocessor(pre.SynonymExpander())], max_total=4),
        "chained_empty": lambda: pre.ChainedPreprocessor([]),
        "adaptive": lambda: ada.AdaptivePreprocessor(),
    }[name]()


NAMES = ["passthrough", "hyde", "hyde_augment", "multi_keyword", "multi_synonym", "multi_custom", "multi_one",
         "chained", "chained_empty", "adaptive"]


@pytest.mark.parametrize("name", NAMES)
def test_preprocessors_give_the_same_variants(name):
    t, j = _make("port", name), _make("jax", name)
    assert t.name == j.name
    assert isinstance(t, tpre.QueryPreprocessor)
    for q in QUERY_SET:
        assert t.preprocess(q) == j.preprocess(q), q
    if name != "chained_empty":
        with pytest.raises(trag.QueryError):
            t.preprocess("   ")


def test_expanders_and_analyzer_match_jax():
    for q in QUERY_SET:
        assert tpre.KeywordExpander().expand(q) == jpre.KeywordExpander().expand(q)
        assert tpre.SynonymExpander().expand(q) == jpre.SynonymExpander().expand(q)
        a, b = tpre.QueryAnalyzer().analyze(q), jpre.QueryAnalyzer().analyze(q)
        assert (a.intent.value, a.keywords, a.confidence) == (b.intent.value, b.keywords, b.confidence)
        fa = tada.AdaptivePreprocessor().fusion_for(q)
        fb = jada.AdaptivePreprocessor().fusion_for(q)
        assert (fa is None) == (fb is None)
        if fa is not None:
            assert fa.to_dict() == fb.to_dict()
    assert tpre.MockHypotheticalGenerator().generate("x") == jpre.MockHypotheticalGenerator().generate("x")


def _pipeline(rag, pre):
    b = (
        rag.RagPipelineBuilder()
        .with_embedder(rag.MockEmbedder(DIM))
        .with_reranker(rag.LexicalReranker())
        .with_chunker(_IdChunker(rag.RecursiveChunker(chunk_size=8192, overlap=0)))
        .with_retriever_config(rag.HybridRetrieverConfig(candidates_per_source=12))
        .with_vector_config(rag.VectorStoreConfig(dimension=DIM))
        .with_preprocessor(pre)
    )
    if rag is trag:
        b = b.with_device("cpu")
    p = b.build()
    texts = _texts(n=300)
    tags = [["even" if i % 2 == 0 else "odd"] for i in range(len(texts))]
    p.index_documents([rag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(texts)], tags=tags)
    return p


@pytest.mark.parametrize("name", ["multi_keyword", "hyde_augment", "adaptive"])
def test_pipeline_with_a_preprocessor_matches_jax(name):
    tp, jp = _pipeline(trag, _make("port", name)), _pipeline(jrag, _make("jax", name))
    queries = QUERIES[:4] + ["how to w001 w002", "what is w150 w003"]
    _same_results([tp.query(q, k=5) for q in queries], [jp.query(q, k=5) for q in queries])
    _same_results(tp.query_batch(queries, k=5), jp.query_batch(queries, k=5))
    _same_results(tp.query_batch(queries[:2], k=4, tag_filter=trag.TagFilter(all=("even",))),
                  jp.query_batch(queries[:2], k=4, tag_filter=jrag.TagFilter(all=("even",))))
    ctx = tp.query_with_context(queries[0], k=3)
    assert ctx.chunks and ctx.citations
