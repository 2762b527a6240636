"""The port's CLI against the JAX package's: ``index`` and ``query`` in
process give JSON equal to the JAX CLI's on the same files (TF-IDF; tags
by folder and by flag; every filter kind), each CLI queries the other's
index, the multi-vector and semantic indexes answer as the in-memory
retrievers do, a semantic model from a local Hugging Face directory
answers as the JAX CLI's does, ``info`` and ``demo`` run, the
learned-sparse indexes build, the entry points need
``--device cpu`` without a card; and the port (package and
``chip_smoke.py``) names neither JAX nor the JAX package."""

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from trueno_rag_tpu import cli as jcli

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import cli as tcli

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
FIELDS = (("dense_score", 1e-5), ("sparse_score", 1e-4), ("fused_score", 1e-6), ("score", 1e-6))


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    docs = root / "docs"
    rng = np.random.default_rng(0)
    words = [f"w{i:03d}" for i in range(150)]
    for i in range(60):
        sub = docs / ["", "alpha", "beta"][i % 3]
        sub.mkdir(parents=True, exist_ok=True)
        # one chunk per file, of distinct lengths: no two BM25 scores tie
        (sub / f"f{i:02d}.md").write_text(" ".join(rng.choice(words, size=20 + i)))
    (docs / "skip.bin").write_text("not indexed")
    out = {"docs": str(docs)}
    for name, mod, pre in (("jax", jcli, []), ("port", tcli, CPU)):
        rc, text = _run(mod, pre + ["index", "--path", str(docs), "--output", str(root / name), "--tag-by-dir",
                                    "--tags", "all", "--dimension", "64", "--chunk-size", "4096",
                                    "--chunk-overlap", "16"])
        assert rc == 0 and "indexed 60 documents" in text
        out[name] = str(root / name)
    return out


def _same_json(a, b):
    assert [(r["rank"], r["title"], r["content"], r["source"]) for r in a] == [
        (r["rank"], r["title"], r["content"], r["source"]) for r in b]
    for x, y in zip(a, b):
        assert x["learned_score"] is None and y["learned_score"] is None
        for name, tol in FIELDS:
            assert (x[name] is None) == (y[name] is None), name
            if x[name] is not None:
                assert abs(x[name] - y[name]) <= tol * max(1.0, abs(y[name])), (name, x[name], y[name])


FILTERS = [[], ["--filter-any", "dir:alpha,dir:beta"], ["--filter-all", "all,dir:beta"],
           ["--filter-none", "dir:alpha"], ["--filter-all", "nosuchtag"]]


@pytest.mark.parametrize("flt", FILTERS, ids=["none", "any", "all", "none-of", "unknown"])
def test_query_json_matches_the_jax_cli(corpus, flt):
    for q in ("w001 w002 w003", "w120 w007", "w050"):
        argv = ["query", q, "--format", "json", "--top-k", "6"] + flt
        want = json.loads(_run(jcli, argv + ["--index", corpus["jax"]])[1])
        got = json.loads(_run(tcli, CPU + argv + ["--index", corpus["port"]])[1])
        _same_json(got, want)
        # each CLI reads the other's artifact
        _same_json(json.loads(_run(tcli, CPU + argv + ["--index", corpus["jax"]])[1]), want)
        _same_json(json.loads(_run(jcli, argv + ["--index", corpus["port"]])[1]), want)
        if flt == ["--filter-all", "nosuchtag"]:
            assert got == []


def test_query_text_and_scan_tiers(corpus):
    a = _run(jcli, ["query", "w001 w002", "--index", corpus["jax"]])[1]
    b = _run(tcli, CPU + ["query", "w001 w002", "--index", corpus["jax"]])[1]
    assert a == b and a.startswith("1. [")
    assert _run(tcli, CPU + ["query", "w001", "--index", corpus["port"], "--filter-all", "nosuchtag"])[1].strip() \
        == "no results"
    plain = json.loads(_run(tcli, CPU + ["query", "w010 w011", "--index", corpus["port"], "--format", "json"])[1])
    for tier in ("bf16", "compact", "int8"):
        tiered = json.loads(_run(tcli, CPU + ["query", "w010 w011", "--index", corpus["port"], "--format",
                                              "json", "--scan-tier", tier])[1])
        assert [r["content"] for r in tiered] == [r["content"] for r in plain], tier


def test_multi_vector_index_answers_as_the_in_memory_retriever(corpus, tmp_path):
    out = str(tmp_path / "mv")
    rc, text = _run(tcli, CPU + ["index", "--path", corpus["docs"], "--output", out, "--multi-vector",
                                 "--tag-by-dir", "--chunk-size", "256", "--chunk-overlap", "16"])
    assert rc == 0 and "(multi-vector)" in text and os.path.exists(os.path.join(out, "token_index.trag"))
    li = tcli._multi_vector_retriever("cpu")
    chunker = trag.RecursiveChunker(chunk_size=256, overlap=16)
    for d in tcli._walk_documents(corpus["docs"]):
        li.index_batch(chunker.chunk(d))
    for q in ("w001 w002", "w099"):
        got = json.loads(_run(tcli, CPU + ["query", q, "--index", out, "--format", "json"])[1])
        want = li.retrieve(q, 5)
        assert [(r["content"], r["score"]) for r in got] == [(r.chunk.content, r.best_score()) for r in want]
    filt = json.loads(_run(tcli, CPU + ["query", "w001", "--index", out, "--format", "json",
                                        "--filter-all", "dir:beta"])[1])
    assert filt and all("beta" not in r["content"] for r in filt)


def test_semantic_index_answers_as_the_in_memory_pipeline(tmp_path):
    docs = tmp_path / "docs"
    docs.mkdir()
    texts = ["dense retrieval ranks by vector similarity", "bm25 scores term frequency and idf",
             "hybrid search fuses both rankings", "chunks are embedded and indexed"]
    for i, t in enumerate(texts):
        (docs / f"d{i}.txt").write_text(t)
    out = str(tmp_path / "idx")
    assert _run(tcli, CPU + ["index", "--path", str(docs), "--output", out, "--embedder", "semantic",
                             "--model", "mini-lm"])[0] == 0
    assert trag.persist.read_index_info(os.path.join(out, "index.trag"))["embedder"] == {
        "type": "semantic", "dimension": 384, "model": "mini-lm", "seed": 0}
    emb = tcli._build_embedder("semantic", 384, "mini-lm", device="cpu")
    ref = (trag.RagPipelineBuilder().with_embedder(emb).with_reranker(trag.NoOpReranker())
           .with_chunker(trag.RecursiveChunker(chunk_size=512, overlap=64)).with_device("cpu").build())
    ref.index_documents(tcli._walk_documents(str(docs)))
    got = json.loads(_run(tcli, CPU + ["query", "vector similarity", "--index", out, "--format", "json"])[1])
    want = ref.retriever.retrieve("vector similarity", 5)
    assert [(r["content"], r["dense_score"], r["sparse_score"], r["fused_score"]) for r in got] == [
        (r.chunk.content, r.dense_score, r.sparse_score, r.fused_score) for r in want]


def test_semantic_from_a_local_hf_directory_answers_as_the_jax_cli(tmp_path):
    """A random-weight BERT checkpoint directory (written as safetensors by
    the port's own writer) indexed and queried through both CLIs: the same
    chunks in the same order, BM25 scores equal, dense and fused scores
    within the bf16 trunk's framework difference (1e-2); the port's answer
    equals an in-process pipeline's over the same loaded encoder."""
    from trueno_rag_tpu_torch.models.hf_import import load_hf_bert_encoder
    from trueno_rag_tpu_torch.persist import save_params

    rng = np.random.default_rng(3)
    h, layers, vocab = 32, 2, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        w for w in "dense retrieval ranks by vector similarity bm25 scores term frequency and idf hybrid "
                   "search fuses both rankings chunks are embedded indexed".split()]
    state = {"embeddings.word_embeddings.weight": rng.standard_normal((len(vocab), h)),
             "embeddings.position_embeddings.weight": rng.standard_normal((64, h)),
             "embeddings.token_type_embeddings.weight": rng.standard_normal((2, h)),
             "embeddings.LayerNorm.weight": np.ones(h), "embeddings.LayerNorm.bias": np.zeros(h)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (64, h)), ("output.dense", (h, 64))):
            state[p + name + ".weight"] = rng.standard_normal(shape)
            state[p + name + ".bias"] = rng.standard_normal(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[p + ln + ".weight"], state[p + ln + ".bias"] = np.ones(h), np.zeros(h)
    model_dir = tmp_path / "bert"
    model_dir.mkdir()
    save_params(str(model_dir / "model.safetensors"), {k: (v * 0.1).astype(np.float32) for k, v in state.items()})
    (model_dir / "config.json").write_text(json.dumps(dict(
        model_type="bert", vocab_size=len(vocab), hidden_size=h, num_hidden_layers=layers, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, pad_token_id=0)))
    (model_dir / "vocab.txt").write_text("\n".join(vocab))
    docs = tmp_path / "docs"
    docs.mkdir()
    texts = ["dense retrieval ranks by vector similarity", "bm25 scores term frequency and idf",
             "hybrid search fuses both rankings", "chunks are embedded and indexed"]
    for i, t in enumerate(texts):
        (docs / f"d{i}.txt").write_text(t)
    answers = {}
    for name, mod, pre in (("port", tcli, CPU), ("jax", jcli, [])):
        out = str(tmp_path / name)
        assert _run(mod, pre + ["index", "--path", str(docs), "--output", out, "--embedder", "semantic",
                                "--model", str(model_dir)])[0] == 0
        answers[name] = json.loads(_run(mod, pre + ["query", "vector similarity", "--index", out,
                                                    "--format", "json"])[1])
    got, want = answers["port"], answers["jax"]
    assert [r["content"] for r in got] == [r["content"] for r in want]
    for g, w in zip(got, want):
        assert g["sparse_score"] == pytest.approx(w["sparse_score"], rel=1e-4)
        assert g["dense_score"] == pytest.approx(w["dense_score"], abs=1e-2)
    emb = load_hf_bert_encoder(str(model_dir), device="cpu")
    ref = (trag.RagPipelineBuilder().with_embedder(emb).with_reranker(trag.NoOpReranker())
           .with_chunker(trag.RecursiveChunker(chunk_size=512, overlap=64)).with_device("cpu").build())
    ref.index_documents(tcli._walk_documents(str(docs)))
    inproc = ref.retriever.retrieve("vector similarity", 5)
    assert [(r["content"], r["dense_score"], r["sparse_score"], r["fused_score"]) for r in got] == [
        (r.chunk.content, r.dense_score, r.sparse_score, r.fused_score) for r in inproc]


def test_info_demo_and_the_unported_branches(corpus, tmp_path):
    assert _run(tcli, CPU + ["info"])[0] == 0
    rc, text = _run(tcli, CPU + ["demo", "--top-k", "2"])
    assert rc == 0 and "--- citations ---" in text
    base = CPU + ["index", "--path", corpus["docs"], "--output", str(tmp_path / "x")]
    for extra in (["--learned-sparse"], ["--with-learned-sparse"]):  # ported (tests/test_torch_tri_hybrid.py)
        rc, text = _run(tcli, base + extra)
        assert rc == 0 and "indexed 60 documents" in text
    with pytest.raises(SystemExit):
        _run(tcli, base + ["--multi-vector", "--learned-sparse"])
    # a local model directory is ported (test_semantic_from_a_local_hf_directory_answers_as_the_jax_cli):
    # one without a readable or parseable config.json raises as the JAX CLI does
    for body in (None, "{not json"):
        model_dir = tmp_path / f"model-{body is None}"
        model_dir.mkdir()
        if body is not None:
            (model_dir / "config.json").write_text(body)
        for mod, pre in ((tcli, base), (jcli, base[2:])):
            with pytest.raises(Exception, match="config.json" if body is None else "unparseable") as e:
                _run(mod, pre + ["--embedder", "semantic", "--model", str(model_dir)])
            assert type(e.value).__name__ == "SerializationError"
    with pytest.raises(SystemExit):  # serve is ported (tests/test_torch_serve.py): a missing index exits
        _run(tcli, CPU + ["serve", "--index", str(tmp_path / "nothing")])
    with pytest.raises(SystemExit):
        _run(tcli, CPU + ["query", "w001", "--index", str(tmp_path / "nothing")])
    if not torch.cuda.is_available():  # the card is the default: the CPU must be asked for
        with pytest.raises(trag.InvalidConfigError, match="no CUDA device"):
            _run(tcli, ["query", "w001", "--index", corpus["port"]])


def test_module_entry_point_runs_without_jax(corpus):
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['cli', '--device', 'cpu', 'query', 'w001', '--index', {corpus['port']!r}]\n"
        "try:\n"
        "    runpy.run_module('trueno_rag_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'trueno_rag_tpu.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("1. [")


def test_port_and_smoke_name_neither_jax_nor_the_jax_package():
    banned = re.compile(r"^\s*(import jax|from jax|import trueno_rag_tpu\b(?!_torch)|from trueno_rag_tpu\b(?!_torch))",
                        re.M)
    files = sorted((ROOT / "trueno_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if banned.search(p.read_text())]
    assert not offenders, offenders
