"""The SPLADE-class model and retriever against the JAX package, on the JAX
package's weights carried across by ``convert.splade_params_from_jax``
(and back by ``params_to_jax``):

- the head against the JAX head and the float64 oracle (rel 2e-5);
- activations at ``compute_dtype=float32`` in both packages within 1e-5
  of each row's largest activation; at the default bf16 within 2⁻⁶ of it
  (the two frameworks round the bf16 trunk differently: ~0.4-0.9%
  measured), the top-T term sets equal wherever the T-th and (T+1)-th
  weights are more than twice that apart (at bf16 only T = 1-4 clear it
  on random weights; at f32 T = 32 and 128);
- ``splade_topt``'s order, padding and ties against ``lax.top_k``'s;
- ``params_fingerprint`` equal in both packages on the same weights, both
  ways, and different on other weights;
- ``SpladeRetriever`` (f32 trunk) and its tag filters against the JAX
  retriever: the same chunks, scores within rel 1e-4 (the candidate tail's
  f32 prefix sums);
- ``splade_index.trag`` written by either package and loaded by the other,
  answers equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trueno_rag_tpu import persist as jp
from trueno_rag_tpu.chunking import Chunk as JChunk
from trueno_rag_tpu.models import splade as js
from trueno_rag_tpu.models.encoder import EncoderConfig as JConfig
from trueno_rag_tpu.retrieve import TagFilter as JTag

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import persist as tp
from trueno_rag_tpu_torch.chunking import Chunk as TChunk
from trueno_rag_tpu_torch.convert import params_to_jax, splade_params_from_jax
from trueno_rag_tpu_torch.models import splade as ts
from trueno_rag_tpu_torch.models.encoder import _RESERVED
from trueno_rag_tpu_torch.models.encoder import EncoderConfig as TConfig
from trueno_rag_tpu_torch.retrieve import TagFilter as TTag

BF16_TOL = 2.0 ** -6
WORDS = [f"w{i:03d}" for i in range(400)]


def _texts(seed, n, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def _pair(seed=0, f32=False, **kw):
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    je = js.SpladeEncoder(config=jcfg, seed=seed, **kw)
    te = ts.SpladeEncoder(config=tcfg, params=splade_params_from_jax(je.params, "cpu"), device="cpu", **kw)
    return je, te


def test_head_matches_jax_and_oracle():
    je, te = _pair(seed=1)
    rng = np.random.default_rng(0)
    states = rng.standard_normal((3, 7, te.config.hidden_dim)).astype(np.float32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False
    got = ts.splade_head(te.params, torch.from_numpy(states), torch.from_numpy(mask)).numpy()
    want = np.asarray(js.splade_head(je.params, jnp.asarray(states), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ts.splade_head_oracle(te.params, states, mask), rtol=2e-5, atol=2e-5)
    assert (got >= 0).all() and (got[:, :_RESERVED] == 0).all()


def test_activations_f32_and_bf16_against_jax():
    texts = _texts(2, 48)
    for f32 in (False, True):
        je, te = _pair(seed=2, f32=f32, max_len=64)
        ids = je.tokenizer.encode_batch(texts)
        assert np.array_equal(ids, te.tokenizer.encode_batch(texts))
        want = np.asarray(js.splade_activations(je.params, jnp.asarray(ids), je.config))
        got = ts.splade_activations(te.params, torch.from_numpy(ids), te.config).numpy()
        rowmax = want.max(axis=1, keepdims=True)
        tol = 1e-5 if f32 else BF16_TOL
        assert (np.abs(got - want) <= tol * rowmax).all(), (f32, (np.abs(got - want) / rowmax).max())
        # padding columns are inert: a wider pad gives the same activations
        wide = np.pad(ids, ((0, 0), (0, 16)))
        np.testing.assert_array_equal(ts.splade_activations(te.params, torch.from_numpy(wide), te.config).numpy(),
                                      got)
        srt = -np.sort(-want, axis=1)
        n_clear = 0
        for top in ((32, te.doc_top) if f32 else (1, 2, 4)):  # at bf16 only the first gaps clear 2·tol
            jt = np.asarray(js.splade_topt(jnp.asarray(want), top)[0])
            tt = ts.splade_topt(torch.from_numpy(got), top)[0].numpy()
            clear = (srt[:, top - 1] - srt[:, top]) > 2 * tol * rowmax[:, 0]
            n_clear += int(clear.sum())
            for i in np.flatnonzero(clear):
                assert set(tt[i][tt[i] >= 0]) == set(jt[i][jt[i] >= 0]), (f32, top, i)
        assert n_clear >= (len(texts) if f32 else 10), n_clear
    tt, tw = te.expand_documents(texts)  # f32 trunk: the encoders' own expansions
    jt, jw = je.expand_documents(texts)
    same = (tt == jt).all(axis=1)
    assert same.mean() >= 0.9
    np.testing.assert_allclose(tw[same], jw[same], rtol=1e-5, atol=1e-6)


def test_topt_contract_and_ties():
    acts = np.array([[0.0, 0.5, 0.0, 2.0, 0.0, 0.5, 0.1]], np.float32)
    for t in (4, 9):
        tt, tw = ts.splade_topt(torch.from_numpy(acts), t)
        jt, jw = js.splade_topt(jnp.asarray(acts), t)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tt[0, :5].tolist() == [3, 1, 5, 6, -1]  # the tie 1/5 in term order


def test_params_fingerprint_both_ways():
    je, te = _pair(seed=3)
    assert te.params_fingerprint() == je.params_fingerprint()
    own = ts.SpladeEncoder(seed=5, device="cpu")
    back = js.SpladeEncoder(params={k: jnp.asarray(v) for k, v in params_to_jax(own.params).items()})
    assert back.params_fingerprint() == own.params_fingerprint()
    assert own.params_fingerprint() != te.params_fingerprint()
    assert own.seed == 5 and te.seed is None
    with pytest.raises(trag.InvalidConfigError):
        ts.SpladeEncoder(params={"tok_emb": torch.zeros(3, 3)}, device="cpu")


def _corpus(n=120):
    texts = _texts(4, n, 6, 30)
    return ([JChunk(document_id=f"d{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
             for i, t in enumerate(texts)],
            [TChunk(document_id=f"d{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
             for i, t in enumerate(texts)])


def _retrievers(seed=6):
    jr = js.SpladeRetriever(config=dataclasses.replace(JConfig.tiny(), compute_dtype=jnp.float32), seed=seed,
                            max_len=64, doc_top=32, query_top=12)
    tr = ts.SpladeRetriever(config=dataclasses.replace(TConfig.tiny(), compute_dtype=torch.float32),
                            params=splade_params_from_jax(jr.params, "cpu"), max_len=64, doc_top=32,
                            query_top=12, device="cpu")
    jc, tc = _corpus()
    jr.index_batch(jc, encode_batch=32)
    tr.index_batch(tc, encode_batch=32)
    for i in range(len(jc)):
        for r, c in ((jr, jc[i]), (tr, tc[i])):
            r.registry.set_tags(c.id, ["even" if i % 2 == 0 else "odd"] + (["x"] if i % 3 == 0 else []))
    return jr, tr


def _same_hits(a, b):
    assert [r.chunk.id for r in a] == [r.chunk.id for r in b]
    np.testing.assert_allclose([r.sparse_score for r in a], [r.sparse_score for r in b], rtol=1e-4)


QUERIES = [" ".join(t.split()[:4]) for t in _texts(4, 120, 6, 30)[::15]] + ["w001 w002 w003", "nothing here"]


def test_retriever_and_filters_match_jax():
    jr, tr = _retrievers()
    assert tr.index_store.state_dict()["row_terms"] == jr.index_store.state_dict()["row_terms"]
    got, want = tr.retrieve_batch(QUERIES, 6), jr.retrieve_batch(QUERIES, 6)
    assert sum(len(x) for x in got) > 20
    for a, b in zip(got, want):
        _same_hits(a, b)
    for tf in ((TTag(all=("even",)), JTag(all=("even",))), (TTag(any=("x",), none=("odd",)),
                                                             JTag(any=("x",), none=("odd",)))):
        for a, b in zip(tr.retrieve_batch(QUERIES, 6, tag_filter=tf[0]),
                        jr.retrieve_batch(QUERIES, 6, tag_filter=tf[1])):
            _same_hits(a, b)
    per = [TTag(all=("odd",)) if i % 2 else None for i in range(len(QUERIES))]
    for q, a, f in zip(QUERIES, tr.retrieve_batch(QUERIES, 6, tag_filter=per), per):
        assert [r.chunk.id for r in a] == [r.chunk.id for r in tr.retrieve(q, 6, tag_filter=f)]
        if f is not None:
            assert all(int(r.chunk.id[1:]) % 2 == 1 for r in a)
    assert tr.retrieve_batch([], 3) == [] and tr.retrieve_batch(["w001"], 0) == [[]]
    assert tr.remove("c0") and not tr.remove("c0") and len(tr) == len(jr) - 1


def test_splade_artifacts_load_in_either_package(tmp_path):
    jr, tr = _retrievers(seed=7)
    cfg_t = dataclasses.replace(TConfig.tiny(), compute_dtype=torch.float32)
    cfg_j = dataclasses.replace(JConfig.tiny(), compute_dtype=jnp.float32)
    j_path, t_path = str(tmp_path / "j.trag"), str(tmp_path / "t.trag")
    jp.save_splade_index(j_path, jr)
    stats = tp.save_splade_index(t_path, tr)
    assert stats["chunks"] == len(tr) and stats["postings"] == sum(len(x) for x in tr.index_store._row_terms.values())
    t_from_j = tp.load_splade_index(j_path, encoder_config=cfg_t, params=tr.params, device="cpu")
    j_from_t = jp.load_splade_index(t_path, encoder_config=cfg_j,
                                    params={k: jnp.asarray(v) for k, v in params_to_jax(tr.params).items()})
    assert t_from_j.index_store.state_dict() == jr.index_store.state_dict()
    assert j_from_t.index_store.state_dict() == tr.index_store.state_dict()
    f = TTag(all=("even",))
    for a, b in zip(t_from_j.retrieve_batch(QUERIES, 5), jr.retrieve_batch(QUERIES, 5)):
        _same_hits(a, b)
    for a, b in zip(j_from_t.retrieve_batch(QUERIES, 5, tag_filter=JTag(all=("even",))),
                    tr.retrieve_batch(QUERIES, 5, tag_filter=f)):
        _same_hits(a, b)
    with open(t_path, "rb") as fh:
        (tmp_path / "bad.trag").write_bytes(fh.read()[:7] + b"zlib\0" + b"x" * 64)
    with pytest.raises(trag.SerializationError):
        tp.load_splade_index(str(tmp_path / "bad.trag"), device="cpu")
    with pytest.raises(trag.IndexNotFoundError):
        tp.load_splade_index(str(tmp_path / "none.trag"), device="cpu")
