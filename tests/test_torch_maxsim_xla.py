"""The blockwise MaxSim tiers ``maxsim_topk_scan16`` and
``maxsim_topk_int8`` (the JAX package's "xla" tiers) against the JAX
functions on the same inputs, at several ``block``/``rescore``/``select``
settings, bf16 replica, zero-copy bf16 primary and int8 replica:

- the certified flags equal the JAX package's (the bounds are the same
  formulas over the same f32 products; any difference is f32 summation
  order, far below the certificate's slack on these tie-free inputs);
- every certified answer is the float64 exact top-k of the stored values
  rounded once (the port's exact scan), and equals the JAX rows, scores
  within 1e-5 (the JAX package rescores with an f32 einsum);
- the token store with ``scan_kernel="xla"`` answers as the JAX store does
  and as its own ``"fused"`` K6/K7 tiers do, through tag filters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from trueno_rag_tpu.ops import maxsim as jm
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import maxsim as pm
from test_torch_maxsim import T, _oracle64, build

SCORE_TOL = 1e-5


def _pack(name, tok, tm):
    """(port tier args, jax tier args, stored values) after the queries."""
    tokt, tmt = T(tok, tm)
    td, tmd = jnp.asarray(tok), jnp.asarray(tm)
    if name == "scan16":
        return (tokt, tmt, *pm.prepare_maxsim_scan16(tokt, tmt)), (td, tmd, *jm.prepare_maxsim_scan16(td, tmd)), tok
    if name == "self16":
        b16, j16 = tokt.to(torch.bfloat16), td.astype(jnp.bfloat16)
        return ((b16, tmt, b16, *pm.prepare_maxsim_self16(b16, tmt)),
                (j16, tmd, j16, *jm.prepare_maxsim_self16(j16, tmd)), b16.float().numpy())
    return (tokt, tmt, *pm.prepare_maxsim_int8(tokt, tmt)), (td, tmd, *jm.prepare_maxsim_int8(td, tmd)), tok


CASES = [(64, 24, "exact"), (100, 64, "exact"), (512, 64, "auto"), (37, 32, "approx")]


@pytest.mark.parametrize("name", ["scan16", "self16", "int8"])
@pytest.mark.parametrize("block,rescore,select", CASES)
@pytest.mark.parametrize("structured", [False, True], ids=["random", "structured"])
def test_blockwise_tier_matches_jax(name, block, rescore, select, structured):
    k = 8
    tok, tm, q, qm, valid = build(n=301, seed=31 + structured, structured=structured)
    port_args, jax_args, stored = _pack(name, tok, tm)
    qt, qmt, vt = T(q, qm, valid)
    fn, jfn = (pm.maxsim_topk_int8, jm.maxsim_topk_int8) if name == "int8" else (
        pm.maxsim_topk_scan16, jm.maxsim_topk_scan16)
    s, r, cert = (x.numpy() for x in fn(qt, qmt, *port_args, vt, k, rescore, block, select))
    js, jr, jcert = (np.asarray(x) for x in jfn(jnp.asarray(q), jnp.asarray(qm), *jax_args, jnp.asarray(valid),
                                                 k, rescore, block, select=select))
    np.testing.assert_array_equal(cert, jcert)
    assert cert.any()
    o_s, o_r = _oracle64(q, qm, stored, tm, valid, k)
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o_r[i])
        np.testing.assert_array_equal(s[i], o_s[i])
        np.testing.assert_array_equal(r[i], jr[i])
        fin = np.isfinite(js[i])
        np.testing.assert_allclose(s[i][fin], js[i][fin], atol=SCORE_TOL, rtol=SCORE_TOL)


def test_int8_dot_is_exact_past_f32_range(monkeypatch):
    """At H where an int8 dot could pass 2^24 the dot runs in float64; both
    product types give the same exact integers on these inputs."""
    assert pm._int_dot_dtype(1040) == torch.float32 and pm._int_dot_dtype(1041) == torch.float64
    tok, tm, q, qm, valid = build(n=120, h=64, seed=5)
    args = (*T(q, qm), *_pack("int8", tok, tm)[0], T(valid)[0], 5, 32, 50)
    want = [x.numpy() for x in pm.maxsim_topk_int8(*args)]
    monkeypatch.setattr(pm, "_int_dot_dtype", lambda h: torch.float64)
    got = [x.numpy() for x in pm.maxsim_topk_int8(*args)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rescore_below_k_is_rejected():
    tok, tm, q, qm, valid = build(n=50, seed=2)
    qt, qmt, vt = T(q, qm, valid)
    for name, fn in (("scan16", pm.maxsim_topk_scan16), ("int8", pm.maxsim_topk_int8)):
        with pytest.raises(InvalidConfigError):
            fn(qt, qmt, *_pack(name, tok, tm)[0], vt, 8, 4)


@pytest.mark.parametrize("storage,scan_dtype", [("float32", "bfloat16"), ("float32", "int8"),
                                                ("bfloat16", "bfloat16"), ("bfloat16", "int8")])
def test_store_xla_answers_as_jax_and_fused(storage, scan_dtype):
    import trueno_rag_tpu as jrag
    from trueno_rag_tpu.index.token_store import TokenStoreConfig as JConfig, TokenVectorStore as JStore

    import trueno_rag_tpu_torch as trag
    from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore

    h, lt, n = 64, 20, 300
    tok, tm, q, qm, _ = build(n=n, lt=lt, h=h, seed=11, structured=True)
    stores = {}
    for label, pkg, cfg_cls, store_cls, kw in (
            ("jax", jrag, JConfig, JStore, {}), ("xla", trag, TokenStoreConfig, TokenVectorStore, {"device": "cpu"}),
            ("fused", trag, TokenStoreConfig, TokenVectorStore, {"device": "cpu"})):
        cfg = cfg_cls(hidden_dim=h, max_tokens=lt, initial_capacity=n, storage_dtype=storage, scan="tiered",
                      scan_dtype=scan_dtype, scan_kernel="fused" if label == "fused" else "xla", rescore=48)
        st = store_cls(cfg, **kw)
        chunks = [pkg.Chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2,
                            metadata=pkg.ChunkMetadata(), id=pkg.chunk_id_from_int(i)) for i in range(n)]
        st.load_rows(chunks, tok, tm)
        stores[label] = st
    allowed = np.arange(n) % 4 != 1
    for allow in (None, allowed):
        want_s, want_r = stores["jax"].search_arrays(q, qm, 6, allowed_rows=allow)
        for label in ("xla", "fused"):
            s, r = stores[label].search_arrays(q, qm, 6, allowed_rows=allow)
            np.testing.assert_array_equal(r, want_r, err_msg=label)
            np.testing.assert_allclose(s, want_s, atol=SCORE_TOL, rtol=SCORE_TOL, err_msg=label)
    assert stores["xla"].uncertified == stores["jax"].uncertified


def test_ops_package_reexports_dense_topk():
    """``trueno_rag_tpu_torch.ops`` re-exports the dense top-k and the
    similarity scores, as ``trueno_rag_tpu.ops`` does."""
    from trueno_rag_tpu_torch import ops
    from trueno_rag_tpu_torch.ops import dense, dense_topk, similarity_scores

    assert dense_topk is dense.dense_topk and similarity_scores is dense.similarity_scores
    assert sorted(ops.__all__) == ["dense_topk", "similarity_scores"]
