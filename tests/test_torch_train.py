"""The port's training (``trueno_rag_tpu_torch.train``) against the JAX
package's ``train/``, on the CPU, starting from the same state carried
across by ``convert.train_state_from_jax`` (f32 params, the AdamW moments
and count):

- ICT and crop pairs and ``PairBatcher`` batches identical for one seed;
  ``build_ict_evalset`` identical;
- loss and gradients of every objective (pooled, MaxSim, SPLADE, dense and
  SPLADE distillation) at ``compute_dtype=float32`` in both packages: loss
  within rel 1e-5, every gradient within 1e-4 of its tensor's largest
  entry (f32 sums in two frameworks' orders); each step's loss within rel
  1e-5 or 1e-6 absolute (f32 cross-entropy over logits of magnitude up to
  1/temperature = 20, near a loss of 0.01); the parameters, ``mu`` and
  ``nu`` after 3 steps: parameters within 5e-4·lr (99.5%) and 1e-2·lr
  (all but the key biases), moments within 1e-4 of the largest, and
  the count and step equal (``assert_params_close`` says why a few
  parameters are looser);
- at the default bf16 compute dtype the loss within 2e-2 (the two
  frameworks round the bf16 trunk differently, tests/test_torch_splade.py);
- ``remat=True`` gives the same loss and gradients as ``remat=False``,
  bit for bit;
- a short ``fit`` logs the JAX package's losses step by step (rel 1e-4)
  and the same evaluation history;
- the checkpoint round trip holds exactly and a resumed state takes the
  next step bit for bit as the uninterrupted one.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trueno_rag_tpu.chunking import Chunk as JChunk, ChunkMetadata as JMeta
from trueno_rag_tpu.models.encoder import EncoderConfig as JCfg, HashTokenizer as JTok
from trueno_rag_tpu.train import contrastive as jc, data as jd, distill as jdi, loop as jl
from trueno_rag_tpu_torch import convert
from trueno_rag_tpu_torch.chunking import Chunk, ChunkMetadata
from trueno_rag_tpu_torch.errors import InvalidConfigError, QueryError, SerializationError
from trueno_rag_tpu_torch.models.encoder import EncoderConfig, HashTokenizer
from trueno_rag_tpu_torch.train import checkpoint as pck, contrastive as pc, data as pd, distill as pdi, loop as pl

JCFG = JCfg(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64, max_len=16,
            compute_dtype=jnp.float32)
LR = 1e-3


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(EncoderConfig)
              if f.name not in ("compute_dtype",)}
    dt = torch.float32 if jcfg.compute_dtype == jnp.float32 else torch.bfloat16
    return EncoderConfig(**{**fields, "compute_dtype": dt, **kw})


CFG = port_cfg(JCFG)
TEXTS = [f"Subject {i} alpha fact describes the {i} widget. Subject {i} beta fact measures the "
         f"{i} gadget. Subject {i} gamma fact closes it." for i in range(10)]


def chunks_both():
    j = [JChunk(document_id="d", content=t, start_offset=0, end_offset=len(t), metadata=JMeta(), id=f"c{i}")
         for i, t in enumerate(TEXTS)]
    p = [Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t), metadata=ChunkMetadata(), id=f"c{i}")
         for i, t in enumerate(TEXTS)]
    return j, p


def states(kind="encoder", jcfg=JCFG, seed=0):
    js, tx = jc.create_train_state(jax.random.PRNGKey(seed), jcfg, learning_rate=LR, kind=kind)
    ps = convert.train_state_from_jax(js, "cpu")
    return js, tx, ps, pc.create_optimizer(LR)


def batch(seed=0, b=8, t=16, vocab=64):
    rng = np.random.default_rng(seed)
    q = rng.integers(3, vocab, (b, t), dtype=np.int32)
    q[:, t - 3:] = 0  # padded tails
    d = q.copy()
    d[:, 6:9] = rng.integers(3, vocab, (b, 3), dtype=np.int32)
    return q, d


def slates(seed=0, b=4, c=3, t=16):
    rng = np.random.default_rng(seed)
    q = rng.integers(3, 64, (b, t), dtype=np.int32)
    cand = rng.integers(3, 64, (b, c, t), dtype=np.int32)
    cand[..., 12:] = 0
    teacher = rng.standard_normal((b, c)).astype(np.float32)
    return q, cand, teacher


def assert_tree_close(port_tree, jax_tree, rel, label, atol=0.0):
    """Every array within ``rel`` of its largest entry, or ``atol``."""
    flat = convert.params_to_jax(port_tree)
    assert sorted(flat) == sorted(jax_tree), label
    for k, v in flat.items():
        want = np.asarray(jax_tree[k], np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(v, want, rtol=0, atol=max(rel * scale, atol), err_msg=f"{label}: {k}")


def assert_params_close(port_params, jax_params, h):
    """Parameters after Adam steps: every element within 1e-2·lr, 99.5% of
    them within 5e-4·lr. Adam divides each gradient by its own magnitude,
    so where a gradient is near its rounding noise the two frameworks'
    steps differ by more; the key biases (``qkv_b[:, h:2h]``) are left out:
    a key bias adds one constant to a query's logits, which the softmax
    cancels, so its gradient is rounding noise and Adam's ``g/|g|`` decides
    its step in each framework independently."""
    flat = convert.params_to_jax(port_params)
    want = jax.tree.map(np.asarray, jax_params)
    close = total = 0
    for k, v in flat.items():
        w = want[k]
        if k == "qkv_b":
            v, w = np.delete(v, np.s_[h:2 * h], axis=1), np.delete(w, np.s_[h:2 * h], axis=1)
        diff = np.abs(v - w)
        assert diff.max() <= 1e-2 * LR, (k, diff.max())
        close += int((diff <= 5e-4 * LR).sum())
        total += diff.size
    assert close >= 0.995 * total, (close, total)


def assert_trees_equal(a, b):
    fa, fb = convert.params_to_jax(a), convert.params_to_jax(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# -- pairs and batches --------------------------------------------------------


def test_pairs_and_batches_identical():
    jch, pch = chunks_both()
    for jfn, pfn in ((jd.ict_pairs, pd.ict_pairs), (jd.crop_pairs, pd.crop_pairs)):
        ja, pa = jfn(jch, random.Random(5)), pfn(pch, random.Random(5))
        assert [next(ja) for _ in range(40)] == [next(pa) for _ in range(40)]
    jb = jd.PairBatcher(JTok(64, 16), batch_size=6, max_len=16).batches(jd.ict_pairs(jch, random.Random(2)))
    pb = pd.PairBatcher(HashTokenizer(64, 16), batch_size=6, max_len=16).batches(pd.ict_pairs(pch, random.Random(2)))
    for _ in range(4):
        (jq, jdd), (pq, pdd) = next(jb), next(pb)
        np.testing.assert_array_equal(jq, pq)
        np.testing.assert_array_equal(jdd, pdd)
    je, pe = jl.build_ict_evalset(jch, 6, seed=3), pl.build_ict_evalset(pch, 6, seed=3)
    assert (je.queries, je.relevant) == (pe.queries, pe.relevant)


def test_pair_streams_raise_on_ineligible_corpus():
    short = [Chunk(document_id="d", content="one", start_offset=0, end_offset=3, metadata=ChunkMetadata(), id="x")]
    with pytest.raises(InvalidConfigError):
        next(pd.ict_pairs(short, random.Random(0)))
    with pytest.raises(InvalidConfigError):
        next(pd.crop_pairs(short, random.Random(0)))


# -- losses, gradients, steps ------------------------------------------------

OBJECTIVES = {
    "pooled": ("encoder", jc.contrastive_loss, pc.contrastive_loss, jc.train_step, pc.train_step, {}),
    "maxsim": ("encoder", jc.maxsim_contrastive_loss, pc.maxsim_contrastive_loss, jc.maxsim_train_step,
               pc.maxsim_train_step, {}),
    "splade": ("splade", jc.splade_contrastive_loss, pc.splade_contrastive_loss, jc.splade_train_step,
               pc.splade_train_step, {}),
    "splade-cosine": ("splade", jc.splade_contrastive_loss, pc.splade_contrastive_loss, jc.splade_train_step,
                      pc.splade_train_step, {"score_norm": "cosine", "temperature": 0.05}),
    "distill-dense-kl": ("encoder", jdi.dense_distill_loss, pdi.dense_distill_loss, jdi.distill_step,
                         pdi.distill_step, {"objective": "kl"}),
    "distill-dense-margin": ("encoder", jdi.dense_distill_loss, pdi.dense_distill_loss, jdi.distill_step,
                             pdi.distill_step, {"objective": "margin_mse"}),
    "distill-splade": ("splade", jdi.splade_distill_loss, pdi.splade_distill_loss, jdi.distill_step,
                       pdi.distill_step, {"objective": "kl"}),
}


def _inputs(name, seed=0):
    if name.startswith("distill"):
        return slates(seed)
    return batch(seed)


def _step_kw(name, kw):
    if name == "distill-splade":
        return {**kw, "student": "splade", "temperature_s": 1.0}
    return kw


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_loss_and_gradients_match_jax(name):
    kind, jloss, ploss, _, _, kw = OBJECTIVES[name]
    js, _, ps, _ = states(kind)
    args = _inputs(name)
    jargs = [jnp.asarray(a) for a in args]
    (jl_, jm), jg = jax.value_and_grad(lambda p: jloss(p, *jargs, JCFG, **kw), has_aux=True)(js.params)
    pl_, pm, pg = pc.loss_and_grads(ploss, ps.params, *args, CFG, **kw)
    np.testing.assert_allclose(float(pl_), float(jl_), rtol=1e-5)
    for key, v in jm.items():
        np.testing.assert_allclose(float(pm[key]), float(v), rtol=1e-4, atol=1e-6, err_msg=key)
    assert_tree_close(pg, jax.tree.map(np.asarray, jg), 1e-4, "grads")


@pytest.mark.parametrize("name", ["pooled", "maxsim", "splade", "distill-dense-kl", "distill-splade"])
def test_three_steps_match_jax(name):
    kind, _, _, jstep, pstep, kw = OBJECTIVES[name]
    js, tx, ps, ptx = states(kind)
    kw = _step_kw(name, kw)
    jfn = jax.jit(functools.partial(jstep, tx=tx, config=JCFG, **kw))
    for i in range(3):
        args = _inputs(name, seed=i)
        js, jm = jfn(js, *[jnp.asarray(a) for a in args])
        ps, pm = pstep(ps, *args, ptx, CFG, **kw)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
    assert ps.step == int(js.step) == 3
    adam = js.opt_state[0]
    assert ps.opt_state.count == int(adam.count) == 3
    assert_params_close(ps.params, js.params, CFG.hidden_dim)
    assert_tree_close(ps.opt_state.mu, jax.tree.map(np.asarray, adam.mu), 1e-4, "mu")
    assert_tree_close(ps.opt_state.nu, jax.tree.map(np.asarray, adam.nu), 1e-4, "nu")


def test_adamw_is_optax_order():
    """Five optax updates against the port's on the same grads: within
    1e-6·lr (XLA's CPU code fuses the moment updates into FMAs, which a
    torch op sequence does not)."""
    import optax

    rng = np.random.default_rng(4)
    p = {"tok_emb": rng.standard_normal((5, 3)).astype(np.float32)}
    tx = optax.adamw(1e-3, weight_decay=0.01)
    ptx = pc.create_optimizer(1e-3)
    jstate, pstate = tx.init(p), ptx.init({"tok_emb": torch.from_numpy(p["tok_emb"])})
    jp_, pp = p, {"tok_emb": torch.from_numpy(p["tok_emb"])}
    upd = jax.jit(tx.update)
    for i in range(5):
        g = rng.standard_normal((5, 3)).astype(np.float32) * 10.0 ** -i
        u, jstate = upd({"tok_emb": jnp.asarray(g)}, jstate, jp_)
        jp_ = optax.apply_updates(jp_, u)
        pu, pstate = ptx.update({"tok_emb": torch.from_numpy(g)}, pstate, pp)
        np.testing.assert_allclose(pu["tok_emb"].numpy(), np.asarray(u["tok_emb"]), rtol=0, atol=1e-9)
        pp = pc.apply_updates(pp, pu)
    np.testing.assert_allclose(pp["tok_emb"].numpy(), np.asarray(jp_["tok_emb"]), rtol=0, atol=5e-9)
    assert pstate.count == int(jstate[0].count) == 5


def test_bf16_compute_loss_close_to_jax():
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    js, _, ps, _ = states(jcfg=jcfg)
    q, d = batch()
    jloss, _ = jc.contrastive_loss(js.params, jnp.asarray(q), jnp.asarray(d), jcfg)
    ploss, _ = pc.contrastive_loss(ps.params, q, d, port_cfg(jcfg))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("name", ["pooled", "maxsim", "splade"])
def test_remat_equals_no_remat(name):
    kind, _, ploss, _, _, kw = OBJECTIVES[name]
    _, _, ps, _ = states(kind)
    q, d = batch(1)
    a = pc.loss_and_grads(ploss, ps.params, q, d, CFG, **kw)
    b = pc.loss_and_grads(ploss, ps.params, q, d, dataclasses.replace(CFG, remat=True), **kw)
    assert float(a[0]) == float(b[0])
    for x, y in zip(pc.tree_leaves(a[2]), pc.tree_leaves(b[2])):
        assert torch.equal(x, y)


def test_errors():
    with pytest.raises(InvalidConfigError):
        pc.create_train_state(torch.Generator().manual_seed(0), CFG, kind="bogus", device="cpu")
    _, _, ps, ptx = states()
    q, cand, teacher = slates()
    with pytest.raises(InvalidConfigError):
        pdi.distill_step(ps, q, cand, teacher, ptx, CFG, student="bogus")
    with pytest.raises(InvalidConfigError):
        pdi.distill_objective(torch.zeros(2, 3), teacher[:2], "bogus")
    with pytest.raises(InvalidConfigError):
        pdi.distill_objective(torch.zeros(2, 1), teacher[:2, :1], "margin_mse")
    with pytest.raises(InvalidConfigError):
        pc.splade_contrastive_loss(ps.params, *batch(), CFG, score_norm="bogus")
    with pytest.raises(QueryError):
        pdi.teacher_slate_scores(None, ["a"], [])
    with pytest.raises(QueryError):
        pdi.teacher_slate_scores(None, ["a", "b"], [["x"], ["y", "z"]])


def test_distill_objective_and_teacher_scores_match_jax():
    rng = np.random.default_rng(9)
    s, t = rng.standard_normal((6, 4)).astype(np.float32), rng.standard_normal((6, 4)).astype(np.float32)
    for obj in ("kl", "margin_mse"):
        jl_, jm = jdi.distill_objective(jnp.asarray(s), jnp.asarray(t), obj)
        pl_, pm = pdi.distill_objective(torch.from_numpy(s), t, obj)
        np.testing.assert_allclose(float(pl_), float(jl_), rtol=1e-5)
        assert float(pm["agreement"]) == float(jm["agreement"])

    class Teacher:
        def score_batch(self, q, contents):
            return np.array([len(q) + len(c) for c in contents], np.float32)

    got = pdi.teacher_slate_scores(Teacher(), ["ab", "c"], [["x", "yy"], ["zzz", ""]])
    np.testing.assert_array_equal(got, jdi.teacher_slate_scores(Teacher(), ["ab", "c"], [["x", "yy"], ["zzz", ""]]))


# -- fit, evaluation, checkpoint ---------------------------------------------


@pytest.mark.parametrize("objective", ["pooled", "maxsim", "splade"])
def test_fit_matches_jax_step_by_step(objective):
    jch, pch = chunks_both()
    kind = "splade" if objective == "splade" else "encoder"
    js, tx, ps, ptx = states(kind)
    jlog, plog = [], []
    common = dict(steps=3, batch_size=6, eval_every=1, eval_queries=6, k=5, select_metric="mrr",
                  objective=objective, seed=1)
    jr = jl.fit(js, tx, JCFG, JTok(64, 16), jch, log=jlog.append, **common)
    pr = pl.fit(ps, ptx, CFG, HashTokenizer(64, 16), pch, log=plog.append, **common)
    jl_ = [float(x.split("loss=")[1].split()[0]) for x in jlog if "loss=" in x]
    pl_ = [float(x.split("loss=")[1].split()[0]) for x in plog if "loss=" in x]
    assert len(pl_) == 3
    np.testing.assert_allclose(pl_, jl_, rtol=1e-4, atol=1e-4)
    assert [h["step"] for h in pr.history] == [h["step"] for h in jr.history]
    for hj, hp in zip(jr.history, pr.history):
        assert sorted(hj) == sorted(hp)
        for key in hj:
            np.testing.assert_allclose(hp[key], hj[key], atol=1e-6, err_msg=key)
    assert (pr.best_step, pr.best_metric) == (jr.best_step, pytest.approx(jr.best_metric))


def test_fit_rejects_bad_arguments():
    _, pch = chunks_both()
    _, _, ps, ptx = states()
    tok = HashTokenizer(64, 16)
    for kw in ({"objective": "bogus"}, {"pair_kind": "bogus"}, {"objective": "splade"},
               {"select_metric": "bogus", "steps": 0}):
        with pytest.raises(InvalidConfigError):
            pl.fit(ps, ptx, CFG, tok, pch, **kw)
    with pytest.raises(InvalidConfigError):
        pl.evaluate_retrieval(ps.params, CFG, tok, [], pl.EvalSet(["q"], [[0]]))
    with pytest.raises(InvalidConfigError):
        pl.evaluate_retrieval(ps.params, CFG, tok, TEXTS, pl.EvalSet(["q"], [[0]]), mode="bogus")


def test_checkpoint_round_trip_and_resume(tmp_path):
    _, _, ps, ptx = states()
    for i in range(2):
        ps, _ = pc.train_step(ps, *batch(i), ptx, CFG)
    pck.save_train_state(str(tmp_path / "ck"), ps)
    back = pck.load_train_state(str(tmp_path / "ck"), device="cpu")
    assert (back.step, back.opt_state.count) == (ps.step, ps.opt_state.count) == (2, 2)
    for a, b in ((ps.params, back.params), (ps.opt_state.mu, back.opt_state.mu), (ps.opt_state.nu, back.opt_state.nu)):
        assert_trees_equal(a, b)
    cont, _ = pc.train_step(ps, *batch(7), ptx, CFG)
    resumed, _ = pc.train_step(back, *batch(7), ptx, CFG)
    assert_trees_equal(cont.params, resumed.params)
    assert_trees_equal(cont.opt_state.nu, resumed.opt_state.nu)
    with pytest.raises(SerializationError):
        pck.load_train_state(str(tmp_path / "nothing"), device="cpu")


def test_fit_saves_the_best_state(tmp_path):
    _, pch = chunks_both()
    _, _, ps, ptx = states()
    r = pl.fit(ps, ptx, CFG, HashTokenizer(64, 16), pch, steps=2, batch_size=6, eval_every=1, eval_queries=6,
               k=5, select_metric="mrr", checkpoint_dir=str(tmp_path))
    back = pck.load_train_state(r.best_checkpoint, template=r.state)
    assert back.step == r.best_step == r.state.step
    assert_trees_equal(r.state.params, back.params)


def test_create_train_state_from_given_params():
    from trueno_rag_tpu_torch.models.encoder import EncoderEmbedder

    emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
    st, tx = pc.create_train_state(None, emb.encoder_config, params=emb.params, device="cpu")
    assert all(t.dtype == torch.float32 for t in pc.tree_leaves(st.params))
    assert torch.equal(st.params["layers"][0]["qkv_w"], emb.params["layers"][0]["qkv_w"].float())
    st2, _ = pc.train_step(st, *batch(vocab=EncoderConfig.tiny().vocab_size), tx, emb.encoder_config)
    assert st2.step == 1 and not torch.equal(st2.params["tok_emb"], st.params["tok_emb"])
