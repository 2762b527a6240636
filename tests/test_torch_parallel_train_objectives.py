"""The port's sharded MaxSim, SPLADE and distillation steps against the JAX
package's GSPMD steps (a ``(data, model)`` = (4, 2) mesh: the conftest's
virtual CPU devices for JAX, ``[cpu] * 8`` for the port), from one JAX
state carried across by ``convert.train_state_from_jax(..., mesh=...)``,
f32 compute in both: each step's loss within rel 1e-5 and the parameters
after two steps under ``test_torch_train.assert_params_close``, the ``data``
replicas bit-identical. The SPLADE head ties its projection to the
vocabulary-sharded ``tok_emb``, so its activation dots, norms and FLOPS
terms are sums over ``model``; its metrics are checked too. ``fit`` and the
checkpoint take a sharded state.
"""

import functools
import random

import jax
import numpy as np
import pytest

from test_torch_parallel_train import assert_replicas_identical, jax_sharded_step, meshes
from test_torch_train import (
    CFG,
    JCFG,
    OBJECTIVES,
    _inputs,
    _step_kw,
    assert_params_close,
    assert_trees_equal,
    chunks_both,
    states,
)
from trueno_rag_tpu_torch import convert
from trueno_rag_tpu_torch.models.encoder import HashTokenizer
from trueno_rag_tpu_torch.parallel import mesh as pmesh
from trueno_rag_tpu_torch.train import checkpoint as pck, contrastive as pc, loop as pl


@pytest.mark.parametrize("name", ["maxsim", "splade", "splade-cosine", "distill-dense-kl", "distill-dense-margin",
                                  "distill-splade"])
def test_sharded_steps_match_jax(name):
    kind, _, _, jstep, pstep, kw = OBJECTIVES[name]
    kw = _step_kw(name, kw)
    jm, pm = meshes(4, 2)
    js, tx, _, ptx = states(kind)
    ps = convert.train_state_from_jax(js, "cpu", mesh=pm)
    jfn = jax.jit(functools.partial(jstep, tx=tx, config=JCFG, **kw))
    for i in range(2):
        args = _inputs(name, seed=i)
        js, jmet = jax_sharded_step(jfn, js, jm, args)
        ps, pmet = pstep(ps, *pmesh.shard_batch(args, pm), ptx, CFG, **kw)
        for key, v in jmet.items():
            np.testing.assert_allclose(float(pmet[key]), float(v), rtol=1e-5, atol=1e-6, err_msg=f"{key} {i}")
    assert ps.step == int(js.step) == 2
    assert_params_close(ps.params, js.params, CFG.hidden_dim)
    assert_replicas_identical(ps.params)
    assert_replicas_identical(ps.opt_state.mu)


def test_fit_and_checkpoint_take_a_sharded_state(tmp_path):
    """``fit`` on a (4, 2)-sharded state logs the unsharded run's losses and
    evaluations; its best state saves as the gathered one and loads back
    on one device, or onto the mesh of a sharded template."""
    _, pch = chunks_both()
    _, _, ps, ptx = states()
    _, pm = meshes(4, 2)
    sharded = pc.TrainState(pmesh.shard_params(ps.params, pm), ps.opt_state, ps.step)
    common = dict(steps=2, batch_size=8, eval_every=1, eval_queries=6, k=5, select_metric="mrr", seed=1)
    logs = {}
    for label, st in (("one", ps), ("sharded", sharded)):
        logs[label] = []
        r = pl.fit(st, ptx, CFG, HashTokenizer(64, 16), pch, log=logs[label].append,
                   checkpoint_dir=str(tmp_path / label), **common)
        logs[label + "-result"] = r
    losses = [[float(x.split("loss=")[1].split()[0]) for x in logs[k] if "loss=" in x] for k in ("one", "sharded")]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    one, sh = logs["one-result"], logs["sharded-result"]
    assert [h["step"] for h in sh.history] == [h["step"] for h in one.history]
    assert isinstance(sh.state.params, pmesh.ShardedParams) and sh.best_step == one.best_step
    back = pck.load_train_state(sh.best_checkpoint, device="cpu")
    assert_trees_equal(back.params, pmesh.gather_params(sh.state.params))
    placed = pck.load_train_state(sh.best_checkpoint, template=sh.state)
    assert isinstance(placed.params, pmesh.ShardedParams) and placed.params.mesh is pm
    assert_trees_equal(pmesh.gather_params(placed.opt_state.nu), pmesh.gather_params(sh.state.opt_state.nu))


def test_sharded_state_steps_after_a_sharded_ict_batch():
    """The PairBatcher's numpy batches go to a sharded step as they are
    (split over ``data`` inside) and as ``shard_batch`` values alike."""
    from trueno_rag_tpu_torch.train.data import PairBatcher, ict_pairs

    _, pch = chunks_both()
    _, _, ps, ptx = states()
    _, pm = meshes(2, 2)
    st = pc.TrainState(pmesh.shard_params(ps.params, pm), ps.opt_state, ps.step)
    q, d = next(PairBatcher(HashTokenizer(64, 16), batch_size=8, max_len=16).batches(ict_pairs(pch, random.Random(0))))
    a, ma = pc.train_step(st, q, d, ptx, CFG)
    b, mb = pc.train_step(st, *pmesh.shard_batch((q, d), pm), ptx, CFG)
    assert float(ma["loss"]) == float(mb["loss"])
    assert_trees_equal(pmesh.gather_params(a.params), pmesh.gather_params(b.params))
