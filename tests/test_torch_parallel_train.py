"""The port's sharded training (``parallel/mesh.py``'s training layouts,
``parallel/train.py``) against the JAX package's GSPMD steps, mirroring
``tests/test_parallel.py``'s training tests. The JAX side runs on the
conftest's eight virtual CPU devices, the port on a mesh of the CPU device
(``[cpu] * 8``); both start from one JAX state carried across by
``convert.train_state_from_jax(..., mesh=...)`` and compute in f32, and
the port's sharded parameters come back through ``convert.params_to_jax``
(which gathers them).

Tolerances: losses within rel 1e-5 of the JAX package's and the port's
unsharded loss (f32 sums in other orders; ``tests/test_parallel.py`` holds
the JAX package's own sharded loss to rtol 2e-3); gradients within 1e-4 of
their tensor's largest entry; parameters after a step under
``test_torch_train.assert_params_close``; the ``data`` replicas of every
leaf bit-identical. Shapes that do not divide over the mesh raise where the
JAX package's ``device_put`` raises, and run where it runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_train import LR, assert_params_close, assert_tree_close, port_cfg
from trueno_rag_tpu.models.encoder import EncoderConfig as JCfg
from trueno_rag_tpu.parallel import mesh as jmesh
from trueno_rag_tpu.train import contrastive as jc
from trueno_rag_tpu_torch import convert
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.parallel import mesh as pmesh
from trueno_rag_tpu_torch.train import contrastive as pc

# __graft_entry__.dryrun_multichip's training config, at f32 compute
DRY = JCfg(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_len=32,
           compute_dtype=jnp.float32)


def meshes(data, model):
    return (jmesh.create_mesh(data=data, model=model, devices=jax.devices()[:data * model]),
            pmesh.create_mesh(data=data, model=model, devices=[torch.device("cpu")] * (data * model)))


def jax_state(jcfg, kind="encoder", seed=0, perturb=False):
    """A JAX train state; ``perturb`` adds seeded noise to every leaf, so
    biases and norms are not their zero/one init."""
    js, tx = jc.create_train_state(jax.random.PRNGKey(seed), jcfg, learning_rate=LR, kind=kind)
    if perturb:
        rng = np.random.default_rng(seed + 100)
        params = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32) for k, v in js.params.items()}
        js = jc.TrainState(params, tx.init(params), js.step)
    return js, tx


def ids(seed, b, t, vocab):
    rng = np.random.default_rng(seed)
    q = rng.integers(3, vocab, (b, t), dtype=np.int32)
    q[:, t - 3:] = 0  # padded tails
    d = rng.integers(3, vocab, (b, t), dtype=np.int32)
    d[:, : t // 2] = q[:, : t // 2]
    return q, d


def jax_sharded_step(jfn, js, jm, args):
    """One JAX step ``jfn`` (jitted) on ``js`` placed as ``make dryrun``
    places it: params per ``encoder_param_specs``, the batch over ``data``,
    the optimizer state replicated (placed the same way at every step, so
    ``jfn`` compiles once)."""
    replicated = NamedSharding(jm, PartitionSpec())
    state = jc.TrainState(jmesh.shard_params(js.params, jm), jax.device_put(js.opt_state, replicated),
                          jax.device_put(js.step, replicated))
    sharded = jmesh.shard_batch(tuple(jnp.asarray(a) for a in args), jm)
    with jm:
        return jfn(state, *sharded)


def assert_replicas_identical(params):
    """Every ``data`` replica of every leaf bit-identical to row 0's."""
    for d, m, tree in params.replicas():
        for a, b in zip(pc.tree_leaves(tree), pc.tree_leaves(params.local[0][m])):
            assert torch.equal(a, b), (d, m)


def test_specs_cover_every_leaf_and_equal_jax():
    """``encoder_param_specs`` names JAX's axis for every leaf of the
    encoder and SPLADE trees (a layer leaf's spec is JAX's without its
    leading layer entry)."""
    jcfg = dataclasses.replace(DRY, mlp="swiglu", position="rotary")
    for kind in ("encoder", "splade"):
        js, _ = jax_state(jcfg, kind)
        ps = convert.train_state_from_jax(js, "cpu")
        jspecs = jmesh.encoder_param_specs(js.params)
        pspecs = pmesh.encoder_param_specs(ps.params)
        layer_keys = set(pspecs["layers"][0])
        assert {k for k in pspecs if k != "layers"} | layer_keys == set(js.params) == set(jspecs)
        assert len(pspecs["layers"]) == jcfg.num_layers and all(set(lp) == layer_keys for lp in pspecs["layers"])
        for k, spec in jspecs.items():
            if k in layer_keys:
                assert all(tuple(lp[k]) == tuple(spec)[1:] for lp in pspecs["layers"]), (kind, k, spec)
            else:
                assert tuple(pspecs[k]) == tuple(spec), (kind, k, spec)


def test_dp_tp_step_runs_moves_params_and_matches_jax():
    """``make dryrun``'s step: dp 4 × tp 2, batch 16 × 32, the port's
    sharded step against the JAX package's on the same weights and batch."""
    jm, pm = meshes(4, 2)
    js, tx = jax_state(DRY)
    ps = convert.train_state_from_jax(js, "cpu", mesh=pm)
    assert isinstance(ps.params, pmesh.ShardedParams) and isinstance(ps.opt_state.mu, pmesh.ShardedParams)
    q, d = ids(0, 16, 32, DRY.vocab_size)
    j_new, jmet = jax_sharded_step(jax.jit(functools.partial(jc.train_step, tx=tx, config=DRY)), js, jm, (q, d))
    p_new, pmet = pc.train_step(ps, *pmesh.shard_batch((q, d), pm), pc.create_optimizer(LR), port_cfg(DRY))
    assert np.isfinite(float(pmet["loss"])) and p_new.step == 1 and p_new.opt_state.count == 1
    np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pmet["accuracy"]), float(jmet["accuracy"]))
    before, after = convert.params_to_jax(ps.params), convert.params_to_jax(p_new.params)
    assert sum(float(np.abs(after[k] - before[k]).sum()) for k in after) > 0.0
    assert_params_close(p_new.params, j_new.params, DRY.hidden_dim)
    assert_replicas_identical(p_new.params)
    assert_replicas_identical(p_new.opt_state.nu)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_loss_equals_unsharded(shape):
    jcfg = dataclasses.replace(DRY, vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32, max_len=8)
    js, _ = jax_state(jcfg)
    q, d = ids(1, 8, 8, 64)
    j_loss, _ = jax.jit(functools.partial(jc.contrastive_loss, config=jcfg))(js.params, jnp.asarray(q),
                                                                             jnp.asarray(d))
    ps = convert.train_state_from_jax(js, "cpu")
    cfg = port_cfg(jcfg)
    p_loss, _ = pc.contrastive_loss(ps.params, q, d, cfg)
    _, pm = meshes(*shape)
    s_loss, _ = pc.contrastive_loss(pmesh.shard_params(ps.params, pm), *pmesh.shard_batch((q, d), pm), cfg)
    np.testing.assert_allclose(float(s_loss), float(p_loss), rtol=1e-5)
    np.testing.assert_allclose(float(s_loss), float(j_loss), rtol=2e-3)
    # a sharded batch with one device's parameters runs on that device
    u_loss, _ = pc.contrastive_loss(ps.params, *pmesh.shard_batch((q, d), pm), cfg)
    assert float(u_loss) == float(p_loss)


CONFIGS = {
    # learned positions, GELU: the default MiniLM form
    "gelu-learned": ((4, 2), {}),
    # SwiGLU's [gate|up] and rotary q/k: each shard's heads from q, k and v
    "swiglu-rotary": ((2, 4), {"mlp": "swiglu", "position": "rotary", "num_heads": 8}),
    # 2 heads over 4 model shards (H 36, 9 columns a shard): JAX runs it, so
    # the port gathers the heads a shard's columns meet
    "heads-straddle": ((2, 4), {"hidden_dim": 36, "num_heads": 2, "position": "rotary"}),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_loss_and_gradients_match_jax(name):
    """Every bias, norm and table perturbed from its init, so a bias added
    on every model shard, or a q|k|v or gate|up split cut in contiguous
    pieces, would show; the gradients of every leaf against JAX's."""
    shape, kw = CONFIGS[name]
    jcfg = dataclasses.replace(DRY, vocab_size=128, num_layers=1, max_len=16, **kw)
    js, _ = jax_state(jcfg, perturb=True)
    q, d = ids(2, 8, 16, 128)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jc.contrastive_loss(p, jnp.asarray(q), jnp.asarray(d), jcfg), has_aux=True)(js.params)
    _, pm = meshes(*shape)
    ps = convert.train_state_from_jax(js, "cpu", mesh=pm)
    cfg = port_cfg(jcfg)
    p_loss, _, p_grads = pc.loss_and_grads(pc.contrastive_loss, ps.params, *pmesh.shard_batch((q, d), pm), cfg)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    assert_tree_close(p_grads, jax.tree.map(np.asarray, j_grads), 1e-4, "grads")
    assert_replicas_identical(p_grads)
    # remat recomputes the same sharded program: the same loss and gradients, bit for bit
    r_loss, _, r_grads = pc.loss_and_grads(pc.contrastive_loss, ps.params, q, d,
                                           dataclasses.replace(cfg, remat=True))
    assert float(r_loss) == float(p_loss)
    for a, b in zip(pc.tree_leaves(convert.params_to_jax(p_grads)), pc.tree_leaves(convert.params_to_jax(r_grads))):
        assert np.array_equal(a, b)


def test_shapes_that_do_not_divide_raise_where_jax_raises():
    """30,522 vocabulary rows over 4 model shards is the real case; here 130
    over 4, an MLP of 66 over 4 and a batch of 6 over 4 ``data`` rows: the
    JAX package's ``device_put`` raises ValueError, the port
    InvalidConfigError."""
    jm, pm = meshes(2, 4)
    for kw in ({"vocab_size": 130}, {"mlp_dim": 66}, {"mlp_dim": 66, "mlp": "swiglu"}):
        jcfg = dataclasses.replace(DRY, **kw)
        js, _ = jax_state(jcfg)
        with pytest.raises(ValueError):
            jmesh.shard_params(js.params, jm)
        with pytest.raises(InvalidConfigError):
            convert.train_state_from_jax(js, "cpu", mesh=pm)
    jm, pm = meshes(4, 2)
    with pytest.raises(ValueError):
        jmesh.shard_batch((jnp.zeros((6, 4), jnp.int32),), jm)
    with pytest.raises(InvalidConfigError):
        pmesh.shard_batch((np.zeros((6, 4), np.int32),), pm)
