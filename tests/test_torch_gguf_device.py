"""The port's device k-quant module (``models/gguf_device.py``) against the
JAX package's on the CPU:

- ``quantize_kquant_host`` (and its slabbed thread-pool form) gives the
  JAX encoder's bytes exactly;
- ``q4k_dequant``/``q6k_dequant`` give the JAX device dequant's values bit
  for bit (f32 and bf16) and the port's host decoder's (``models/gguf``)
  bit for bit;
- ``nemotron_forward_quantized`` on ``NemotronConfig.tiny()`` (T 16 on the
  naive attention, T 512 on K4's plain version) against the JAX function
  and against the port's bf16 forward on the host-dequantized copies of
  the same blocks: cosine > 0.999 per row (``tests/test_gguf.py``'s rule;
  both sides run bf16 products);
- the quantized stack takes the bytes of its blocks, and a layer's bf16
  matrices exist only inside its step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trueno_rag_tpu.models import gguf_device as jg
from trueno_rag_tpu.models.nemotron import NemotronConfig as JCfg, init_nemotron_params as j_init
from trueno_rag_tpu_torch.models import gguf as pgguf, gguf_device as pg
from trueno_rag_tpu_torch.models.nemotron import NemotronConfig, nemotron_forward

KINDS = [("q4_k", 12), ("q6_k", 14)]


def values(seed, n_blocks, scale=0.05):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n_blocks * 256) * scale).astype(np.float32)
    v[256:512] = np.abs(v[256:512])  # a block with no negative values
    return v


@pytest.mark.parametrize("kind,ggml_type", KINDS)
def test_quantizer_bytes_identical(kind, ggml_type, monkeypatch):
    v = values(1, 40)
    want = jg.quantize_kquant_host(v, kind)
    np.testing.assert_array_equal(pg.quantize_kquant_host(v, kind), want)
    monkeypatch.setattr(pg, "_SLAB_BLOCKS", 7)  # several slabs in the thread pool
    np.testing.assert_array_equal(pg.quantize_kquant_parallel(v, kind), want)
    with pytest.raises(ValueError):
        pg.quantize_kquant_host(v[:100], kind)


def test_quantizer_rejects_other_kinds():
    with pytest.raises(ValueError):
        pg.quantize_kquant_host(np.zeros(256, np.float32), "q5_k")


@pytest.mark.parametrize("kind,ggml_type", KINDS)
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_dequant_bit_equal_to_jax_and_host_decoder(kind, ggml_type, dtypes, monkeypatch):
    monkeypatch.setattr(pg, "_SLAB_BLOCKS", 16)  # several slabs in the thread pool
    raw = jg.quantize_kquant_host(values(2, 48, scale=1.0), kind)
    got = pg.dequant_matrix(torch.from_numpy(raw), (48 * 16, 16), kind, dtype=dtypes[0])
    assert got.dtype == dtypes[0] and got.shape == (768, 16)
    want = np.asarray(jg.dequant_matrix(jnp.asarray(raw), (768, 16), kind, dtype=dtypes[1]).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    host = pgguf._dequantize_kquant(raw.reshape(-1), ggml_type, raw.shape[0] * 256)
    np.testing.assert_array_equal(pg.dequantize_kquant_host(raw, kind), host)
    if dtypes[0] == torch.float32:
        np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint32), host.view(np.uint32))


def _params(seed=0):
    cfg = JCfg.tiny()
    return cfg, {k: np.asarray(v) for k, v in j_init(jax.random.PRNGKey(seed), cfg).items()}


@pytest.mark.parametrize("t,impl", [(16, "auto"), (512, "auto"), (64, "block")])
def test_quantized_forward_matches_jax_and_dequantized_weights(t, impl):
    jcfg, params = _params()
    cfg = NemotronConfig(**{**NemotronConfig.tiny().__dict__, "max_len": 1024, "attention_impl": impl})
    qp = pg.quantize_nemotron_params(params, device="cpu")
    jqp = jg.quantize_nemotron_params(params)
    for name, (shape, kind) in qp["shapes"].items():
        assert jqp["shapes"][name] == (shape, kind)
        for i, layer in enumerate(qp["layers"]):
            np.testing.assert_array_equal(layer[name].numpy(), np.asarray(jqp[name][i]))
    rng = np.random.default_rng(t)
    ids = rng.integers(3, jcfg.vocab_size, (3, t)).astype(np.int32)
    ids[1, t // 2:] = 0  # a padded row
    got = pg.nemotron_forward_quantized(qp, torch.from_numpy(ids), cfg).numpy()
    jcfg_t = JCfg(**{**jcfg.__dict__, "max_len": 1024})
    want = np.asarray(jg.nemotron_forward_quantized(jqp, jnp.asarray(ids), jcfg_t))
    ref = nemotron_forward(pg.dequantize_nemotron_params(qp), torch.from_numpy(ids), cfg).numpy()
    for other in (want, ref):
        cos = (got * other).sum(axis=1)
        assert (cos > 0.999).all(), cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_port_layout_quantizes_as_the_jax_layout():
    from trueno_rag_tpu_torch.models.nemotron import init_nemotron_params

    cfg = NemotronConfig.tiny()
    params = init_nemotron_params(cfg, torch.Generator().manual_seed(0), "cpu")
    qp = pg.quantize_nemotron_params(params, device="cpu")
    from trueno_rag_tpu_torch.convert import params_to_jax

    flat = params_to_jax(params)
    qj = jg.quantize_nemotron_params(flat)
    for name in pg.WEIGHT_KINDS:
        for i, layer in enumerate(qp["layers"]):
            np.testing.assert_array_equal(layer[name].numpy(), np.asarray(qj[name][i]))
    assert qp["tok_emb"].dtype == torch.bfloat16 and qp["layers"][0]["qkv_w"].dtype == torch.uint8


def test_stack_bytes_and_layer_streaming(monkeypatch):
    _, params = _params(1)
    cfg = NemotronConfig.tiny()
    qp = pg.quantize_nemotron_params(params, device="cpu")
    h, m = cfg.hidden_dim, cfg.mlp_dim
    q4 = (h * 3 * h + h * h + 2 * h * m) // 256 * 144
    q6 = m * h // 256 * 210
    assert sum(layer[n].numel() for layer in qp["layers"] for n in pg.WEIGHT_KINDS) == cfg.num_layers * (q4 + q6)
    seen = []
    real = pg.dequant_matrix

    def spy(raw, shape, kind, dtype=torch.bfloat16):
        seen.append((shape, kind, dtype))
        return real(raw, shape, kind, dtype)

    monkeypatch.setattr(pg, "dequant_matrix", spy)
    pg.nemotron_forward_quantized(qp, torch.full((2, 8), 5), cfg)
    assert len(seen) == cfg.num_layers * len(pg.WEIGHT_KINDS)
    assert all(d == torch.bfloat16 for _, _, d in seen)
