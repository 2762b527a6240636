"""Import BERT-family Hugging Face checkpoints into the port's encoder.

PyTorch counterpart of ``trueno_rag_tpu/models/hf_import.py``. MiniLM
(all-MiniLM-L6/L12-v2), BGE (bge-small/base-en-v1.5) and friends are
BERT-architecture encoders; this module maps a local checkpoint directory
(``config.json`` + ``model.safetensors`` or ``pytorch_model.bin`` +
``vocab.txt``) onto :mod:`~trueno_rag_tpu_torch.models.encoder`'s
parameters, for real embeddings from local weights (no download).

The conversion is the JAX package's, array for array:

- Linear weights are ``[out, in]`` and are transposed;
- Q/K/V concatenate into the fused ``qkv_w [hidden, 3*hidden]``;
- ``token_type_embeddings[0]`` folds into the word embeddings (retrieval
  encodes single segments, so every position is type 0);
- ``pad_token_id`` must be 0, since the encoder masks on token id 0;
- a rotary checkpoint (RoFormer, nomic-bert) has no position table.

The converted arrays are the JAX package's f32 layer-stacked layout;
:func:`_port_params` gives the port's per-layer dict on the device, the
matrices in bf16 at the bf16 compute dtype and in f32 otherwise.
``model.safetensors`` is read by the port's own reader
(``persist.load_params``: F32/F16/integer tensors, as ``safetensors.numpy``
gives the JAX loader), ``pytorch_model.bin`` by
``torch.load(weights_only=True)``; neither ``safetensors`` nor
``transformers`` is imported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import SerializationError
from trueno_rag_tpu_torch.models.encoder import MATRICES, EncoderConfig, EncoderEmbedder
from trueno_rag_tpu_torch.models.tokenization import WordPieceTokenizer


def _load_hf_state(model_dir: str) -> Dict[str, np.ndarray]:
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        from trueno_rag_tpu_torch.persist import load_params

        return load_params(st_path)[0]
    pt_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt_path):
        state = torch.load(pt_path, map_location="cpu", weights_only=True)
        # bf16 has no numpy dtype: widen it (exactly) to f32
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in state.items()}
    raise SerializationError(f"no model.safetensors or pytorch_model.bin in {model_dir}")


def _read_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def convert_bert_state(
    state: Dict[str, np.ndarray], num_layers: int, position: str = "learned"
) -> Dict[str, np.ndarray]:
    """HF BERT-family state dict → layer-stacked encoder params (f32, the
    JAX package's layout). ``position="rotary"`` skips the absolute
    position table (RoFormer checkpoints have none)."""

    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert.", "model.", "roformer."):
            key = prefix + name
            if key in state:
                return np.asarray(state[key], dtype=np.float32)
        raise SerializationError(f"missing HF weight: {name}")

    tok = get("embeddings.word_embeddings.weight")
    if any(k.endswith("embeddings.token_type_embeddings.weight") for k in state):
        tok = tok + get("embeddings.token_type_embeddings.weight")[0][None, :]

    def stack(fmt: str, transpose: bool = False) -> np.ndarray:
        mats = [get(fmt.format(i)) for i in range(num_layers)]
        return np.stack([m.T for m in mats] if transpose else mats)

    attn = "encoder.layer.{}.attention.self."
    out = {
        "tok_emb": tok,
        "emb_ln_scale": get("embeddings.LayerNorm.weight"),
        "emb_ln_bias": get("embeddings.LayerNorm.bias"),
        "qkv_w": np.concatenate([stack(attn + p + ".weight", transpose=True)
                                 for p in ("query", "key", "value")], axis=2),  # [L, H, 3H]
        "qkv_b": np.concatenate([stack(attn + p + ".bias") for p in ("query", "key", "value")], axis=1),
        "attn_out_w": stack("encoder.layer.{}.attention.output.dense.weight", transpose=True),
        "attn_out_b": stack("encoder.layer.{}.attention.output.dense.bias"),
        "ln1_scale": stack("encoder.layer.{}.attention.output.LayerNorm.weight"),
        "ln1_bias": stack("encoder.layer.{}.attention.output.LayerNorm.bias"),
        "mlp_w1": stack("encoder.layer.{}.intermediate.dense.weight", transpose=True),
        "mlp_b1": stack("encoder.layer.{}.intermediate.dense.bias"),
        "mlp_w2": stack("encoder.layer.{}.output.dense.weight", transpose=True),
        "mlp_b2": stack("encoder.layer.{}.output.dense.bias"),
        "ln2_scale": stack("encoder.layer.{}.output.LayerNorm.weight"),
        "ln2_bias": stack("encoder.layer.{}.output.LayerNorm.bias"),
    }
    if position == "learned":
        out["pos_emb"] = get("embeddings.position_embeddings.weight")
    return out


def convert_nomic_state(state: Dict[str, np.ndarray], num_layers: int) -> Dict[str, np.ndarray]:
    """nomic-bert-2048-family state dict (``encoder.layers.{i}.attn.Wqkv``,
    ``mlp.fc11``/``fc12`` SwiGLU naming) → layer-stacked encoder params.

    Gate order as in the JAX package: flash-attn's ``GatedMlp`` activates
    the SECOND chunk of ``fc1(x)``, so fc11 is the linear up-projection and
    fc12 the activated gate, and the encoder's ``[gate | up]`` packing is
    ``mlp_w1 = [fc12ᵀ | fc11ᵀ]``. Missing biases are zeros."""

    def get(name: str, required: bool = True):
        for prefix in ("", "model.", "bert."):
            if prefix + name in state:
                return np.asarray(state[prefix + name], dtype=np.float32)
        if required:
            raise SerializationError(f"missing HF weight: {name}")
        return None

    h = get("embeddings.word_embeddings.weight").shape[1]

    def stack(fmt, transpose=False, default_shape=None):
        mats = []
        for i in range(num_layers):
            m = get(fmt.format(i), required=default_shape is None)
            if m is None:
                m = np.zeros(default_shape, np.float32)
            mats.append(m.T if transpose else m)
        return np.stack(mats)

    tok = get("embeddings.word_embeddings.weight")
    tte = get("embeddings.token_type_embeddings.weight", required=False)
    if tte is not None:
        tok = tok + tte[0][None, :]
    layer = "encoder.layers.{}."
    mlp_w1 = np.concatenate([stack(layer + "mlp.fc12.weight", transpose=True),
                             stack(layer + "mlp.fc11.weight", transpose=True)], axis=2)  # [L, H, 2M]
    m = mlp_w1.shape[2] // 2
    return {
        "tok_emb": tok,
        "emb_ln_scale": get("emb_ln.weight"),
        "emb_ln_bias": get("emb_ln.bias"),
        "qkv_w": stack(layer + "attn.Wqkv.weight", transpose=True),
        "qkv_b": stack(layer + "attn.Wqkv.bias", default_shape=(3 * h,)),
        "attn_out_w": stack(layer + "attn.out_proj.weight", transpose=True),
        "attn_out_b": stack(layer + "attn.out_proj.bias", default_shape=(h,)),
        "ln1_scale": stack(layer + "norm1.weight"),
        "ln1_bias": stack(layer + "norm1.bias"),
        "mlp_w1": mlp_w1,
        "mlp_b1": np.concatenate([stack(layer + "mlp.fc12.bias", default_shape=(m,)),
                                  stack(layer + "mlp.fc11.bias", default_shape=(m,))], axis=1),
        "mlp_w2": stack(layer + "mlp.fc2.weight", transpose=True),
        "mlp_b2": stack(layer + "mlp.fc2.bias", default_shape=(h,)),
        "ln2_scale": stack(layer + "norm2.weight"),
        "ln2_bias": stack(layer + "norm2.bias"),
    }


def _port_params(conv: Dict[str, np.ndarray], config: EncoderConfig, device) -> Dict[str, Any]:
    """Converted f32 arrays → the port's parameters on ``device``: the
    matrices in bf16 at the bf16 compute dtype (the values the JAX trunk
    casts to at each use), f32 otherwise."""
    from trueno_rag_tpu_torch.convert import _layered
    from trueno_rag_tpu_torch.models.encoder import LAYER_KEYS

    matrices = MATRICES if config.compute_dtype == torch.bfloat16 else ()
    return _layered(conv, LAYER_KEYS, matrices, device)


def _encoder_config(hf_cfg: Dict[str, Any], max_len: int, compute_dtype, **kw) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_dim=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        mlp_dim=hf_cfg["intermediate_size"],
        max_len=min(max_len, hf_cfg.get("max_position_embeddings", max_len)),
        compute_dtype=compute_dtype if compute_dtype is not None else torch.bfloat16,
        **kw,
    )


def _embedder(model_dir: str, hf_cfg, config: EncoderConfig, conv, embedding_config, device) -> EncoderEmbedder:
    device = resolve_device(device)
    name = hf_cfg.get("_name_or_path") or os.path.basename(os.path.normpath(model_dir))
    emb = EncoderEmbedder(config=config, params=_port_params(conv, config, device), model_name=name,
                          embedding_config=embedding_config, device=device)
    vocab_path = os.path.join(model_dir, "vocab.txt")
    if os.path.exists(vocab_path):
        emb.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path, max_len=emb.encoder_config.max_len)
    return emb


def load_hf_rotary_encoder(
    model_dir: str,
    pooling: str = "mean",
    normalize: bool = True,
    max_len: int = 256,
    compute_dtype: Any = None,
    embedding_config=None,
    device=None,
) -> EncoderEmbedder:
    """An :class:`EncoderEmbedder` on ``device`` (default: the card) from a
    local ROTARY encoder checkpoint: ``roformer`` (rotary q/k, GELU MLP,
    even/odd interleaved pairs) or ``nomic_bert`` (rotary, SwiGLU,
    split-half pairs)."""
    hf_cfg = _read_config(model_dir)
    model_type = hf_cfg.get("model_type", "roformer")
    if model_type not in ("roformer", "nomic_bert"):
        raise SerializationError(f"load_hf_rotary_encoder expects roformer/nomic_bert, got {model_type!r}")
    if hf_cfg.get("pad_token_id", 0) != 0:
        raise SerializationError("encoder requires pad_token_id == 0")
    is_nomic = model_type == "nomic_bert"
    # nomic's intermediate_size is the per-branch SwiGLU width: mlp_dim here
    config = _encoder_config(
        hf_cfg, max_len, compute_dtype, pooling=pooling, normalize=normalize, position="rotary",
        rope_base=float(hf_cfg.get("rotary_emb_base", 10000.0)), rope_interleaved=not is_nomic,
        mlp="swiglu" if is_nomic else "gelu",
    )
    state = _load_hf_state(model_dir)
    conv = (convert_nomic_state(state, config.num_layers) if is_nomic
            else convert_bert_state(state, config.num_layers, position="rotary"))
    return _embedder(model_dir, hf_cfg, config, conv, embedding_config, device)


def load_hf_cross_encoder(
    model_dir: str,
    max_len: int = 256,
    compute_dtype: Any = None,
    device=None,
):
    """A :class:`~trueno_rag_tpu_torch.models.cross_encoder.CrossEncoderReranker`
    on ``device`` (default: the card) from a local HF
    ``BertForSequenceClassification`` checkpoint (the ms-marco MiniLM
    rerankers' architecture): the BERT trunk as in
    :func:`load_hf_bert_encoder`, HF's pooler (dense + tanh on the CLS
    state) and the single-logit classifier as the f32 score head."""
    from trueno_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker

    hf_cfg = _read_config(model_dir)
    config = _encoder_config(hf_cfg, max_len, compute_dtype, pooling="cls", normalize=False)
    state = _load_hf_state(model_dir)
    conv = convert_bert_state(state, config.num_layers)

    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert."):
            if prefix + name in state:
                return np.asarray(state[prefix + name], dtype=np.float32)
        raise SerializationError(f"missing HF weight: {name}")

    clf_w = get("classifier.weight")  # [num_labels, H]
    if clf_w.shape[0] != 1:
        raise SerializationError(
            f"cross-encoder import expects a single-logit classifier, got {clf_w.shape[0]} labels")
    conv.update({
        "pooler_w": get("pooler.dense.weight").T, "pooler_b": get("pooler.dense.bias"),
        "score_w": clf_w.T, "score_b": get("classifier.bias"),  # [H, 1], [1]
    })
    device = resolve_device(device)
    reranker = CrossEncoderReranker(config=config, params=_port_params(conv, config, device),
                                    max_len=config.max_len, device=device)
    vocab_path = os.path.join(model_dir, "vocab.txt")
    if os.path.exists(vocab_path):
        reranker.tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path, max_len=config.max_len)
    reranker.has_pooler = True
    return reranker


def load_hf_bert_encoder(
    model_dir: str,
    pooling: str = "mean",
    normalize: bool = True,
    max_len: int = 256,
    compute_dtype: Any = None,
    embedding_config=None,
    device=None,
) -> EncoderEmbedder:
    """An :class:`EncoderEmbedder` on ``device`` (default: the card) from a
    local HF BERT-family checkpoint."""
    hf_cfg = _read_config(model_dir)
    if hf_cfg.get("pad_token_id", 0) != 0:
        raise SerializationError("encoder requires pad_token_id == 0")
    config = _encoder_config(hf_cfg, max_len, compute_dtype, pooling=pooling, normalize=normalize)
    conv = convert_bert_state(_load_hf_state(model_dir), config.num_layers)
    return _embedder(model_dir, hf_cfg, config, conv, embedding_config, device)
