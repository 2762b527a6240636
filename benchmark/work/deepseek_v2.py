"""Work of DeepSeek-V2-Lite's forward as a query embedder, counted for the
real tokens (padding positions and padding rows are left out, though the
port computes the dense products for them), 2 FLOPs a multiply-add.

Per real token, hidden H, heads n, latent r, widths nope/rope/v:
- attention products (every layer): q ``H·n·(nope+rope)``, kv_a
  ``H·(r+rope)``, kv_b ``r·n·(nope+v)``, o ``n·v·H``; at the published
  widths 27.5 MFLOP a layer;
- attention over a sequence of L real tokens (every layer):
  ``2·L²·n·((nope+rope) + v)``, the logits and the weighted values;
- the dense SwiGLU (the first ``first_k_dense_replace`` layers):
  ``3·H·I``, 134.5 MFLOP;
- a MoE layer: the router ``H·E``, the shared experts ``3·H·(s·M)`` and,
  for each expert, ``3·H·M`` per token it computed (top-k per token):
  138.7 MFLOP a token, 103.8 of them routed.

At the published widths a token costs 4.48 GFLOP without the L² terms.
Norms, RoPE, softmaxes, the sort and the combine are O(H) a token and left
out. Bytes: the weights a layer reads once, in bf16.
"""

from benchmark.work import peaks

BF16 = 2


def attention_products(cfg: dict) -> int:
    """Multiply-adds of one token's q, kv_a, kv_b and o products."""
    h, n, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return h * n * (nope + rope) + h * (r + rope) + r * n * (nope + v) + n * v * h


def attention_flops(lengths, cfg: dict) -> float:
    """One layer's attention over sequences of ``lengths`` real tokens."""
    n, qk, v = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return float(sum(2 * attention_products(cfg) * L + 2 * L * L * n * (qk + v) for L in lengths))


def attention_bytes(cfg: dict) -> float:
    return float(BF16 * attention_products(cfg))


def dense_mlp_flops(tokens: int, cfg: dict) -> float:
    return 2.0 * 3 * cfg["hidden_size"] * cfg["intermediate_size"] * tokens


def _moe_parts(cfg: dict):
    h, e, m = cfg["hidden_size"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    return h * e + 3 * h * cfg["n_shared_experts"] * m, 3 * h * m  # per token; per (token, expert) pair


def moe_flops(tokens: int, expert_tokens, cfg: dict) -> float:
    """One MoE layer: the router and shared experts for ``tokens`` real
    tokens, each routed expert for the tokens it computed (``expert_tokens``,
    one count per expert)."""
    per_token, per_pair = _moe_parts(cfg)
    return 2.0 * (per_token * tokens + per_pair * sum(expert_tokens))


def moe_bytes(cfg: dict) -> float:
    """Every expert's weights, the shared experts' and the router's, read once."""
    per_token, per_pair = _moe_parts(cfg)
    return float(BF16 * (per_token + per_pair * cfg["n_routed_experts"]))


def per_token_flops(cfg: dict) -> float:
    """A real token's FLOPs through the whole trunk, without the L² terms
    (the routed experts at top-k)."""
    per_token, per_pair = _moe_parts(cfg)
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    return 2.0 * (cfg["num_hidden_layers"] * attention_products(cfg)
                  + dense * 3 * cfg["hidden_size"] * cfg["intermediate_size"]
                  + moe * (per_token + per_pair * cfg["num_experts_per_tok"]))


def model_flops(lengths, cfg: dict) -> float:
    """One forward over sequences of ``lengths`` real tokens."""
    n, qk, v = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    quad = cfg["num_hidden_layers"] * sum(2 * L * L * n * (qk + v) for L in lengths)
    return per_token_flops(cfg) * sum(lengths) + float(quad)


def moe_least_seconds(shapes: dict, cfg: dict) -> float:
    """The least time of a batch's MoE layers (``shapes["expert_tokens"]``,
    one row per MoE layer), each bound by its operations or its weights."""
    tokens = sum(shapes["lengths"])
    return sum(peaks.least_seconds(moe_flops(tokens, row, cfg), moe_bytes(cfg))[0]
               for row in shapes["expert_tokens"])


def attention_least_seconds(shapes: dict, cfg: dict) -> float:
    """The least time of a batch's attention sublayers, every layer."""
    one = peaks.least_seconds(attention_flops(shapes["lengths"], cfg), attention_bytes(cfg))[0]
    return cfg["num_hidden_layers"] * one
