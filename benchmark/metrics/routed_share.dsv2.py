"""routed_share.dsv2 (%, program counter): the (token, expert) pairs the
routed experts computed in the measured window (the embedder's device
counter ``expert_tokens``) over top-k × MoE layers × the real tokens the
embedder routed in it (``routed_tokens``, counted from the host's ids).
It reads 100 when padding stays out of the experts and no pair is
dropped."""


def read(ctx):
    c, cfg = ctx.counters, ctx.cell.config
    if "expert_tokens" not in c["after"]:
        return None
    tokens = c["after"]["routed_tokens"] - c["before"]["routed_tokens"]
    pairs = sum(map(sum, c["after"]["expert_tokens"])) - sum(map(sum, c["before"]["expert_tokens"]))
    per_token = cfg["num_experts_per_tok"] * (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"])
    return 100.0 * pairs / (per_token * tokens) if tokens else None
