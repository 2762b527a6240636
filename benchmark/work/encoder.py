"""Operations of the query encoder (a BERT encoder, post-LN), counted for
the tokens the batch needs: padding rows and padding positions are left
out, though the port computes them.

Per layer and sequence of L tokens (hidden H, MLP width M):
- the four weight products, 2 FLOPs a multiply-add:
  2·L·(H·3H + H·H + H·M + M·H) = 2·L·(4H² + 2HM);
- attention over the L real keys: logits 2·L·L·H and the weighted sum of
  values 2·L·L·H, so 4·L²·H.
Norms, softmax, GELU and embedding lookups are O(L·H) and left out.
At MiniLM-L6 widths (H 384, M 1,536, 6 layers) a token costs 21.2 MFLOP
in the products, so a batch of 32 queries of 10 tokens is 6.8 GFLOP and
256 of them 54 GFLOP.
"""


def flops(lengths, cfg: dict) -> float:
    """FLOPs of one forward over sequences of ``lengths`` real tokens."""
    h, m, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    per_token = 2 * (4 * h * h + 2 * h * m)
    return float(layers * sum(per_token * n + 4 * n * n * h for n in lengths))
