"""Everything a run feeds the system, made from ``--seed``.

The same seed gives the same texts, queries, weights and corpus rows, and
both sides (the port and the plain reference) receive the same ones. Rows
and weights are drawn on the run's device by ``torch.Generator`` in a few
large calls; the reference draws the corpus rows again slab by slab with
the same generator, so it never reads anything the port holds.
"""

from __future__ import annotations

import numpy as np
import torch

# streams of one seed: each draw has its own generator
STREAM_WEIGHTS, STREAM_ROWS, STREAM_DOC_WORDS, STREAM_QUERIES, STREAM_SAMPLE = range(5)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    state = np.random.SeedSequence([seed % (1 << 63), stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & ((1 << 63) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, stream))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


# -- the word law -----------------------------------------------------------


def zipf_cdf(vocab: int, s: float, skip: int = 0) -> np.ndarray:
    """Cumulative probabilities of ranks ``skip..vocab-1`` under Zipf(s)
    (P(rank r) ∝ 1 / (r + 1)^s), in float64."""
    p = 1.0 / np.arange(skip + 1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(p)
    return cdf / cdf[-1]


def word_table(vocab: int) -> np.ndarray:
    """``[vocab, 7]`` uint8: each word's six bytes and a trailing space."""
    if vocab > 100_000:
        raise ValueError("words are six bytes: at most 100,000 of them")
    return np.frombuffer("".join(f"w{i:05d} " for i in range(vocab)).encode(), np.uint8).reshape(vocab, 7)


def sample_ranks(cdf: np.ndarray, shape, gen: torch.Generator, device, skip: int = 0) -> np.ndarray:
    """Ranks drawn by the inverse of ``cdf`` on ``device`` → int64 numpy."""
    u = torch.rand(int(np.prod(shape)), generator=gen, device=device, dtype=torch.float64)
    cdf_t = torch.from_numpy(cdf).to(device)
    idx = torch.clamp(torch.searchsorted(cdf_t, u, right=True), max=cdf.shape[0] - 1)
    return (idx + skip).reshape(shape).cpu().numpy()


def doc_texts(law: dict, n: int, words: int, seed: int, device, slab: int = 1 << 16):
    """``n`` texts of ``words`` Zipf-drawn words each."""
    table = word_table(law["vocab"])
    cdf = zipf_cdf(law["vocab"], law["zipf_s"])
    gen = generator(seed, STREAM_DOC_WORDS, device)
    width = 7 * words - 1
    texts = []
    for lo in range(0, n, slab):
        ids = sample_ranks(cdf, (min(slab, n - lo), words), gen, device)
        raw = table[ids].reshape(len(ids), 7 * words)[:, :width].tobytes()
        texts.extend(raw[i:i + width].decode() for i in range(0, len(raw), width))
    return texts


def query_batches(law: dict, traffic: dict, seed: int, device):
    """The traffic's pool of query batches. Every batch holds the same
    multiset of lengths (``query_words`` lo..hi cycled to the batch size),
    shuffled per batch, so each seed asks for the same amount of work;
    words are drawn from the document law without its ``query_skip_ranks``
    most frequent ranks (the stop words a query analyzer drops)."""
    lo, hi = traffic["query_words"]
    b, n_batches = traffic["batch"], traffic["pool_batches"]
    skip = traffic["query_skip_ranks"]
    table = word_table(law["vocab"])
    cdf = zipf_cdf(law["vocab"], law["zipf_s"], skip)
    r = rng(seed, STREAM_QUERIES)
    lengths = np.resize(np.arange(lo, hi + 1), b)
    ranks = sample_ranks(cdf, (n_batches, b, hi), generator(seed, STREAM_QUERIES, device), device, skip)
    pool = []
    for j in range(n_batches):
        lens = r.permutation(lengths)
        pool.append([table[ranks[j, i, :ln]].tobytes()[:-1].decode() for i, ln in enumerate(lens)])
    return pool


def chunk_tokens(cfg: dict) -> int:
    """Tokens of a corpus chunk: [CLS], its words, [SEP], cut to the token
    store's width."""
    return min(cfg["corpus"]["words"] + 2, cfg["chunk_tokens"])


# -- weights and corpus rows ------------------------------------------------


def encoder_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded encoder weights in the layout the port's ``params=`` takes:
    tables f32 ``N(0, 0.02²)``, matrices bf16 (drawn in f32, rounded
    once), biases ``N(0, 0.02²)`` and norm scales ``1 + N(0, 0.02²)`` in
    f32; three draws in all."""
    h, m, v, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    p = cfg["max_position_embeddings"]
    gen = generator(seed, STREAM_WEIGHTS, device)
    mats = [("qkv_w", (h, 3 * h)), ("attn_out_w", (h, h)), ("mlp_w1", (h, m)), ("mlp_w2", (m, h))]
    vecs = [("qkv_b", 3 * h, 0.0), ("attn_out_b", h, 0.0), ("ln1_scale", h, 1.0), ("ln1_bias", h, 0.0),
            ("mlp_b1", m, 0.0), ("mlp_b2", h, 0.0), ("ln2_scale", h, 1.0), ("ln2_bias", h, 0.0)]
    tables = torch.randn((v + p) * h, generator=gen, device=device).mul_(0.02)
    n_mat = sum(a * b for _, (a, b) in mats)
    mat_all = torch.randn(layers * n_mat, generator=gen, device=device).mul_(0.02).to(torch.bfloat16)
    n_vec = sum(n for _, n, _ in vecs)
    vec_all = torch.randn(layers * n_vec + 2 * h, generator=gen, device=device).mul_(0.02)
    params = {
        "tok_emb": tables[: v * h].view(v, h),
        "pos_emb": tables[v * h:].view(p, h),
        "emb_ln_scale": vec_all[:h] + 1.0,
        "emb_ln_bias": vec_all[h:2 * h].clone(),
        "layers": [],
    }
    mo, vo = 0, 2 * h
    for _ in range(layers):
        lp = {}
        for name, (a, b) in mats:
            lp[name] = mat_all[mo:mo + a * b].view(a, b)
            mo += a * b
        for name, n, base in vecs:
            lp[name] = vec_all[vo:vo + n] + base
            vo += n
        params["layers"].append(lp)
    return params


def unit_rows(n: int, shape, seed: int, device, slab: int):
    """Yield ``(lo, rows)``: ``n`` seeded rows of ``shape`` (``(d,)`` or
    ``(tokens, d)``), each vector scaled to unit length in f32, ``slab``
    rows per draw; the same arguments yield the same bits."""
    gen = generator(seed, STREAM_ROWS, device)
    for lo in range(0, n, slab):
        x = torch.randn((min(slab, n - lo),) + tuple(shape), generator=gen, device=device)
        x /= torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        yield lo, x


def host_rows(n: int, shape, seed: int, device, slab: int) -> np.ndarray:
    """:func:`unit_rows` gathered into one host f32 array."""
    out = np.empty((n,) + tuple(shape), np.float32)
    for lo, x in unit_rows(n, shape, seed, device, slab):
        torch.from_numpy(out[lo:lo + x.shape[0]]).copy_(x)
    return out
