"""K4: the plain PyTorch version of block_attention against the JAX
package's Pallas kernel (interpret mode) and its oracle, the wrapper's
checks and dispatch rule, and (on a card only) the CUDA kernel against the
plain version.

Tolerance, everywhere: each output element within 2^-7·max|V| of the
reference and the mean |difference| within 2^-12·max|V|. Both sides round
the softmax probabilities to bf16 and the output to bf16; f32 logits summed
in another order can flip one probability's bf16 rounding (2^-8 relative)
and the output's own rounding (2^-8 relative), which 2^-7·max|V| covers.

The kernel skips the causal future, so the masks here include rows with
no kept key at or before their position (left padding, kept keys only in
a row's future, all-PAD rows): every logit of such a row is -1e9, and its
output is the mean of V over all T keys, the future included.
"""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.kernels.attention import (
    attention_oracle,
    block_attention,
    block_attention_reference,
)

TOL_MAX = 2.0**-7
TOL_MEAN = 2.0**-12


def _inputs(bh, t, hd, seed, all_masked_row=True):
    """Seeded bf16-exact q, k, v [bh, t, hd] and a ragged key mask [bh, t]
    (right padding, as the tokenizer makes it), one row fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, t, hd)).astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v))
    lengths = rng.integers(1, t + 1, size=bh)
    mask = np.arange(t)[None, :] < lengths[:, None]
    if all_masked_row:
        mask[bh // 2] = False
    return q, k, v, mask


MASK_KINDS = ("right", "left", "future", "mixed")


def _mask(kind, rows, t, rng):
    """A key mask [rows, t]: "right" padding (kept keys first), "left"
    padding (kept keys last), "future" (kept keys only in a window
    [lo, hi), so the rows before lo see none), or "mixed" (a full row, then
    right-padded, left-padded, all-PAD and last-key-only rows, repeated)."""
    j = np.arange(t)[None, :]
    if kind == "right":
        return j < rng.integers(1, t + 1, size=rows)[:, None]
    if kind == "left":
        return j >= rng.integers(0, t, size=rows)[:, None]
    if kind == "future":
        lo = rng.integers(0, t, size=rows)
        hi = np.array([rng.integers(a + 1, t + 1) for a in lo])
        return (j >= lo[:, None]) & (j < hi[:, None])
    assert kind == "mixed"
    out = np.zeros((rows, t), bool)
    for r in range(rows):
        form = r % 5
        if form == 0:
            out[r] = True
        elif form == 1:
            out[r, :rng.integers(1, t + 1)] = True
        elif form == 2:
            out[r, rng.integers(0, t):] = True
        elif form == 4:
            out[r, t - 1] = True
    return out


def _check_bare_rows(out, v, mask, heads, causal):
    """Rows without a kept key at or before their position (without
    ``causal``: without any kept key) are the mean of V over all T keys
    (p = bf16(1/T) for every key) → their count."""
    out, v = np.asarray(out, np.float32), np.asarray(v, np.float32)
    mask = np.repeat(mask, heads, axis=0)  # [BH, T]
    if causal:
        bare = ~np.logical_or.accumulate(mask, axis=1)
    else:
        bare = np.broadcast_to(~mask.any(axis=1, keepdims=True), mask.shape)
    want = np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape)
    if bare.any():
        _close(out[bare], want[bare], v)
    return int(bare.sum())


def _torch(q, k, v, mask):
    return (*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), torch.from_numpy(mask))


def _close(got, want, v):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = float(np.abs(v).max())
    err = np.abs(got - want)
    assert err.max() <= TOL_MAX * scale, err.max()
    assert err.mean() <= TOL_MEAN * scale, err.mean()


def _jax_block(q, k, v, mask, causal):
    # JAX is imported here, not at module level: the card's machine runs
    # the cuda-marked tests below without JAX installed
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas.attention import block_attention as jax_block_attention

    bf = jnp.bfloat16
    out = jax_block_attention(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                              jnp.asarray(mask), causal=causal, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", [48, 128, 256])
def test_plain_version_matches_pallas_kernel(t, hd, causal):
    bh = 5  # not a multiple of the TPU's 8-row mask tile
    q, k, v, mask = _inputs(bh, t, hd, seed=t + hd)
    want = _jax_block(q, k, v, mask, causal)
    got = block_attention(*_torch(q, k, v, mask), causal=causal)  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (bh, t, hd)
    _close(got.float(), want, v)


def test_plain_versions_match_jax_oracle_at_ragged_t():
    """T = 528 is no multiple of 128, which the Pallas wrapper refuses;
    the port takes it, and agrees with the JAX package's oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas.attention import attention_oracle as jax_oracle

    q, k, v, mask = _inputs(3, 528, 16, seed=7)
    want = np.asarray(jax_oracle(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask)).astype(jnp.float32))
    tq = _torch(q, k, v, mask)
    _close(attention_oracle(*tq).float(), want, v)
    _close(block_attention(*tq).float(), want, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["left", "future", "mixed"])
@pytest.mark.parametrize("t", [128, 256])
def test_plain_version_matches_pallas_kernel_without_past_keys(t, kind, causal):
    """Left-padded rows, kept keys only in some rows' causal future, and a
    mixed batch with all-PAD rows: the plain version against the Pallas
    kernel, and the rows without a past kept key against the mean of V."""
    bh, hd = 5, 32
    q, k, v, _ = _inputs(bh, t, hd, seed=t + len(kind))
    mask = _mask(kind, bh, t, np.random.default_rng(t + 3 * len(kind)))
    want = _jax_block(q, k, v, mask, causal)
    got = block_attention(*_torch(q, k, v, mask), causal=causal).float()
    _close(got, want, v)
    n_bare = _check_bare_rows(got, v, mask, 1, causal)
    _check_bare_rows(want, v, mask, 1, causal)
    assert n_bare > 0 or not causal


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["left", "future", "mixed"])
def test_plain_versions_match_jax_oracle_without_past_keys(kind, causal):
    """The same masks at a ragged T (no multiple of 128, which the Pallas
    wrapper refuses) against the JAX package's oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas.attention import attention_oracle as jax_oracle

    t = 200
    q, k, v, _ = _inputs(4, t, 16, seed=11 + len(kind))
    mask = _mask(kind, 4, t, np.random.default_rng(17 + len(kind)))
    want = np.asarray(jax_oracle(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), causal=causal)
                      .astype(jnp.float32))
    tq = _torch(q, k, v, mask)
    _close(attention_oracle(*tq, causal=causal).float(), want, v)
    got = block_attention(*tq, causal=causal).float()
    _close(got, want, v)
    _check_bare_rows(got, v, mask, 1, causal)


def test_all_masked_row_is_the_mean_of_v():
    q, k, v, mask = _inputs(4, 96, 16, seed=3)
    out = block_attention(*_torch(q, k, v, mask), causal=True).float().numpy()
    row = 4 // 2
    assert not mask[row].any()
    # p = bf16(1/T) for every key: the mean of V up to that rounding
    want = np.broadcast_to(v[row].mean(axis=0), out[row].shape)
    _close(out[row], want, v)


def test_heads_share_one_mask_row():
    q, k, v, mask = _inputs(6, 64, 32, seed=4, all_masked_row=False)
    mask[1::2] = mask[0::2]  # rows 2i and 2i+1 are two heads of batch row i
    tq = _torch(q, k, v, mask)
    full = block_attention(*tq)
    shared = block_attention(*tq[:3], tq[3][0::2], heads=2)
    assert torch.equal(full, shared)


def test_checks_and_cpu_dispatch():
    q, k, v, mask = _torch(*_inputs(2, 32, 16, seed=5))
    before = block_attention.launches
    block_attention(q, k, v, mask)
    assert block_attention.launches == before  # the plain version: no launch
    with pytest.raises(InvalidConfigError, match="multiple of 16"):
        block_attention(q[..., :8], k[..., :8], v[..., :8], mask)
    with pytest.raises(InvalidConfigError, match="bfloat16"):
        block_attention(q.float(), k, v, mask)
    with pytest.raises(InvalidConfigError, match="key_mask"):
        block_attention(q, k, v, mask.int())
    with pytest.raises(InvalidConfigError, match="heads"):
        block_attention(q, k, v, mask, heads=3)
    with pytest.raises(InvalidConfigError, match="key_mask"):
        block_attention_reference(q, k, v, mask[:, :16])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,t,hd,heads", [(5, 48, 16, 1), (8, 528, 64, 2), (4, 1000, 128, 4),
                                           (3, 100, 32, 1), (6, 130, 80, 3)])
def test_cuda_kernel_matches_plain_version(bh, t, hd, heads, causal):
    """On the card: the CUDA kernel against the plain version, both on
    CUDA tensors, at ragged T (not a multiple of the 64-key tile) with an
    all-masked batch row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    q, k, v, mask = _inputs(bh, t, hd, seed=bh * t + hd)
    mask = mask[::heads].copy()
    q, k, v, mask = (x.cuda() for x in _torch(q, k, v, mask))
    before = block_attention.launches
    got = block_attention(q, k, v, mask, causal=causal, heads=heads)
    torch.cuda.synchronize()
    assert block_attention.launches == before + 1
    want = block_attention_reference(q, k, v, mask, causal=causal, heads=heads)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), v.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 129, 528, 1024])
def test_cuda_kernel_matches_plain_version_without_past_keys(t, hd, causal):
    """On the card, for each mask kind (right, left, future-only, mixed
    with all-PAD rows), 4 batch rows x 2 heads: the kernel against the plain
    version, and the rows without a past kept key against the mean of V.
    T crosses the 64-key and 128-query tiles' edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    heads, rows = 2, 4
    for n, kind in enumerate(MASK_KINDS):
        q, k, v, _ = _inputs(rows * heads, t, hd, seed=t * hd + n, all_masked_row=False)
        mask = _mask(kind, rows, t, np.random.default_rng(t + hd + n))
        q, k, v, mask_t = (x.cuda() for x in _torch(q, k, v, mask))
        before = block_attention.launches
        got = block_attention(q, k, v, mask_t, causal=causal, heads=heads)
        torch.cuda.synchronize()
        assert block_attention.launches == before + 1
        want = block_attention_reference(q, k, v, mask_t, causal=causal, heads=heads)
        got, want, v = (x.float().cpu().numpy() for x in (got, want, v))
        _close(got, want, v)
        _check_bare_rows(got, v, mask, heads, causal)
