"""The port's attention ops against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both packages. The
JAX Pallas kernels run in interpret mode (``impl="pallas"`` for the paged
decode kernel, ``force_tpu_interpret_mode`` for the flash forward), so the
port's plain versions are held to the kernels they replace. Tolerances are
fp32: atol 2e-5, the bound the JAX package's own parity tests use for the
same comparisons (sums taken in another order).

The CUDA kernels themselves are held to these plain versions on the card by
``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_distributed_training_example_tpu.ops import (
    attention as jax_attn, flash_attention as jax_flash)
from pytorch_distributed_training_example_tpu_torch.ops import (
    attention as attn, flash_attention as flash)
from pytorch_distributed_training_example_tpu_torch.serve.kv_cache import (
    PagePool, pages_for_tokens)

ATOL = 2e-5


def _paged_inputs(B, H, Hkv, D, page_size, num_pages, lens, seed=0):
    """A random pool, and page tables that scatter each request's pages
    across it in the pool's LIFO order."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k_pages = rng.standard_normal((num_pages, page_size, Hkv, D)
                                  ).astype(np.float32)
    v_pages = rng.standard_normal((num_pages, page_size, Hkv, D)
                                  ).astype(np.float32)
    max_pages = pages_for_tokens(max(lens) + 1, page_size)
    pool = PagePool(num_pages)
    table = np.zeros((B, max_pages), np.int32)
    for b, n in enumerate(lens):
        pages = pool.alloc(f"r{b}", pages_for_tokens(n + 1, page_size))
        table[b, :len(pages)] = pages
    return q, k_pages, v_pages, table, np.asarray(lens, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# The lens of the JAX package's two paged decode tests in one batch: first /
# mid / edge / crossing a 16-token page, and a two-page crossing.
PAGED_LENS = [0, 5, 16, 30, 3, 15, 16, 40]


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 2), (4, 4)])
def test_paged_decode_plain_matches_jax(H, Hkv):
    q, kp, vp, table, pos = _paged_inputs(8, H, Hkv, 8, 16, 24, PAGED_LENS)
    got = flash.paged_decode_attention(*_torch(q, kp, vp, table, pos)
                                       ).numpy()
    for impl in ("pallas", "xla"):
        ref = np.asarray(jax_flash.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(pos), impl=impl))
        np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=impl)


def test_paged_decode_rejects_bad_gqa_and_impl():
    q, kp, vp, table, pos = _torch(*_paged_inputs(1, 4, 2, 8, 16, 4, [3]))
    with pytest.raises(ValueError, match="not a multiple"):
        flash.paged_decode_attention(q[:, :3], kp, vp, table, pos)
    with pytest.raises(ValueError, match="unknown paged decode impl"):
        flash.paged_decode_attention(q, kp, vp, table, pos, impl="pallas")


def test_paged_prefill_plain_matches_jax():
    B, S, H, Hkv, D, ps = 2, 5, 4, 2, 8, 4
    rng = np.random.default_rng(1)
    _, kp, vp, table, _ = _paged_inputs(B, H, Hkv, D, ps, 12, [13, 9], 1)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    # Windows that start mid-sequence: history before them in the pool.
    positions = np.stack([np.arange(9, 9 + S), np.arange(5, 5 + S)]
                         ).astype(np.int32)
    got = flash.paged_prefill_attention(
        *_torch(q, kp, vp, table, positions)).numpy()
    ref = np.asarray(jax_flash.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(positions)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _qkv(B=1, S=64, H=4, Hkv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_plain_matches_jax_online_kernel(causal):
    """Out and per-row LSE against the online Pallas forward at 32x32
    blocks over S=64 (causal block skipping and the masked diagonal). This
    is ``flash_attention(q, k, v, causal, 32, 32, "online")`` minus its
    KV repeat, called one level down to get the LSE in the same run."""
    q, k, v = _qkv()
    out, lse = flash.flash_attention_fwd(*_torch(q, k, v), causal=causal)
    H = q.shape[2]
    with pltpu.force_tpu_interpret_mode():
        ref, ref_lse = jax_flash._flash_fwd(
            jnp.asarray(q), jax_attn._repeat_kv(jnp.asarray(k), H),
            jax_attn._repeat_kv(jnp.asarray(v), H), causal=causal,
            block_q=32, block_kv=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax(causal):
    q, k, v = _qkv(B=2, S=24, seed=2)
    got = attn.dot_product_attention(*_torch(q, k, v), causal=causal)
    ref = jax_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_attention_dispatch_rules():
    q, k, v = _torch(*_qkv(S=1024, H=2, Hkv=1, D=8))
    # On CPU tensors 'auto' takes the plain path even for a flash shape,
    # and 'flash' takes the flash wrapper's plain version.
    assert not attn._flash_eligible(q, k)
    auto = attn.attention(q, k, v, causal=True)
    forced = attn.attention(q, k, v, causal=True, impl="flash")
    torch.testing.assert_close(auto, forced, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        attn.attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        attn.attention(q, k, v, impl="bogus")
