"""The port's paged KV cache against the JAX package's.

The page pool is host bookkeeping: the same script of alloc/share/drop/free
must hand out the same page ids in both packages (LIFO reuse, scratch page
0 never given out). ``append_pages`` must write the same pool, with padded
rows' writes landing on scratch page 0 — exact equality, since it only
moves values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_distributed_training_example_tpu.serve import (
    kv_cache as jax_kv)
from pytorch_distributed_training_example_tpu_torch.serve import kv_cache


def _script(pool_cls):
    """Run one alloc/share/drop/free script; return every observable."""
    pool = pool_cls(10)
    seen = [pool.alloc("a", 3), pool.alloc("b", 2)]
    pool.share("c", seen[0][:2])
    pool.drop("a", seen[0][0])
    seen.append([pool.refcount(p) for p in range(10)])
    pool.free("b")
    seen.append(pool.alloc("d", 4))
    pool.free("a")
    pool.free("a")  # idempotent
    seen.append(pool.alloc("e", 3))
    pool.free("c")
    seen.append(pool.alloc("f", 1))
    seen.append([pool.num_free, pool.owned("d"), pool.owned("e")])
    with pytest.raises(MemoryError):
        pool.alloc("g", pool.num_free + 1)
    with pytest.raises(ValueError, match="reserved scratch"):
        pool.share("g", [0])
    with pytest.raises(ValueError, match="double free"):
        pool.drop("d", 9999)
    return seen


def test_page_pool_matches_jax_pool():
    assert _script(kv_cache.PagePool) == _script(jax_kv.PagePool)
    assert kv_cache.pages_for_tokens(0, 16) == 1
    assert kv_cache.pages_for_tokens(17, 16) == 2


def test_append_pages_matches_jax_including_padded_rows():
    rng = np.random.default_rng(0)
    P, ps, Hkv, D = 8, 4, 2, 4
    pages = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    # Rows 0-1 are real (a prefill window and a page crossing); rows 2-3 are
    # padded filler rows: page table of scratch page 0, position 0, so every
    # one of their writes lands on page 0, slot 0.
    table = np.asarray([[3, 5, 0], [6, 2, 7], [0, 0, 0], [0, 0, 0]], np.int32)
    positions = np.asarray([[0, 1, 2], [3, 4, 5], [0, 0, 0], [0, 0, 0]],
                           np.int32)
    new = rng.standard_normal((4, 3, Hkv, D)).astype(np.float32)
    got = kv_cache.append_pages(torch.from_numpy(pages.copy()),
                                torch.from_numpy(new),
                                torch.from_numpy(table),
                                torch.from_numpy(positions)).numpy()
    ref = np.asarray(jax_kv.append_pages(jnp.asarray(pages), jnp.asarray(new),
                                         jnp.asarray(table),
                                         jnp.asarray(positions)))
    np.testing.assert_array_equal(got[1:], ref[1:])
    np.testing.assert_array_equal(got[0, 1:], pages[0, 1:])
    # Colliding filler writes: either one may win, in both packages.
    fillers = new[2:].reshape(-1, Hkv, D)
    for out in (got, ref):
        assert any(np.array_equal(out[0, 0], f) for f in fillers)
    # The real rows round-trip through gather_pages.
    view = kv_cache.gather_pages(torch.from_numpy(got),
                                 torch.from_numpy(table[:2])).numpy()
    np.testing.assert_array_equal(view[0, :3], new[0])
    np.testing.assert_array_equal(view[1, 3:6], new[1])


def test_cache_spec_and_init_cache():
    spec = kv_cache.CacheSpec(num_layers=2, num_pages=6, page_size=4,
                              num_kv_heads=2, head_dim=8,
                              dtype=torch.bfloat16)
    ref = jax_kv.CacheSpec(num_layers=2, num_pages=6, page_size=4,
                           num_kv_heads=2, head_dim=8, dtype=jnp.bfloat16)
    assert (spec.max_len, spec.bytes_per_page, spec.layer_shape()) == \
        (ref.max_len, ref.bytes_per_page, ref.layer_shape())
    cache = kv_cache.init_cache(spec, "cpu")
    assert len(cache) == 2
    for k, v in cache:
        assert k.shape == v.shape == (6, 4, 2, 8)
        assert k.dtype == torch.bfloat16 and not k.any()
