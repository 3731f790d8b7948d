"""The bf16 paged decode kernel's split rule, on the CPU, against the JAX
package's paged decode.

``csrc/paged_decode.cu`` cuts each request's cache into splits of
``pages_per_split`` whole pages, as ``_paged_decode_splits`` plans them
from sizes the host knows; each split's block keeps an online-softmax state
``(m, l, acc)`` and the states are merged in split order. Here the same
splits are computed in torch fp32 from the planner's output and merged the
same way, and the result is held to the JAX ``paged_decode_attention`` with
``impl="pallas"`` (the TPU kernel, interpreted) and ``impl="xla"`` at
atol 1e-5 (fp32 sums of at most 701 terms in another order). The rows
cover a position-0 row on the scratch page, a last split that holds one
token, a cache that ends on a split's (and a page's) boundary, and G in
{1, 4, 8}; a table far wider than its positions (the serving engine's) is
held to ``impl="xla"`` only, since the Pallas grid walks every column of
the table. The Pallas cases share one jitted batch for each G.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_example_tpu.ops import (
    flash_attention as jax_flash)
from pytorch_distributed_training_example_tpu_torch.ops import (
    flash_attention as flash)

ATOL = 1e-5
PS, D, HKV, SMS = 16, 16, 2, 132
WIDTH = 32          # columns of the Pallas batch's table: 512 tokens
ENGINE_WIDTH = 255  # the serving engine's table at --serve-num-pages 256


def _batch(G, positions, width, seed):
    """A random pool; each request's pages scattered over it, page 0 (the
    scratch page) for a row at position 0, and the columns past a
    request's pages holding other requests' pages."""
    rng = np.random.default_rng(seed)
    B, H = len(positions), G * HKV
    n_pages = [p // PS + 1 for p in positions]
    pool = 1 + sum(n_pages)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = rng.standard_normal((2, pool, PS, HKV, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, pool)).astype(np.int32)
    table = np.zeros((B, width), np.int32)
    used = 0
    for b, (pos, n) in enumerate(zip(positions, n_pages)):
        if pos > 0:
            table[b, :n] = ids[used:used + n]
            used += n
            table[b, n:] = rng.choice(ids, width - n)
    return q, kv[0], kv[1], table, np.asarray(positions, np.int32)


def _split_combine(q, k_pages, v_pages, table, positions):
    """Each split's (m, l, acc) in torch fp32 with the kernel's planner,
    merged in split order. Also returns each row's live split count and
    the token count of its last split."""
    q, k_pages, v_pages = (torch.from_numpy(a) for a in (q, k_pages,
                                                          v_pages))
    B, H, _ = q.shape
    pages, n_splits = flash._paged_decode_splits(B, HKV, table.shape[1], PS,
                                                 SMS)
    split_tok = pages * PS
    out = torch.empty_like(q)
    live, last = [], []
    for b in range(B):
        n_tok = min(int(positions[b]) + 1, table.shape[1] * PS)
        n_live = -(-n_tok // split_tok)
        assert 1 <= n_live <= n_splits
        qg = q[b].reshape(HKV, H // HKV, D)
        states = []
        for s in range(n_live):
            toks = torch.arange(s * split_tok, min((s + 1) * split_tok,
                                                   n_tok))
            rows = torch.from_numpy(table[b])[toks // PS], toks % PS
            k, v = k_pages[rows], v_pages[rows]               # [T, Hkv, D]
            logits = torch.einsum("hgd,thd->hgt", qg, k) / np.sqrt(D)
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            states.append((m, p.sum(-1), torch.einsum("hgt,thd->hgd", p, v)))
        m_all = torch.stack([s[0] for s in states]).amax(0)
        acc = torch.zeros_like(qg)
        l_all = torch.zeros_like(m_all)
        for m, l, a in states:          # split order, as the kernel merges
            c = torch.exp(m - m_all)
            acc += c[..., None] * a
            l_all += c * l
        out[b] = (acc / l_all.clamp_min(1e-30)[..., None]).reshape(H, D)
        live.append(n_live)
        last.append(n_tok - (n_live - 1) * split_tok)
    return out.numpy(), live, last, split_tok


def _jax(impl, q, k_pages, v_pages, table, positions):
    return np.asarray(jax.jit(functools.partial(
        jax_flash.paged_decode_attention, impl=impl))(
        *(jnp.asarray(a) for a in (q, k_pages, v_pages, table, positions))))


# The Pallas batch's rows: a filler row at position 0 on the scratch page;
# a last split of one token (256 = 2 splits of 128); a cache that ends on a
# split and page boundary (384 tokens, 3 splits); a position mid-page.
CASES = {"scratch_page_row": 0, "last_split_one_token": 1,
         "ends_on_split_boundary": 2, "mid_page": 3}
POSITIONS = [0, 256, 383, 437]


@functools.cache
def _pallas_batch(G):
    inputs = _batch(G, POSITIONS, WIDTH, seed=G)
    got = _split_combine(*inputs)
    return got, _jax("pallas", *inputs), _jax("xla", *inputs)


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_split_combine_matches_jax(case, G):
    (got, live, last, split_tok), pallas, xla = _pallas_batch(G)
    row = CASES[case]
    assert split_tok == 128   # eight 16-token pages: several splits a row
    assert {"scratch_page_row": live[row] == 1 and last[row] == 1,
            "last_split_one_token": live[row] == 3 and last[row] == 1,
            "ends_on_split_boundary": live[row] == 3 and last[row] == 128,
            "mid_page": live[row] == 4 and last[row] == 54}[case]
    for name, ref in (("pallas", pallas), ("xla", xla)):
        np.testing.assert_allclose(got[row], ref[row], atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("G", [1, 4, 8])
def test_split_combine_matches_jax_at_engine_width(G):
    """255 columns, positions far below them, the columns past each
    request's pages holding other requests' pages, which must not count."""
    inputs = _batch(G, [0, 37, 300, 700], ENGINE_WIDTH, seed=10 + G)
    got, live, _, split_tok = _split_combine(*inputs)
    assert split_tok == 128 and live == [1, 1, 3, 6]
    np.testing.assert_allclose(got, _jax("xla", *inputs), atol=ATOL)


@pytest.mark.parametrize("B,Hkv,max_pages,want", [
    (8, 8, 64, (16, 4)),     # B=8 at a tight table: 256 blocks, one wave
    (8, 8, 255, (24, 11)),   # B=8 at the engine's width: splits stop at 384
    (1, 8, 63, (8, 8)),      # B=1 at position 1000: 128-token splits
    (1, 8, 512, (16, 32)),   # B=1 at 8192 tokens: 256 blocks
    (8, 8, 128, (24, 6)),    # B=8 at 2048 tokens each
    (4, 8, 511, (24, 22)),   # the long-prompt drain's engine (512 pages)
    (1, 1, 0, (8, 1))])      # no column at all: one split, all blocks idle
def test_planner_sizes(B, Hkv, max_pages, want):
    pages, n_splits = flash._paged_decode_splits(B, Hkv, max_pages, 16, 132)
    assert (pages, n_splits) == want
    assert pages * n_splits >= max_pages
    assert 128 <= pages * 16 <= 384


@pytest.mark.parametrize("page_size", [1, 4, 16, 32, 64, 128])
def test_planner_splits_are_whole_pages_of_128_to_384_tokens(page_size):
    """Any page size: whole pages, at least 128 tokens (one page if a page
    is longer), at most 384 (or one page), covering every column."""
    for B, Hkv, max_pages in ((1, 8, 4000), (8, 8, 255), (64, 8, 40),
                              (3, 2, 1)):
        pages, n_splits = flash._paged_decode_splits(B, Hkv, max_pages,
                                                     page_size, 132)
        assert pages >= 1 and pages * n_splits >= max_pages
        assert (n_splits - 1) * pages < max(max_pages, 1)
        assert pages == 1 or 128 <= pages * page_size <= 384
