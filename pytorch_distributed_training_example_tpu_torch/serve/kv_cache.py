"""Paged KV cache: fixed-size pages in a preallocated pool.

Counterpart of ``pytorch_distributed_training_example_tpu/serve/
kv_cache.py``. The cache for one attention layer is a pair of pools shaped
``[num_pages, page_size, num_kv_heads, head_dim]``. A request owns a *page
table* — a row of physical page ids, one per ``page_size`` logical tokens —
so its K/V live scattered across the pool and the pool never fragments.

- ``PagePool`` is the HOST-side allocator (plain python free list, LIFO
  reuse, refcounts). It never touches device memory.
- ``append_pages`` / ``gather_pages`` are the DEVICE-side ops. Unlike the
  JAX package, which donates the pools to a functional update,
  ``append_pages`` writes into the pool in place.

Page 0 is RESERVED as a scratch page: padded (inactive) batch rows point
their entire page table at it, so their appends land somewhere harmless and
their reads are masked by position anyway.
"""

from __future__ import annotations

import dataclasses

import torch

RESERVED_PAGES = 1  # page 0: scratch target for padded batch rows


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static geometry of one model's paged cache."""

    num_layers: int
    num_pages: int          # pool size, INCLUDING the reserved scratch page
    page_size: int          # tokens per page
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @property
    def max_len(self) -> int:
        """Upper bound on any single sequence (pool capacity aside)."""
        return (self.num_pages - RESERVED_PAGES) * self.page_size

    @property
    def bytes_per_page(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        # K and V pools, every layer.
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * self.head_dim * itemsize)

    def layer_shape(self) -> tuple[int, int, int, int]:
        return (self.num_pages, self.page_size, self.num_kv_heads,
                self.head_dim)


def pages_for_tokens(num_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``num_tokens`` logical positions."""
    return -(-max(num_tokens, 1) // page_size)


class PagePool:
    """Host-side refcounted free list over page ids ``[RESERVED, num_pages)``.

    LIFO reuse: same admission order, same page tables, so same-seed serve
    runs are reproducible — and give the JAX pool's page ids exactly.
    ``alloc`` hands out private pages (refcount 1), ``share`` adds an owner
    to an existing page, and a page only returns to the free list once every
    owner has released it. The scratch page is never allocated or shared, a
    refcount never goes negative, and releasing a page twice through the
    same owner raises.
    """

    def __init__(self, num_pages: int):
        if num_pages <= RESERVED_PAGES:
            raise ValueError(
                f"num_pages={num_pages} leaves no allocatable pages "
                f"({RESERVED_PAGES} reserved)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, RESERVED_PAGES - 1,
                                           -1))
        self._owned: dict[str, list[int]] = {}
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        """Owners currently holding ``page`` (0 = free)."""
        return self._refs.get(page, 0)

    def alloc(self, request_id: str, n: int) -> list[int]:
        """Take ``n`` private pages for ``request_id``; raises if short."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(request_id, []).extend(pages)
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, request_id: str, pages: list[int]) -> None:
        """Add ``request_id`` as an owner of already-allocated ``pages``."""
        for p in pages:
            if p < RESERVED_PAGES:
                raise ValueError(f"page {p} is reserved scratch")
            if self._refs.get(p, 0) <= 0:
                raise ValueError(f"page {p} is free; cannot share")
        self._owned.setdefault(request_id, []).extend(pages)
        for p in pages:
            self._refs[p] += 1

    def drop(self, request_id: str, page: int) -> None:
        """Release ONE reference ``request_id`` holds on ``page``."""
        owned = self._owned.get(request_id)
        if owned is None or page not in owned:
            raise ValueError(
                f"double free: {request_id!r} does not own page {page}")
        owned.remove(page)
        if not owned:
            del self._owned[request_id]
        self._unref(page)

    def free(self, request_id: str) -> int:
        """Release every reference held by ``request_id``; idempotent."""
        pages = self._owned.pop(request_id, [])
        for p in reversed(pages):
            self._unref(p)
        return len(pages)

    def _unref(self, page: int) -> None:
        rc = self._refs.get(page, 0)
        if rc <= 0:
            raise ValueError(f"refcount underflow on page {page}")
        rc -= 1
        if rc == 0:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = rc

    def owned(self, request_id: str) -> list[int]:
        return list(self._owned.get(request_id, ()))


def init_cache(spec: CacheSpec, device) -> list[tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Zeroed (K, V) pools for every layer, in layer order, on ``device``."""
    shape = spec.layer_shape()
    return [(torch.zeros(shape, dtype=spec.dtype, device=device),
             torch.zeros(shape, dtype=spec.dtype, device=device))
            for _ in range(spec.num_layers)]


def append_pages(pages: torch.Tensor, new: torch.Tensor,
                 page_table: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` K or V rows into the pool through the page table,
    IN PLACE (the JAX package donates the pool to a functional update;
    here the pool tensor itself is written). Returns ``pages``.

    pages:      [P, page_size, Hkv, D] pool
    new:        [B, S, Hkv, D] freshly-projected K or V
    page_table: [B, max_pages] int32 physical page per logical block
    positions:  [B, S] int32 logical position of each new token

    Token (b, s) lands in page ``page_table[b, positions // page_size]`` at
    slot ``positions % page_size``. Padded rows carry page tables full of
    the scratch page, so their writes collide harmlessly on page 0. JAX
    drops an out-of-range write; an out-of-range index here would be a
    device-side assert, so the engine keeps every position inside the
    table (it clips padded positions to the table's last slot).
    """
    B, S, Hkv, D = new.shape
    page_size = pages.shape[1]
    positions = positions.long()
    page_ids = torch.gather(page_table.long(), 1,
                            positions // page_size)           # [B, S]
    slots = positions % page_size
    pages.index_put_((page_ids.reshape(-1), slots.reshape(-1)),
                     new.reshape(B * S, Hkv, D).to(pages.dtype))
    return pages


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Materialise each request's logical K/V view from the pool.

    Returns [B, max_pages * page_size, Hkv, D]; positions past a request's
    length hold stale pool contents and MUST be masked by the caller.
    """
    B, max_pages = page_table.shape
    _, page_size, Hkv, D = pages.shape
    gathered = pages[page_table.reshape(-1).long()]
    return gathered.reshape(B, max_pages * page_size, Hkv, D)
