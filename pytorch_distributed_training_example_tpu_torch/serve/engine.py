"""Continuous-batching decode engine over the paged KV cache.

Counterpart of ``pytorch_distributed_training_example_tpu/serve/engine.py``
for ``role="both"``: requests are admitted and retired BETWEEN decode steps
(iteration-level scheduling), so a long generation never holds the batch
hostage and a finished request's pages return to the pool immediately.

Shape discipline: every forward runs at one of a small set of padded BATCH
buckets (and, for prefill, prompt-length buckets). The JAX engine compiles
one executable per (kind, batch, seq) at warmup; PyTorch runs eagerly, so
here ``warmup`` runs each bucket shape once against the scratch page
(kernel builds, library loads and allocator growth happen there, not in a
request) and ``stats["compiles"]`` counts the distinct shapes run, which
stays flat after warmup. CUDA graphs per bucket are later work. Inactive
rows in a bucket carry token 0, position 0 and a page table full of
the reserved scratch page, so their lanes compute garbage that is never
read.

Host/device split per step: exactly ONE device->host fetch (the batched
next-token argmax that stop conditions need); admission, page allocation
and eviction are host bookkeeping on the ``PagePool`` free list.

Eviction: a slot that cannot get a page (pool exhausted) evicts the
YOUNGEST active request — its pages free immediately and the request
re-queues at the head of the waiting line, recomputed on readmission.

Not ported yet: prefix caching, chunked prefill, prefill/decode
disaggregation, speculative decoding, SLO tracing and telemetry spans.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from pytorch_distributed_training_example_tpu_torch.serve import kv_cache
from pytorch_distributed_training_example_tpu_torch.serve.kv_cache import (
    CacheSpec, PagePool, pages_for_tokens)


@dataclasses.dataclass
class Request:
    """One generation request. The engine fills the runtime fields."""

    request_id: str
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    arrival_time: float = 0.0
    # --- runtime (engine-owned) ---
    generated: list[int] = dataclasses.field(default_factory=list)
    submit_t: float | None = None
    admit_t: float | None = None
    first_token_t: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    evictions: int = 0

    @property
    def ttft_s(self) -> float | None:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def finished(self, max_len: int) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        return len(self.prompt) + len(self.generated) >= max_len


def spec_for_module(module, *, num_pages: int, page_size: int) -> CacheSpec:
    """Cache geometry from a decode-capable model's own attributes."""
    return CacheSpec(num_layers=module.num_layers, num_pages=num_pages,
                     page_size=page_size, num_kv_heads=module.num_kv_heads,
                     head_dim=module.head_dim, dtype=module.dtype)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class ContinuousBatchingEngine:
    """Greedy decode with iteration-level scheduling.

    ``module`` is the port's Llama (its weights live on ``device``; the
    engine runs it under ``torch.inference_mode``). ``attn_impl`` is the
    paged decode choice ("auto": the kernel on the card, the plain version
    on the CPU; "xla": the plain version everywhere).
    """

    def __init__(self, module, spec: CacheSpec, *,
                 decode_buckets: tuple[int, ...] = (1, 2, 4, 8),
                 prompt_buckets: tuple[int, ...] = (16, 32, 64),
                 max_model_len: int | None = None,
                 attn_impl: str = "auto"):
        self.module = module
        self.spec = spec
        self.device = module.embed.weight.device
        self.decode_buckets = tuple(sorted(decode_buckets))
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        model_cap = getattr(module, "max_seq_len", None) or spec.max_len
        self.max_model_len = min(max_model_len or model_cap, model_cap,
                                 spec.max_len)
        if self.prompt_buckets[-1] > self.max_model_len:
            raise ValueError(
                f"largest prompt bucket {self.prompt_buckets[-1]} exceeds "
                f"max_model_len {self.max_model_len}")
        self.attn_impl = attn_impl
        self.table_width = pages_for_tokens(self.max_model_len,
                                            spec.page_size)
        self.pool = PagePool(spec.num_pages)
        # One (K, V) pool pair per layer. Every forward writes them in place,
        # where the JAX engine donates them to each compiled step.
        self.cache = kv_cache.init_cache(spec, self.device)
        self.waiting: collections.deque[Request] = collections.deque()
        max_b = self.decode_buckets[-1]
        self.slots: list[Request | None] = [None] * max_b
        # Host mirrors of per-slot device state.
        self._tables = np.zeros((max_b, self.table_width), np.int32)
        self._lens = np.zeros(max_b, np.int32)
        self._next_tok = np.zeros(max_b, np.int32)
        self._pages: list[list[int]] = [[] for _ in range(max_b)]
        self.completed: list[Request] = []
        self.stats = {"compiles": 0, "prefills": 0, "decode_steps": 0,
                      "tokens_generated": 0, "evictions": 0, "admitted": 0,
                      "prompt_tokens": 0, "nonfinite_logits": 0}
        self._shapes: set[tuple[str, int, int]] = set()

    # ---------------------------------------------------------------- steps

    def _forward(self, kind: str, tokens: np.ndarray, positions: np.ndarray,
                 table: np.ndarray, last_index: np.ndarray) -> torch.Tensor:
        """One bucketed forward. Returns [batch, 2] ON THE DEVICE: each
        row's argmax token and whether all its logits were finite, so the
        caller's one host fetch carries both."""
        key = (kind, tokens.shape[0], tokens.shape[1])
        if key not in self._shapes:
            self._shapes.add(key)
            self.stats["compiles"] += 1
        dev = self.device
        with torch.inference_mode():
            logits = self.module(
                torch.from_numpy(tokens).to(dev),
                decode_ctx=dict(
                    positions=torch.from_numpy(positions).to(dev),
                    page_table=torch.from_numpy(table).to(dev),
                    last_index=torch.from_numpy(last_index).to(dev),
                    cache=self.cache, attn_impl=self.attn_impl))
            return torch.stack([torch.argmax(logits, dim=-1),
                                torch.isfinite(logits).all(dim=-1).long()],
                               dim=1)

    def warmup(self) -> int:
        """Run every bucket shape once against the scratch page (page 0 takes
        every write); returns the shape count. After this
        ``stats["compiles"]`` must stay flat."""
        for b in self.decode_buckets:
            zeros = np.zeros((b, 1), np.int32)
            self._forward("decode", zeros, zeros,
                          np.zeros((b, self.table_width), np.int32),
                          np.zeros(b, np.int32))
        for sp in self.prompt_buckets:
            self._forward("prefill", np.zeros((1, sp), np.int32),
                          self._prefill_positions(0, sp)[None],
                          np.zeros((1, self.table_width), np.int32),
                          np.zeros(1, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self._shapes)

    # ------------------------------------------------------------ scheduling

    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds largest "
                f"prompt bucket {self.prompt_buckets[-1]}")
        req.submit_t = time.perf_counter()
        self.waiting.append(req)

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _admit(self) -> list[int]:
        """Move waiting requests into free slots while pages last, and
        prefill each to completion inline."""
        admitted = []
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            plen = len(req.prompt)
            need = pages_for_tokens(plen + 1, self.spec.page_size)
            if not self.pool.can_alloc(need):
                break
            self.waiting.popleft()
            pages = self.pool.alloc(req.request_id, need)
            self.slots[slot] = req
            self._pages[slot] = pages
            self._tables[slot] = 0
            self._tables[slot, :len(pages)] = pages
            self._lens[slot] = plen
            req.admit_t = time.perf_counter()
            self.stats["admitted"] += 1
            self.stats["prompt_tokens"] += plen
            self._prefill(slot, req)
            admitted.append(slot)
        return admitted

    def _prefill_positions(self, pos: int, sp: int) -> np.ndarray:
        # Padded tail positions are clipped into table range; they write
        # garbage into not-yet-used (or scratch) slots that later real
        # appends overwrite and position masking hides meanwhile.
        return np.minimum(pos + np.arange(sp, dtype=np.int32),
                          self.table_width * self.spec.page_size - 1
                          ).astype(np.int32)

    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill ``req`` in one bucketed program, then record its first
        token and retire it if that already finishes it."""
        n = len(req.prompt)
        sp = _bucket(n, self.prompt_buckets)
        tokens = np.zeros((1, sp), np.int32)
        tokens[0, :n] = req.prompt
        tok = self._forward("prefill", tokens,
                            self._prefill_positions(0, sp)[None],
                            self._tables[slot:slot + 1].copy(),
                            np.asarray([n - 1], np.int32))
        out = tok.cpu().numpy()    # the prefill's one host fetch
        first = int(out[0, 0])
        self.stats["nonfinite_logits"] += int(not out[0, 1])
        now = time.perf_counter()
        req.generated.append(first)
        req.first_token_t = now
        req.token_times.append(now)
        self._next_tok[slot] = first
        self.stats["prefills"] += 1
        self.stats["tokens_generated"] += 1
        self._retire(slot)

    def _ensure_pages(self) -> None:
        """Every active slot must be able to take its NEXT append: the
        target page must exist (allocate incrementally). Evicts the
        youngest request on OOM."""
        while True:
            pending = None
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if int(self._lens[i]) // self.spec.page_size \
                        >= len(self._pages[i]):
                    pending = i
                    break
            if pending is None:
                return
            if self.pool.can_alloc(1):
                req = self.slots[pending]
                (page,) = self.pool.alloc(req.request_id, 1)
                self._pages[pending].append(page)
                self._tables[pending, len(self._pages[pending]) - 1] = page
                continue
            self._evict()

    def _release_slot(self, slot: int) -> None:
        req = self.slots[slot]
        self.pool.free(req.request_id)
        self.slots[slot] = None
        self._lens[slot] = 0
        self._tables[slot] = 0
        self._pages[slot] = []

    def _evict(self) -> None:
        """Free the youngest active request and requeue it (recompute on
        readmission). Raises if nothing is evictable — the pool is too
        small for even one request, a configuration error."""
        youngest, slot = None, None
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if youngest is None or req.submit_t > youngest.submit_t:
                youngest, slot = req, i
        if youngest is None:
            raise MemoryError("page pool exhausted with no active request "
                              "to evict — num_pages is too small")
        self._release_slot(slot)
        youngest.generated.clear()
        youngest.token_times.clear()
        youngest.first_token_t = None
        youngest.admit_t = None
        youngest.evictions += 1
        self.stats["evictions"] += 1
        self.waiting.appendleft(youngest)

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        if req is not None and req.finished(self.max_model_len):
            self._release_slot(slot)
            self.completed.append(req)

    # ---------------------------------------------------------------- step

    def step(self, admit: bool = True) -> int:
        """One scheduling iteration: admit+prefill, then one decode step
        over the active slots (padded to a batch bucket). Returns tokens
        generated by the decode step. ``admit=False`` is the drain mode of a
        graceful shutdown: in-flight sequences keep decoding, nothing new
        enters a slot."""
        if admit:
            self._admit()
        produced = 0
        if self.num_active:
            self._ensure_pages()
            produced = self._decode_step()
        return produced

    def _batch_rows(self, active: list[int]) -> tuple[int, list[int]]:
        bucket = _bucket(len(active), self.decode_buckets)
        rows = active + [i for i in range(len(self.slots))
                         if i not in active][:bucket - len(active)]
        return bucket, rows[:bucket]

    def _decode_step(self) -> int:
        """One decode step over the active slots, padded to a batch bucket.
        Callers run ``_ensure_pages`` first."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        bucket, rows = self._batch_rows(active)
        tokens = self._next_tok[rows][:, None].copy()
        positions = self._lens[rows][:, None].copy()
        table = self._tables[rows].copy()
        # Inactive filler rows: scratch page table, position 0, token 0.
        for j, i in enumerate(rows):
            if self.slots[i] is None:
                tokens[j] = 0
                positions[j] = 0
                table[j] = 0
        tok = self._forward("decode", tokens, positions, table,
                            np.zeros(bucket, np.int32))
        out = tok.cpu().numpy()    # the step's ONE host fetch
        now = time.perf_counter()
        self.stats["decode_steps"] += 1
        produced = 0
        for j, i in enumerate(rows):
            req = self.slots[i]
            if req is None:
                continue
            tok_j = int(out[j, 0])
            self.stats["nonfinite_logits"] += int(not out[j, 1])
            req.generated.append(tok_j)
            req.token_times.append(now)
            self._lens[i] += 1
            self._next_tok[i] = tok_j
            produced += 1
            self._retire(i)
        self.stats["tokens_generated"] += produced
        return produced

    def run(self, max_steps: int = 100000) -> list[Request]:
        """Drain every submitted request; returns the completed list."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   "steps (stop conditions broken?)")
        return self.completed
