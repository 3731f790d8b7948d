"""Fused MoE router: the CUDA kernel and its plain PyTorch version.

Counterpart of ``pytorch_distributed_training_example_tpu/ops/
fused_router.py``. Its Pallas kernel ``_router_kernel`` (via
``_fused_router_call``) is ported as ``csrc/fused_router.cu``: one pass over
the fp32 ``[T, E]`` router logits that emits everything the MoE block needs
downstream:

- ``gate_vals`` ``[T, k]`` fp32: the top-k probabilities renormalised to
  sum to one;
- ``expert_idx`` ``[T, k]`` int32: the chosen experts in ``lax.top_k``
  order, ties broken toward the lower expert index (k rounds of
  first-occurrence argmax);
- ``lse`` ``[T]``: the logsumexp of each row (the z-loss input);
- ``probs_mean`` ``[E]``: the mean router probability per expert over all
  T rows (the aux loss's ``me`` term).

:func:`fused_router` launches the kernel for a CUDA tensor (or raises) and
takes :func:`fused_router_plain` only for a CPU tensor; there is no
fallback. It differentiates through :class:`FusedRouter`, whose backward is
the JAX ``_fused_router_bwd`` formula written in torch (the JAX package has
no Pallas backward here either). ``fused_router_fwd.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_training_example_tpu_torch.ops import _build
from pytorch_distributed_training_example_tpu_torch.ops.flash_attention import (
    _check_cuda_args, _ptr, _stream, arrival_counters)

#: Widest router the kernel takes (one row's probabilities in registers).
MAX_EXPERTS = 64
#: Threads of one of the kernel's blocks.
BLOCK_THREADS = 256


def _router_schedule(T: int, E: int) -> tuple[int, int, int, int]:
    """``(blocks, rows_per_block, merge_parts, workspace)`` of
    ``csrc/fused_router.cu`` for ``T`` rows of ``E`` logits. A row is
    spread over G lanes (E's bound of 8, 16 or 32, at most 32), so a block
    of ``BLOCK_THREADS`` takes ``BLOCK_THREADS // G`` rows and writes one
    ``[E]`` partial of the probabilities' sums into the ``[blocks, E]``
    workspace; the last block to arrive sums expert e's partials as
    ``merge_parts`` = ``BLOCK_THREADS // E`` parts (part q: blocks q, q +
    parts, ... in order), then the parts in order. One arrival counter a
    call."""
    lanes = 8 if E <= 8 else 16 if E <= 16 else 32
    rows = BLOCK_THREADS // lanes
    blocks = -(-T // rows)
    return blocks, rows, BLOCK_THREADS // E, blocks * E


def top_k_first(probs: torch.Tensor, top_k: int):
    """``lax.top_k`` over the last axis, ties toward the lower index: k
    rounds of max, then the lowest index among the maxima, then mask.
    Returns (values [..., k], indices [..., k] int64); the values are taken
    from ``probs`` by index, so they carry its gradient."""
    E = probs.shape[-1]
    eidx = torch.arange(E, device=probs.device)
    avail = probs.detach()
    picks = []
    for _ in range(top_k):
        mj = avail.max(dim=-1, keepdim=True).values
        aj = torch.where(avail == mj, eidx, E).min(dim=-1, keepdim=True).values
        picks.append(aj)
        avail = avail.masked_fill(eidx == aj, float("-inf"))
    idx = torch.cat(picks, dim=-1)
    return probs.gather(-1, idx), idx


def _softmax_lse(logits: torch.Tensor):
    """Probabilities and logsumexp as the kernels compute them: the row
    max, exp of the difference, the row sum, one division."""
    m = logits.max(dim=-1, keepdim=True).values
    ex = torch.exp(logits - m)
    se = ex.sum(dim=-1, keepdim=True)
    return ex / se, (m + torch.log(se))[..., 0]


def fused_router_plain(logits: torch.Tensor, top_k: int):
    """Plain version of the kernel: (gate_vals, expert_idx int32, lse,
    probs_mean) from fp32 ``[T, E]`` logits."""
    probs, lse = _softmax_lse(logits.float())
    g, idx = top_k_first(probs, top_k)
    gates = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32), lse, probs.mean(0)


@_build.cached("fused_router")
def _router_fn():
    fn = _build.library("fused_router").pdtx_fused_router
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _fused_router_cuda(logits: torch.Tensor, top_k: int):
    T, E = logits.shape
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"fused router kernel takes 1..{MAX_EXPERTS} "
                         f"experts, got {E}")
    if T < 1:
        raise ValueError("fused router kernel takes at least one row")
    _check_cuda_args("fused_router", dict(logits=logits), torch.float32)
    dev = logits.device
    gates = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    lse = torch.empty((T,), dtype=torch.float32, device=dev)
    probs_mean = torch.empty((E,), dtype=torch.float32, device=dev)
    # Per-block partial sums of the probabilities, which the last block to
    # arrive sums in a fixed order (no float atomics: reproducible).
    partial = torch.empty(_router_schedule(T, E)[3], dtype=torch.float32,
                          device=dev)
    counter = arrival_counters("fused_router", dev, 1)
    with torch.cuda.device(dev):
        err = _router_fn()(
            _ptr(logits), _ptr(gates), _ptr(idx), _ptr(lse), _ptr(probs_mean),
            _ptr(partial), _ptr(counter), T, E, top_k, _stream(dev))
    _build.check(err, "fused_router")
    fused_router_fwd.launches += 1
    return gates, idx, lse, probs_mean


@_build.cached("fused_router")
def _empty_fn():
    fn = _build.library("fused_router").pdtx_router_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_launch(T: int, E: int) -> None:
    """Launch an empty kernel on the router kernel's grid for ``T`` rows of
    ``E`` logits, on the current CUDA stream: the floor any launch reads in
    a timing harness. Counts no launch."""
    device = torch.device("cuda", torch.cuda.current_device())
    _build.check(_empty_fn()(T, E, _stream(device)), "empty_launch")


def fused_router_fwd(logits: torch.Tensor, top_k: int):
    """(gate_vals, expert_idx, lse, probs_mean) of fp32 ``[T, E]`` logits:
    ``csrc/fused_router.cu`` for a CUDA tensor, the plain version for a CPU
    one."""
    if logits.ndim != 2 or logits.dtype != torch.float32:
        raise ValueError(f"fused router takes fp32 [T, E] logits, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    if not 1 <= top_k <= logits.shape[1]:
        raise ValueError(f"top_k={top_k} outside [1, {logits.shape[1]}]")
    if logits.is_cuda:
        return _fused_router_cuda(logits.contiguous(), top_k)
    return fused_router_plain(logits, top_k)


fused_router_fwd.launches = 0


class FusedRouter(torch.autograd.Function):
    """The counterpart of ``fused_router``'s ``custom_vjp``: the forward is
    the kernel; the backward recomputes the softmax from the saved logits
    and composes the gate-renormalisation, top-k scatter, ``probs_mean``,
    logsumexp and softmax VJPs (JAX ``_fused_router_bwd``)."""

    @staticmethod
    def forward(ctx, logits, top_k: int):
        gates, idx, lse, probs_mean = fused_router_fwd(logits, top_k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return gates, idx, lse, probs_mean

    @staticmethod
    def backward(ctx, dg, _didx, dlse, dpm):
        logits, idx = ctx.saved_tensors
        T = logits.shape[0]
        probs = torch.softmax(logits.float(), dim=-1)
        idx = idx.long()
        # Gate renormalisation: v_j = raw_j / G, G = sum(raw).
        raw = probs.gather(1, idx)
        denom = torch.clamp(raw.sum(-1, keepdim=True), min=1e-9)
        v = raw / denom
        draw = (dg - (dg * v).sum(-1, keepdim=True)) / denom
        # Top-k selection (distinct indices per row), plus probs_mean.
        dprobs = torch.zeros_like(probs).scatter_add_(1, idx, draw)
        dprobs = dprobs + dpm[None, :] / T
        dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
        # logsumexp: d lse / d logits = probs.
        return dlogits + probs * dlse[:, None], None


def fused_router(logits: torch.Tensor, top_k: int):
    """Single-pass router, differentiable in gate_vals, lse and probs_mean
    (``expert_idx`` is integral): the JAX ``fused_router``."""
    return FusedRouter.apply(logits, top_k)
