"""Flash attention forward and backward, and paged decode attention: CUDA
kernels and their plain PyTorch versions.

Counterpart of ``pytorch_distributed_training_example_tpu/ops/
flash_attention.py``. Its Pallas kernels on the serving and training paths
are ported here as hand-written CUDA kernels for Hopper (``csrc/``):

- :func:`flash_attention_fwd` replaces ``_fwd_kernel`` (via ``_flash_fwd``):
  the online-softmax forward with causal tile skipping and per-row LSE.
  Kernel: ``csrc/flash_fwd.cu``.
- :func:`flash_attention_fwd_kv_len` replaces ``_oneshot_fwd_kernel`` and
  ``_oneshot_fwd_kernel_chunked`` (via ``_oneshot_fwd``): the same forward
  with keys at or past ``kv_len`` masked, which the padded path
  (``attention.padded_flash_attention``) runs. The same kernel, given
  ``kv_len``; the chunked body's causal contract is the causal forward.
- :func:`flash_attention_bwd` replaces the five backward bodies
  ``_dq_kernel``/``_dkv_kernel`` (``_flash_bwd``), ``_oneshot_bwd_kernel``
  and ``_oneshot_bwd_kernel_chunked`` (``_oneshot_bwd``) and
  ``_stream_bwd_kernel`` (``_stream_bwd``): dq, dk, dv recomputed from the
  forward's LSE. Kernel: ``csrc/flash_bwd.cu``.
- :class:`FlashAttention` ties the two together as the counterpart of
  ``flash_attention``'s ``custom_vjp``; :func:`flash_attention` is the
  differentiable entry point the dispatcher calls.
- :func:`paged_decode_attention` replaces ``_paged_decode_kernel`` (via
  ``_paged_decode_pallas``): one query token per request against the paged
  KV pool. Kernel: ``csrc/paged_decode.cu``.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version only for tensors on the CPU; there is no fallback from one to
the other. Each carries ``launches``, a plain integer that counts kernel
launches and nothing else. :func:`paged_prefill_attention` stays plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pytorch_distributed_training_example_tpu_torch.ops import _build
from pytorch_distributed_training_example_tpu_torch.ops.attention import (
    NEG_INF, _repeat_kv, attention_logits, attention_output)
from pytorch_distributed_training_example_tpu_torch.serve.kv_cache import (
    gather_pages)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _kernel_operands(*tensors):
    """The kernels' operand dtype, as the TPU kernels' ``_mxu``: bf16 and
    fp32 as stored, fp16 upcast to fp32 (its 5-bit exponent overflows)."""
    if tensors[0].dtype == torch.float16:
        return tuple(t.float() for t in tensors)
    if tensors[0].dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernels take float32/bfloat16/float16, got "
                        f"{tensors[0].dtype}")
    return tensors


def _check_cuda_args(what: str, tensors: dict, dtype=None) -> None:
    """Raise on what the kernels do not take: mixed devices, non-contiguous
    storage, or a dtype other than the expected one."""
    device = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             "every argument on the same CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")


# ---------------------------------------------------------------------------
# Flash attention forward (replaces _fwd_kernel)
# ---------------------------------------------------------------------------


def _masked_logits(q, k, causal: bool, kv_len: int | None):
    """The oracle's scaled fp32 scores, with keys at or past ``kv_len``
    masked as the one-shot kernels' ``_kv_len_mask`` masks them."""
    logits = attention_logits(q, k, causal=causal)
    if kv_len is not None:
        k_pos = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(k_pos >= kv_len, NEG_INF)
    return logits


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              kv_len: int | None = None):
    """Plain version: ``dot_product_attention``'s math, plus the per-row
    log-sum-exp. Returns (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32)."""
    logits = _masked_logits(q, k, causal, kv_len)
    return (attention_output(logits, v, q.dtype),
            torch.logsumexp(logits, dim=-1))


@functools.cache
def _flash_fwd_fn():
    fn = _build.library("flash_fwd").pdtx_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _flash_fwd_cuda(q, k, v, causal: bool, kv_len: int | None):
    """One launch of ``csrc/flash_fwd.cu``; the caller counts it."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    out_dtype = q.dtype
    q, k, v = _kernel_operands(q, k, v)
    _check_cuda_args("flash_attention_fwd", dict(q=q, k=k, v=v), q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _flash_fwd_fn()(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), B, Sq, Skv,
            Skv if kv_len is None else kv_len, H, Hkv, D, int(causal),
            1.0 / math.sqrt(D), _KERNEL_DTYPES[q.dtype], _stream(q.device))
    _build.check(err, "flash_fwd")
    return out.to(out_dtype), lse


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        kv_len: int | None = None):
    """Flash attention forward on [B, S, H, D]; GQA via fewer K/V heads.

    Returns (out [B, Sq, H, D], lse [B, H, Sq] fp32). CUDA tensors go
    through ``csrc/flash_fwd.cu``; CPU tensors through the plain version.
    A ``kv_len`` goes to :func:`flash_attention_fwd_kv_len`.
    """
    if kv_len is not None:
        return flash_attention_fwd_kv_len(q, k, v, kv_len, causal=causal)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of Hkv={k.shape[2]}")
    if q.is_cuda:
        out = _flash_fwd_cuda(q, k, v, causal, None)
        flash_attention_fwd.launches += 1
        return out
    return flash_attention_fwd_plain(q, k, v, causal=causal)


flash_attention_fwd.launches = 0


def flash_attention_fwd_kv_len(q, k, v, kv_len: int, *,
                               causal: bool = False):
    """The forward with keys at positions >= ``kv_len`` masked (padding),
    causal or not, GQA via fewer K/V heads: the one-shot kernels' contract.
    The padded query rows attend to the first ``kv_len`` keys like any
    other row, so their lse stays finite for the backward.

    CUDA tensors go through ``csrc/flash_fwd.cu`` given ``kv_len`` (counted
    in this function's ``launches``); CPU tensors through the plain
    version."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of Hkv={k.shape[2]}")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len={kv_len} outside [1, {k.shape[1]}]")
    if q.is_cuda:
        out = _flash_fwd_cuda(q, k, v, causal, kv_len)
        flash_attention_fwd_kv_len.launches += 1
        return out
    return flash_attention_fwd_plain(q, k, v, causal=causal, kv_len=kv_len)


flash_attention_fwd_kv_len.launches = 0


# ---------------------------------------------------------------------------
# Flash attention backward (replaces _dq_kernel, _dkv_kernel,
# _oneshot_bwd_kernel, _oneshot_bwd_kernel_chunked, _stream_bwd_kernel)
# ---------------------------------------------------------------------------


def _delta(o, do):
    """delta = rowsum(do * o) in fp32, [B, H, Sq]: the XLA einsum the JAX
    package runs outside its backward kernels (on CUDA tensors the
    kernel's pre-pass computes it)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              kv_len: int | None = None):
    """Plain version: the FlashAttention-2 formulas in fp32, as
    ``_dq_kernel``/``_oneshot_bwd_kernel`` write them.

    p = exp(s * scale - lse) is recomputed from the forward's lse; p is
    rounded to do's dtype before dV and ds = p (dp - delta) scale to k's
    dtype before dQ and dK, as the TPU kernels round them for bf16. The
    grads of repeated GQA heads are folded onto their K/V head. Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    op_q, op_k, op_v, op_do = _kernel_operands(q, k, v, do)
    s = _masked_logits(op_q, op_k, causal, kv_len)          # [B, H, Sq, Skv]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", op_do.float(),
                      _repeat_kv(op_v, H).float())
    ds = (p * (dp - _delta(o, do)[..., None]) * scale).to(op_k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(op_k, H).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, op_q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(op_do.dtype).float(),
                      op_do.float())
    if Hkv != H:
        Skv = k.shape[1]
        dk = dk.reshape(B, Skv, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, Skv, Hkv, H // Hkv, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _flash_bwd_fn():
    fn = _build.library("flash_bwd").pdtx_flash_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, kv_len):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash backward kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or \
            o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash backward kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)} do not match")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash backward kernel: lse must be float32 "
                         f"{(B, H, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if kv_len is not None and not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len={kv_len} outside [1, {Skv}]")
    dtypes = (q.dtype, k.dtype, v.dtype)
    q, k, v, do = _kernel_operands(q, k, v, do)
    _check_cuda_args("flash_attention_bwd", dict(q=q, k=k, v=v, do=do),
                     q.dtype)
    _check_cuda_args("flash_attention_bwd", dict(q=q, lse=lse))
    if o.device != q.device:
        raise ValueError(f"flash_attention_bwd: o is on {o.device}, q on "
                         f"{q.device}")
    # The kernel's pre-pass reads o in the operands' dtype and layout (a
    # copy only where o arrives in another dtype or with other strides) and
    # writes delta = rowsum(do * o) into this scratch.
    o = o.to(q.dtype).contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        err = _flash_bwd_fn()(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), B, Sq, Skv, H, Hkv, D,
            int(causal), Skv if kv_len is None else kv_len,
            1.0 / math.sqrt(D), _KERNEL_DTYPES[q.dtype], _stream(q.device))
    _build.check(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return tuple(t.to(dt) for t, dt in zip((dq, dk, dv), dtypes))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        kv_len: int | None = None):
    """Flash attention backward: (dq, dk, dv) from the residuals of
    :func:`flash_attention_fwd` (q, k, v with un-expanded GQA heads, o, lse
    [B, H, Sq]) and the output grad ``do``. CUDA tensors go through
    ``csrc/flash_bwd.cu`` (one launch of its delta pre-pass, dq and dk/dv
    kernels); CPU tensors through the plain version."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of Hkv={k.shape[2]}")
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_len)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     kv_len=kv_len)


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The counterpart of ``flash_attention``'s ``custom_vjp``: the forward
    kernel saves q, k, v (un-expanded GQA heads), o and lse; the backward
    kernel recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False,
                kv_len: int | None = None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.kv_len = kv_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         kv_len=ctx.kv_len)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    kv_len: int | None = None):
    """Flash attention with the plain oracle's semantics, keys at or past
    ``kv_len`` masked when it is given, differentiable through
    :class:`FlashAttention` (forward and backward kernels on CUDA tensors,
    their plain versions on CPU ones)."""
    return FlashAttention.apply(q, k, v, causal, kv_len)


# ---------------------------------------------------------------------------
# Paged decode attention (replaces _paged_decode_kernel)
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                 positions):
    """Gather-based plain version, after the JAX ``_paged_decode_xla``:
    the one-token window of :func:`paged_prefill_attention` (materialise
    each request's logical K/V from the pool, then masked fp32 softmax with
    the query heads grouped per KV head)."""
    return paged_prefill_attention(q[:, None], k_pages, v_pages, page_table,
                                   positions[:, None])[:, 0]


@functools.cache
def _paged_decode_fn():
    fn = _build.library("paged_decode").pdtx_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _paged_decode_cuda(q, k_pages, v_pages, page_table, positions):
    B, H, D = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if k_pages.shape[-1] != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged decode kernel: pools {tuple(k_pages.shape)}"
                         f" / {tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.shape[0] != B or positions.shape != (B,):
        raise ValueError("paged decode kernel: page_table [B, max_pages] and "
                         "positions [B] must match q's batch")
    out_dtype = q.dtype
    q, k_pages, v_pages = _kernel_operands(q, k_pages, v_pages)
    _check_cuda_args("paged_decode_attention",
                     dict(q=q, k_pages=k_pages, v_pages=v_pages), q.dtype)
    _check_cuda_args("paged_decode_attention",
                     dict(q=q, page_table=page_table, positions=positions))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _paged_decode_fn()(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
            _ptr(positions), _ptr(out), B, H, Hkv, D, page_size,
            page_table.shape[1], 1.0 / math.sqrt(D), _KERNEL_DTYPES[q.dtype],
            _stream(q.device))
    _build.check(err, "paged_decode")
    paged_decode_attention.launches += 1
    return out.to(out_dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, positions,
                           impl: str = "auto"):
    """Decode-mode attention through a paged KV cache.

    q:          [B, H, D] — ONE query token per request
    k_pages:    [num_pages, page_size, Hkv, D] pool (one layer's K)
    v_pages:    same shape, the layer's V
    page_table: [B, max_pages] int32 physical page ids; entries past a
                request's length are never read
    positions:  [B] int32 position of the query token; keys at positions
                <= positions[b] are attended (the query's own K/V must
                already be appended)

    ``impl``: "auto" launches ``csrc/paged_decode.cu`` for CUDA tensors and
    takes the plain version for CPU tensors; "xla" is the gather-based plain
    version on any device (the JAX package's "xla").
    """
    B, H, D = q.shape
    num_kv_heads = k_pages.shape[2]
    if H % num_kv_heads:
        raise ValueError(f"H={H} not a multiple of Hkv={num_kv_heads}")
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown paged decode impl {impl!r}")
    page_table = page_table.to(torch.int32)
    positions = positions.to(torch.int32)
    if impl == "auto" and q.is_cuda:
        return _paged_decode_cuda(q, k_pages, v_pages, page_table, positions)
    return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                        positions)


paged_decode_attention.launches = 0


def paged_prefill_attention(q, k_pages, v_pages, page_table, positions):
    """Prefill-window attention against a paged KV cache with history.

    q:          [B, S, H, D] — a window of query tokens starting mid-sequence
    k_pages:    [num_pages, page_size, Hkv, D] pool (one layer's K)
    v_pages:    same shape, the layer's V
    page_table: [B, max_pages] int32 physical page ids
    positions:  [B, S] int32 logical position of each query token; keys at
                pool positions <= positions[b, s] are attended

    Plain PyTorch on every device (fp32 softmax, GQA grouped per KV head
    without repeating K/V), as the JAX package computes it in XLA.
    """
    B, S, H, D = q.shape
    num_kv_heads = k_pages.shape[2]
    if H % num_kv_heads:
        raise ValueError(f"H={H} not a multiple of Hkv={num_kv_heads}")
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    T = k.shape[1]
    G = H // num_kv_heads
    qg = q.reshape(B, S, num_kv_heads, G, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(D))
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= positions.long()[:, :, None])                   # [B, S, T]
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    prob = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", prob, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
