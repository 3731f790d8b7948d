"""Ragged grouped expert matmul: the CUDA kernels and their plain versions.

Counterpart of ``pytorch_distributed_training_example_tpu/ops/
grouped_matmul.py``, the dropless MoE's expert products over the
expert-sorted rows that ``parallel/moe.routing_stats`` lays out: expert
``e`` owns the contiguous segment ``[starts[e], starts[e] + counts[e])``,
the segments tile ``[0, Tk)`` in expert order, and ``starts``/``counts``
are int32 ``[E]`` tensors on the rows' device (no host sync reads them).

- :func:`grouped_matmul` replaces ``_gmm_kernel`` (via ``_gmm_call``):
  ``out[r] = x[r] @ w[e]`` with fp32 accumulation, output in x's dtype;
  ``transpose_w`` reads ``w[e]`` transposed in place (the backward's dx).
  Kernel: ``csrc/grouped_matmul.cu`` ``pdtx_gmm``.
- :func:`grouped_matmul_dw` replaces ``_gmm_dw_kernel`` (via
  ``_gmm_dw_call``): ``dw[e] = sum over e's segment of x_r^T dout_r`` in
  fp32, zero for an empty expert. Kernel: ``pdtx_gmm_dw``.
- :class:`GroupedMatmul` is the counterpart of ``gmm``'s ``custom_vjp``
  (dx through the first kernel against ``w`` transposed, dw through the
  second, cast to w's dtype); :func:`gmm` and :func:`grouped_ffn` are the
  JAX package's entry points.

The JAX kernels pad every segment to whole tiles for XLA's static shapes;
the CUDA kernels mask the ragged rows instead, and the plain versions loop
over the segments. Each wrapper launches its kernel for CUDA tensors (or
raises) and takes its plain version only for CPU tensors; each carries
``launches``, a plain integer that counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorch_distributed_training_example_tpu_torch.ops import _build
from pytorch_distributed_training_example_tpu_torch.ops.flash_attention import (
    _KERNEL_DTYPES, _check_cuda_args, _ptr, _stream)


def _segments(group_starts, group_counts):
    """(expert, first row, row count) of each non-empty segment, read on
    the host: the plain versions' loop."""
    return [(e, s, c) for e, (s, c) in enumerate(
        zip(group_starts.tolist(), group_counts.tolist())) if c]


def _check_args(what: str, x, w_or_dout, group_starts, group_counts):
    if x.dtype not in _KERNEL_DTYPES or w_or_dout.dtype != x.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {w_or_dout.dtype}")
    if group_starts.shape != group_counts.shape or group_starts.ndim != 1:
        raise ValueError(f"{what}: group_starts and group_counts must both "
                         f"be [E], got {tuple(group_starts.shape)} and "
                         f"{tuple(group_counts.shape)}")


def _check_cuda(what: str, tensors: dict, segments: dict) -> None:
    """What the kernels take: every operand contiguous on one card, int32
    segments, 16-byte aligned rows for the bf16 kernels."""
    _check_cuda_args(what, tensors)
    _check_cuda_args(what, segments, torch.int32)
    if next(iter(segments.values())).device != next(
            iter(tensors.values())).device:
        raise ValueError(f"{what}: segments and operands on different devices")
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and (t.shape[-1] % 8
                                          or t.data_ptr() % 16):
            raise ValueError(f"{what}: bf16 {name} needs 16-byte aligned "
                             f"rows (a multiple of 8 columns), got "
                             f"{tuple(t.shape)}")


# ---------------------------------------------------------------------------
# gmm (replaces _gmm_kernel)
# ---------------------------------------------------------------------------


def grouped_matmul_plain(x, w, group_starts, group_counts, *,
                         transpose_w: bool = False):
    """Plain version: one fp32 product per non-empty segment, rounded to
    x's dtype (the TPU kernel's ``preferred_element_type=float32``)."""
    N = w.shape[1] if transpose_w else w.shape[2]
    out = torch.zeros((x.shape[0], N), dtype=x.dtype, device=x.device)
    for e, s, c in _segments(group_starts, group_counts):
        we = w[e].float()
        out[s:s + c] = (x[s:s + c].float() @ (we.T if transpose_w else we)
                        ).to(x.dtype)
    return out


@_build.cached("grouped_matmul")
def _gmm_fn():
    fn = _build.library("grouped_matmul").pdtx_gmm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gmm_cuda(x, w, group_starts, group_counts, transpose_w):
    E = w.shape[0]
    N, K = (w.shape[1], w.shape[2]) if transpose_w else (w.shape[2],
                                                         w.shape[1])
    if x.shape[1] != K or group_starts.shape[0] != E:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) and "
                         f"{group_starts.shape[0]} segments do not match")
    _check_cuda("grouped_matmul", dict(x=x, w=w),
                dict(group_starts=group_starts, group_counts=group_counts))
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _gmm_fn()(
            _ptr(x), _ptr(w), _ptr(group_starts), _ptr(group_counts),
            _ptr(out), x.shape[0], E, K, N, int(transpose_w),
            _KERNEL_DTYPES[x.dtype], _stream(x.device))
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


def grouped_matmul(x, w, group_starts, group_counts, *,
                   transpose_w: bool = False):
    """``out[r] = x[r] @ w[e]`` over the expert segments: x ``[Tk, K]``, w
    ``[E, K, N]`` (or ``[E, N, K]`` read transposed when ``transpose_w``)
    -> ``[Tk, N]`` in x's dtype. CUDA tensors go through
    ``csrc/grouped_matmul.cu``; CPU tensors through the plain version."""
    _check_args("grouped_matmul", x, w, group_starts, group_counts)
    if x.is_cuda:
        return _gmm_cuda(x, w, group_starts, group_counts, transpose_w)
    return grouped_matmul_plain(x, w, group_starts, group_counts,
                                transpose_w=transpose_w)


grouped_matmul.launches = 0


# ---------------------------------------------------------------------------
# gmm_dw (replaces _gmm_dw_kernel)
# ---------------------------------------------------------------------------


def grouped_matmul_dw_plain(x, dout, group_starts, group_counts):
    """Plain version: ``x[seg]^T @ dout[seg]`` in fp32 per expert."""
    E = group_starts.shape[0]
    dw = torch.zeros((E, x.shape[1], dout.shape[1]), dtype=torch.float32,
                     device=x.device)
    for e, s, c in _segments(group_starts, group_counts):
        dw[e] = x[s:s + c].float().T @ dout[s:s + c].float()
    return dw


@_build.cached("grouped_matmul")
def _gmm_dw_fn():
    """The dw kernel's entry and its workspace query (bytes for Tk, E, M,
    N, dtype: the chunk plan, the split counters, the partial slots)."""
    lib = _build.library("grouped_matmul")
    fn = lib.pdtx_gmm_dw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    workspace = lib.pdtx_gmm_dw_workspace
    workspace.argtypes = [ctypes.c_int] * 5
    workspace.restype = ctypes.c_longlong
    return fn, workspace


def _gmm_dw_cuda(x, dout, group_starts, group_counts):
    if dout.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_matmul_dw: x {tuple(x.shape)} and dout "
                         f"{tuple(dout.shape)} have other row counts")
    _check_cuda("grouped_matmul_dw", dict(x=x, dout=dout),
                dict(group_starts=group_starts, group_counts=group_counts))
    Tk, E, M, N = x.shape[0], group_starts.shape[0], x.shape[1], \
        dout.shape[1]
    fn, workspace = _gmm_dw_fn()
    dtype = _KERNEL_DTYPES[x.dtype]
    dw = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace(Tk, E, M, N, dtype), dtype=torch.uint8,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(dout), _ptr(group_starts), _ptr(group_counts),
                 _ptr(dw), _ptr(ws), Tk, E, M, N, dtype, _stream(x.device))
    _build.check(err, "grouped_matmul_dw")
    grouped_matmul_dw.launches += 1
    return dw


def grouped_matmul_dw(x, dout, group_starts, group_counts):
    """``dw[e] = sum over e's segment of x_r^T dout_r``: x ``[Tk, M]``,
    dout ``[Tk, N]`` -> fp32 ``[E, M, N]``, zeros for an empty expert. CUDA
    tensors go through ``csrc/grouped_matmul.cu``; CPU tensors through the
    plain version."""
    _check_args("grouped_matmul_dw", x, dout, group_starts, group_counts)
    if x.is_cuda:
        return _gmm_dw_cuda(x, dout, group_starts, group_counts)
    return grouped_matmul_dw_plain(x, dout, group_starts, group_counts)


grouped_matmul_dw.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """The counterpart of ``gmm``'s ``custom_vjp``: dx = gmm(dout, w^T)
    through the forward kernel reading w transposed, dw through the dw
    kernel, summed in fp32 and cast to w's dtype."""

    @staticmethod
    def forward(ctx, x, w, group_starts, group_counts):
        ctx.save_for_backward(x, w, group_starts, group_counts)
        return grouped_matmul(x, w, group_starts, group_counts)

    @staticmethod
    def backward(ctx, dout):
        x, w, starts, counts = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul(dout, w, starts, counts, transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dout, starts, counts).to(w.dtype)
        return dx, dw, None, None


def gmm(x, w, group_starts, group_counts):
    """Grouped matmul over contiguous per-expert segments, differentiable in
    x and w: the JAX ``gmm``."""
    return GroupedMatmul.apply(x, w, group_starts, group_counts)


def grouped_ffn(x, w_up, w_down, group_starts, group_counts):
    """The grouped expert MLP ``gelu(x @ w_up[e]) @ w_down[e]`` per segment
    (the JAX ``grouped_ffn``): fp32 accumulation, h rounded to x's dtype
    before the tanh-approximate gelu (flax's default)."""
    h = gmm(x, w_up, group_starts, group_counts)
    h = F.gelu(h, approximate="tanh")
    return gmm(h, w_down, group_starts, group_counts)
