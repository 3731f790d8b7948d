"""Fused BN-apply/ReLU -> 1x1-conv matmul -> BN statistics: the CUDA kernel
and its plain PyTorch version.

Counterpart of ``pytorch_distributed_training_example_tpu/ops/
fused_bn_matmul.py``. Its Pallas kernel ``_kernel`` (via
``fused_stats_matmul``) is ported as ``csrc/fused_bn_matmul.cu``: one pass
over the activation of a ResNet bottleneck's 1x1 conv, as the matmul
``[B*H*W, Cin] @ [Cin, Cout]`` in NHWC,

- prologue: the previous BatchNorm's per-channel fold ``x * scale + bias``
  and ReLU (each optional), computed in fp32 and rounded once to w's dtype;
- body: ``y = x' @ w`` with fp32 accumulation, y in x's dtype;
- epilogue: per-column ``sum(y)`` and ``sum(y^2)`` of the fp32 product, the
  statistics the next BatchNorm needs, without reading y again.

:func:`fused_stats_matmul` launches the kernel for CUDA tensors (or raises)
and takes :func:`fused_stats_matmul_plain` only for CPU tensors; there is no
fallback. ``fused_stats_matmul.launches`` counts kernel launches and nothing
else. :func:`bn_stats_matmul` returns ``(y, mean, biased var)``, the JAX
wrapper's contract.

What the TPU layout asked for and the port leaves out: the ``[8, C]`` stats
tile (``STATS_ROWS``; stats here are ``[2, C]``), the padding of C to 128
lanes (any C the kernel takes, a multiple of 8 in bf16), the row block
``block_n`` and its divisibility assert (the kernel masks a ragged last row
tile), ``out_dtype`` (y is in x's dtype, the JAX default) and
``interpret``. The JAX prologue rounds ``x * scale`` and ``+ bias`` to x's
dtype; here both are fp32 and the result is rounded once, so in bf16 the
matmul's input can differ from the JAX kernel's by one ulp.

Nothing in the port's ResNet calls this, as nothing in the JAX package's
does: its entry point is the bench (``bench/fused_bn_bench.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pytorch_distributed_training_example_tpu_torch.ops import _build
from pytorch_distributed_training_example_tpu_torch.ops.flash_attention import (
    _KERNEL_DTYPES, _check_cuda_args, _ptr, _sm_count, _stream,
    arrival_counters)

_AFFINE, _RELU = 1, 2  # the kernel's flags
#: Persistent blocks an SM: the bf16 kernel takes a whole SM, five fp32
#: blocks share one.
_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 5}


class Schedule(NamedTuple):
    """The kernel's persistent schedule (``_bn_schedule``)."""
    chunk: int            # columns of y a block takes
    tile_rows: int        # rows of a tile
    n_chunks: int         # ceil(C / chunk)
    n_tiles: int          # ceil(N / tile_rows)
    slots: int            # blocks a chunk; the partials of a column
    grid: int             # slots * n_chunks
    tiles_per_block: int  # the most tiles a block walks
    workspace: int        # fp32 partials: slots * 2 * C
    counters: int         # arrival counters: one


def _bn_schedule(N: int, C: int, dtype: torch.dtype,
                 sm_count: int) -> Schedule:
    """Grid, tiles, workspace and counters of ``csrc/fused_bn_matmul.cu``
    for x ``[N, K]`` @ w ``[K, C]``, from sizes the host knows. The columns
    are cut into chunks (bf16: one chunk of 64 or 128 columns in 128-row
    tiles up to C = 128, chunks of 256 in 64-row tiles above; fp32: chunks
    of 64 in 64-row tiles); each chunk gets ``slots`` persistent blocks,
    no more than its tiles, and block b takes chunk ``b % n_chunks`` and
    its tiles ``b // n_chunks + i * slots``. Each block writes one
    ``[2, chunk]`` partial into row ``b // n_chunks`` of the ``[slots, 2,
    C]`` workspace; the last block to arrive sums each column's ``slots``
    partials in slot order."""
    if dtype == torch.bfloat16:
        chunk = 64 if C <= 64 else 128 if C <= 128 else 256
        tile_rows = 64 if chunk == 256 else 128
    else:
        chunk, tile_rows = 64, 64
    n_chunks = -(-C // chunk)
    n_tiles = -(-N // tile_rows)
    slots = max(1, min(n_tiles, _BLOCKS_PER_SM[dtype] * sm_count // n_chunks))
    return Schedule(chunk, tile_rows, n_chunks, n_tiles, slots,
                    slots * n_chunks, -(-n_tiles // slots), slots * 2 * C, 1)


def _check_args(x, w, scale, bias) -> None:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_stats_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [N, K] and [K, C]")
    if x.shape[0] < 1:
        raise ValueError("fused_stats_matmul: x has no rows")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"fused_stats_matmul takes float32 or bfloat16 x and "
                        f"w of one dtype, got {x.dtype} and {w.dtype}")
    for name, v in (("scale", scale), ("bias", bias)):
        if v is not None and v.numel() != x.shape[1]:
            raise ValueError(f"fused_stats_matmul: {name} has {v.numel()} "
                             f"values for {x.shape[1]} channels")


def _affine_vectors(x, scale, bias):
    """fp32 ``[K]`` scale and bias for an affine prologue (a missing one is
    ones or zeros, as in the JAX wrapper), or (None, None) for none."""
    if scale is None and bias is None:
        return None, None
    K = x.shape[1]
    s = (torch.ones(K, device=x.device) if scale is None
         else scale.reshape(K).float().contiguous())
    b = (torch.zeros(K, device=x.device) if bias is None
         else bias.reshape(K).float().contiguous())
    return s, b


def fused_stats_matmul_plain(x, w, scale=None, bias=None, *,
                             relu: bool = True):
    """Plain version: the prologue in fp32, rounded once to w's dtype, an
    fp32 product, y rounded to x's dtype, stats from the fp32 product."""
    _check_args(x, w, scale, bias)
    s, b = _affine_vectors(x, scale, bias)
    xf = x.float()
    if s is not None:
        xf = xf * s + b
    if relu:
        xf = torch.relu(xf)
    acc = xf.to(w.dtype).float() @ w.float()
    stats = torch.stack([acc.sum(0), (acc * acc).sum(0)])
    return acc.to(x.dtype), stats


@_build.cached("fused_bn_matmul")
def _kernel_fn():
    fn = _build.library("fused_bn_matmul").pdtx_bn_matmul
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fused_cuda(x, w, scale, bias, relu):
    s, b = _affine_vectors(x, scale, bias)
    _check_cuda_args("fused_stats_matmul", dict(
        x=x, w=w, **({} if s is None else dict(scale=s, bias=b))))
    N, K = x.shape
    C = w.shape[1]
    if x.dtype == torch.bfloat16 and (K % 8 or C % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError(f"fused_stats_matmul: bf16 x and w need 16-byte "
                         f"aligned rows (K and C multiples of 8), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    flags = (_AFFINE if s is not None else 0) | (_RELU if relu else 0)
    plan = _bn_schedule(N, C, x.dtype, _sm_count(x.device.index))
    y = torch.empty((N, C), dtype=x.dtype, device=x.device)
    partial = torch.empty(plan.workspace, dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, C), dtype=torch.float32, device=x.device)
    counter = arrival_counters("fused_bn_matmul", x.device, plan.counters)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            _ptr(x), _ptr(w), null if s is None else _ptr(s),
            null if b is None else _ptr(b), _ptr(y), _ptr(partial),
            _ptr(stats), _ptr(counter), N, K, C, flags,
            _KERNEL_DTYPES[x.dtype], plan.chunk, plan.slots,
            _stream(x.device))
    _build.check(err, "fused_stats_matmul")
    fused_stats_matmul.launches += 1
    return y, stats


def fused_stats_matmul(x, w, scale=None, bias=None, *, relu: bool = True):
    """``y = maybe_relu(x * scale + bias) @ w`` plus the column sums and
    sums of squares of y: x ``[N, K]``, w ``[K, C]`` (float32 or bfloat16,
    one dtype), scale and bias ``[K]`` or ``[1, K]`` (None: no affine).
    Returns (y ``[N, C]`` in x's dtype, stats ``[2, C]`` fp32 with
    ``stats[0] = sum(y)``, ``stats[1] = sum(y^2)`` over the rows, from the
    fp32 product). CUDA tensors go through ``csrc/fused_bn_matmul.cu``;
    CPU tensors through the plain version."""
    _check_args(x, w, scale, bias)
    if x.is_cuda:
        return _fused_cuda(x, w, scale, bias, relu)
    return fused_stats_matmul_plain(x, w, scale, bias, relu=relu)


fused_stats_matmul.launches = 0


def bn_stats_matmul(x, w, scale=None, bias=None, *, relu: bool = True):
    """``(y, mean, var)`` of the output: a drop-in for ``relu(x*s+b) @ w``
    then the moments of y over its rows (var biased, ``E[y^2] - E[y]^2``
    as the JAX wrapper computes it)."""
    y, stats = fused_stats_matmul(x, w, scale, bias, relu=relu)
    n = x.shape[0]
    mean = stats[0] / n
    var = stats[1] / n - mean * mean
    return y, mean, var
