#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``<package>/csrc`` with nvcc, holds each
kernel against its plain PyTorch version at the shapes the serving and
training paths give it (bf16 and fp32), times kernel, plain version, library
call and bound, then drives the two main paths through the port's entry
point: serving ``llama3_8b`` at full width and depth in bf16 (plus the
long-prompt path: flash prefill + paged decode, profiled), and training
``gpt2_124m`` at full width and depth in bf16 (global batch 256 as 16
microbatches of 16 x 1024 tokens, profiled), and training ``llama_moe``
(12 layers, d 1024, 8 experts top-2) at full width and depth in bf16 under
dropless dispatch and the fused router (32 x 2048 tokens a step as 8
microbatches, profiled), and training ``vit_b16_imagenet`` (ViT-B/16 on
synthetic ImageNet, 197 tokens through the padded flash path) at full
width and depth in bf16 (global batch 1024 as 8 microbatches of 128,
profiled, and timed against the plain attention path). It runs the fused
BN-stats matmul's bench (the kernel's entry point, at the ResNet-50
bottleneck shapes) and trains ``resnet50_imagenet`` (ResNet-50 on synthetic
ImageNet) at full width and depth in bf16 (global batch 1024 as 4
microbatches of 256, profiled, with an eval). It checks greedy token
identity between the kernel and plain serving paths, and loss and gradient
identity between the kernel and plain training paths, at fp32, for GPT-2,
for the MoE model and for ViT, and ResNet's loss, gradients and running
statistics on the card against the CPU's.
Each phase prints one JSON line; the ``kernels`` line and then
``{"ok": true, "device": ...}`` close the run. Any failed phase raises, so the exit code is non-zero and no
``ok`` line is printed.

Run from the repository root: ``python3 chip_smoke.py`` (one GPU, nvcc under
``/usr/local/cuda`` or ``$CUDA_HOME``). Without CUDA, or without the port's
package beside this script, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "pytorch_distributed_training_example_tpu_torch"

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): device memory, bf16
# tensor cores, fp32 outside the tensor cores (the fp32 kernels' units).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Backward grads span orders of magnitude (late keys and rows of a causal
# sequence get small ones), so each element is held to its own scale,
# |got - ref| <= rtol |ref| + c rms(ref), and each tensor's relative L2
# error to a bound: (rtol, c, L2) below. For bf16, c is four eps: kernel and
# plain version round p and ds from scores summed in another order, and a
# rounding that flips moves one term of a sum by an ulp.
BWD_TOL = {"bfloat16": (2e-2, 2.0 ** -5, 5e-3), "float32": (1e-4, 1e-4, 1e-5)}
LSE_TOL = 1e-3
# Paged decode outputs, relative L2 error: bf16 rounds the probabilities
# before P V and the output (2^-9 relative each, ~2e-3 together); fp32 sums
# in another order.
PAGED_L2 = {"bfloat16": 5e-3, "float32": 1e-5}
LAYERS = 32        # llama3_8b: each kernel launches once per layer per forward
DECODE_BUCKETS = (1, 2, 4, 8)   # the engine's default, warmed once each
ENGINE_TABLE_WIDTH = 255   # the page table's columns at --serve-num-pages 256
GPT2_LAYERS = 12   # gpt2_124m: one flash fwd and bwd per layer per microbatch
GRAD_ACCUM = 16    # the preset's global batch of 256 as 16 x 16 sequences
TRAIN_STEPS = 4
GRAD_TOL = 1e-4    # fp32 grads, kernel vs plain path, relative to the max
                   # (sums over 1024 keys in another order: ~1e-6 expected)
# Grouped matmul outputs, rounded to the operand dtype on both sides, in
# BWD_TOL's form: a bf16 element differs where the two fp32 sums round to
# neighbouring values, one ulp, at most 2^-7 |ref|.
GMM_TOL = {"bfloat16": (2.0 ** -6, 2.0 ** -8, 5e-3),
           "float32": (1e-4, 1e-5, 1e-5)}
ROUTER_TOL = 1e-6  # fp32 gates, lse, mean probabilities (sums of 8 terms)
MOE_E, MOE_D, MOE_F, MOE_TK = 8, 1024, 2048, 16384  # llama_moe, 4 x 2048 x 2
MOE_LAYERS, MOE_GRAD_ACCUM, MOE_STEPS = 12, 8, 4
# The MoE training command (ROADMAP slice 3), logged every step, with the
# epoch-end eval off (it is not split into microbatches).
MOE_ARGV = ["--model", "llama_moe", "--dataset", "lm", "--seq-len", "2048",
            "--batch-size", "32", "--grad-accum", str(MOE_GRAD_ACCUM),
            "--optimizer", "adamw", "--lr", "3e-4", "--weight-decay", "0.1",
            "--grad-clip", "1.0", "--precision", "bf16", "--epochs", "1",
            "--steps-per-epoch", str(MOE_STEPS), "--moe-dispatch", "dropless",
            "--moe-router-impl", "fused", "--log-every", "1",
            "--eval-every-epochs", "2"]
# The planted fault of the dw check: the dw plan leaves the first 64-row
# slice of expert 1's first row chunk out.
DROPPED_ROWS = (
    "      const int k0 = start[e] + j * s;\n",
    "      const int k0 = start[e] + j * s + (e == 1 && j == 0 ? kSliceK : 0);\n")
# The planted fault of the gmm check: work item 0 (the first row tile's
# first column tile) leaves its last 64-deep K slice out.
DROPPED_SLICE = ("    n_k = (a.K + kSliceK - 1) / kSliceK;\n",
                 "    n_k = (a.K + kSliceK - 1) / kSliceK - (i == 0);\n")
# The ViT training command (ROADMAP slice 4), logged every step, warmed up
# over its 4 steps, the epoch-end eval off (the profile phase runs it).
VIT_LAYERS, VIT_GRAD_ACCUM, VIT_STEPS = 12, 8, 4
VIT_ARGV = ["--config", "vit_b16_imagenet", "--attn-impl", "flash",
            "--grad-accum", str(VIT_GRAD_ACCUM), "--epochs", "1",
            "--steps-per-epoch", str(VIT_STEPS), "--log-every", "1",
            "--eval-every-epochs", "2"]
# The planted fault of the kv_len forward check: the kernel ignores kv_len
# and attends to the padded keys too.
IGNORED_KV_LEN = (
    "  if (kv_len < 1 || kv_len > Skv) return (int)cudaErrorInvalidValue;\n",
    "  kv_len = Skv;  // planted fault: kv_len ignored\n")
# The planted fault of the causal forward check: the wgmma kernel leaves the
# tiles that cross the diagonal unmasked.
UNMASKED_DIAGONAL = (
    "  const bool edge = (causal && k0 + kBN - 1 > qw0) || k0 + kBN > kvl;\n",
    "  const bool edge = k0 + kBN > kvl;  // planted fault: diagonal open\n")
# The XU pipe (ex2, the bf16 packs) of an H100 SM issues 16 operations a
# clock; the forward spends one ex2 and half a pack on each visible pair.
XU_OPS_PER_SM_CLOCK, XU_OPS_PER_PAIR = 16, 1.5
# The fused BN-stats matmul: y in GMM_TOL's form; each column's mean and
# biased variance within BN_STATS_TOL of its root mean square and mean
# square (fp32 sums of the same products in another order: ~1e-6 expected).
BN_STATS_TOL = 1e-5
# Its planted fault: the merge leaves slot 1's partials out (one block's).
DROPPED_PARTIAL = (
    "          const bool in = pp < n_slots && j < n_vals;\n",
    "          const bool in = pp < n_slots && j < n_vals && pp != 1;\n")
# The planted fault of the router check: the merge leaves block 1's
# partial out of probs_mean.
DROPPED_BLOCK = (
    "        const bool in = b < nb;\n",
    "        const bool in = b < nb && b != 1;  // planted fault\n")
# The planted fault of the paged decode check: the combine leaves the last
# split of each (request, KV head) out.
DROPPED_SPLIT = (
    "  const int n_merge = n_live;\n",
    "  const int n_merge = n_live - 1;  // planted fault: last split dropped\n")
# The ResNet-50 training command (ROADMAP slice 5), logged every step, the
# preset's warmup cut to its 4 steps, the epoch-end eval off (the profile
# phase runs it); 4 microbatches of 256 images.
RESNET_GRAD_ACCUM, RESNET_STEPS = 4, 4
RESNET_ARGV = ["--config", "resnet50_imagenet", "--grad-accum",
               str(RESNET_GRAD_ACCUM), "--epochs", "1", "--steps-per-epoch",
               str(RESNET_STEPS), "--log-every", "1", "--eval-every-epochs",
               "2"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, iters: int = 20, clean_l2: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed alone
    with CUDA events. Before each, a 1 GB write evicts the 50 MB L2 (the
    serving loop finds a layer's cache cold) and keeps the card busy for
    ~0.3 ms, longer than the host needs to enqueue ``fn``, so the events
    time the device work and not the Python in front of it. The write
    leaves L2 full of dirty lines, which ``fn``'s reads write back as they
    evict them; with ``clean_l2`` the flush reads the 1 GB instead."""
    flush = torch.zeros(256 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if clean_l2:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} exceeds {tol}")


def grad_errors(got, ref, dt: str) -> tuple[float, float]:
    """The worst |got - ref| / (rtol |ref| + c rms(ref)) over the elements of
    dq, dk and dv (at most 1 passes), and their worst relative L2 error."""
    rtol, c, _ = BWD_TOL[dt]
    tiny = torch.finfo(torch.float32).tiny
    worst = rel_l2 = 0.0
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        diff = (g - r).abs()
        scale = rtol * r.abs() + c * r.square().mean().sqrt()
        worst = max(worst, float((diff / scale.clamp_min(tiny)).max()))
        rel_l2 = max(rel_l2, float(diff.norm() / r.norm().clamp_min(tiny)))
    return worst, rel_l2


def rel_l2(got, ref) -> float:
    g, r = got.float(), ref.float()
    return float((g - r).norm() / r.norm().clamp_min(
        torch.finfo(torch.float32).tiny))


def paged_decode_case(flash, B, positions, dtype, gen, label="", P=640,
                      width=None, fault_lib=None):
    """Random pool and scattered page tables at llama3_8b's decode shapes.
    The table is as wide as the longest request needs, or ``width``
    columns (the serving engine's 255), the entries past a request's
    pages then holding other requests' pages (in range, so the gather-based
    plain version reads them; the kernel must never attend to them). The
    output is held to ``TOL`` and to ``PAGED_L2`` (at long positions the
    outputs are small, so the max error alone does not see a dropped
    split); bf16 is called twice and must give the same bits; with
    ``fault_lib`` the planted-fault build must fail the check. The row is
    timed twice: behind the usual dirty flush and behind a clean one
    (``ms_clean_l2``)."""
    H, Hkv, D, ps = 32, 8, 128, 16
    dt = str(dtype)[6:]
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k_pages = torch.randn(P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn(P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    tight = max(positions) // ps + 1
    width = width or tight
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B, width, dtype=torch.int32, device="cuda")
    used = 0
    for b, pos in enumerate(positions):
        n = pos // ps + 1
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    if width > tight:
        for b, pos in enumerate(positions):
            n = pos // ps + 1
            others = perm[torch.randint(used, (width - n,), generator=gen,
                                        device="cuda")]
            table[b, n:] = others.to(torch.int32)
    pos_t = torch.tensor(positions, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, table, pos_t)
    out = flash.paged_decode_attention(*args)
    again = flash.paged_decode_attention(*args)
    ref = flash.paged_decode_attention(*args, impl="xla")
    torch.cuda.synchronize()
    name = " ".join(x for x in (f"paged_decode B={B}", label, dt) if x)
    err, l2 = max_err(out, ref), rel_l2(out, ref)
    check(name, err, TOL[dt])
    if not l2 <= PAGED_L2[dt]:
        raise AssertionError(f"{name}: relative L2 error {l2} exceeds "
                             f"{PAGED_L2[dt]}")
    reproducible = bool(torch.equal(out, again))
    if dtype == torch.bfloat16 and not reproducible:
        raise AssertionError(f"{name}: two calls differ")
    live = sum(p + 1 for p in positions)
    item = q.element_size()
    nbytes = (2 * live * Hkv * D + 2 * B * H * D) * item \
        + 4 * (B + table.numel())
    ops = 4 * live * H * D
    row = dict(name=name, positions=positions, table_width=width,
               max_abs_err=err, rel_l2=l2, tol=TOL[dt], l2_tol=PAGED_L2[dt],
               reproducible=reproducible,
               ms=time_ms(lambda: flash.paged_decode_attention(*args)),
               ms_clean_l2=time_ms(
                   lambda: flash.paged_decode_attention(*args), clean_l2=True),
               plain_ms=time_ms(
                   lambda: flash.paged_decode_attention(*args, impl="xla")),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dt)
    if fault_lib is not None:
        with planted("paged_decode", fault_lib):
            bad = flash.paged_decode_attention(*args)
        torch.cuda.synchronize()
        row["planted_fault"] = dict(max_abs_err=max_err(bad, ref),
                                    rel_l2=rel_l2(bad, ref))
        if max_err(bad, ref) <= TOL[dt] and rel_l2(bad, ref) <= PAGED_L2[dt]:
            raise AssertionError(f"{name}: the planted fault (a dropped "
                                 f"split) passed the check: "
                                 f"{row['planted_fault']}")
    return row


def planted(name, lib_path):
    """A block in which ``csrc/<name>.cu``'s library is the planted-fault
    build at ``lib_path``."""
    from pytorch_distributed_training_example_tpu_torch.ops import _build

    return _build.using(name, ctypes.CDLL(lib_path))


def flash_case(flash, name, B, S, H, Hkv, D, dtype, gen, sm_clock_hz,
               fault_lib=None):
    """The causal forward (K1f) against its plain version at one shape,
    [B, S, H, D]: llama3_8b's prefill, the training microbatches of gpt2
    and llama_moe, and head_dim 256. Two calls must give the same bits; with
    ``fault_lib``, the same check must fail a build that leaves the
    diagonal tiles unmasked."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    dt = str(dtype)[6:]
    name = f"flash_fwd {name} {dt}"
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)

    def errors():
        out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        return max_err(out, ref), max_err(lse, ref_lse), out, lse

    err, lse_err, out, lse = errors()
    check(name, err, TOL[dt])
    check(name + " lse", lse_err, LSE_TOL)
    again = flash.flash_attention_fwd(q, k, v, causal=True)
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        raise AssertionError(f"{name}: a second call gave other bits")
    fault = None
    if fault_lib is not None:
        with planted("flash_fwd", fault_lib):
            f_err, f_lse = errors()[:2]
        if f_err <= TOL[dt] and f_lse <= LSE_TOL:
            raise AssertionError(f"the causal check passed the planted "
                                 f"fault: {f_err}, {f_lse}")
        fault = dict(fault="diagonal tiles unmasked", max_abs_err=f_err,
                     lse_max_abs_err=f_lse, tol=TOL[dt])
    del out, lse, again
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    item = q.element_size()
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * item + 4 * B * H * S
    ops = 2 * B * H * S * S * D
    pairs = B * H * S * (S + 1) // 2  # visible (query, key) pairs
    row = dict(name=name, shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D,
                                     causal=True),
               max_abs_err=err, lse_max_abs_err=lse_err, tol=TOL[dt],
               reproducible=True, planted_fault=fault,
               ms=time_ms(lambda: flash.flash_attention_fwd(
                   q, k, v, causal=True)),
               plain_ms=time_ms(lambda: flash.flash_attention_fwd_plain(
                   q, k, v, causal=True), iters=5),
               library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                               enable_gqa=Hkv != H)),
               library="SDPA fwd, causal")
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dt)
    if dt == "bfloat16" and sm_clock_hz:
        # The XU pipe's least time for the exponentials and packs alone,
        # at the card's largest SM clock.
        row["xu_floor_ms"] = 1e3 * pairs * XU_OPS_PER_PAIR / (
            XU_OPS_PER_SM_CLOCK * torch.cuda.get_device_properties(
                0).multi_processor_count * sm_clock_hz)
    return row


def kv_len_mask(S, causal, kv_len):
    """The boolean [S, S] mask (True = attend) of a kv_len / causal call,
    for SDPA; None when neither applies."""
    if kv_len is None and not causal:
        return None
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] < (S if kv_len is None else kv_len)
    return mask & (pos[None, :] <= pos[:, None]) if causal else mask


def flash_kv_len_case(flash, name, B, S, H, Hkv, D, causal, kv_len, dtype,
                      gen, fault_lib=None):
    """The forward with kv_len (K1o) against its plain version on one shape,
    with random, non-zero values in the padded rows; with ``fault_lib``,
    the same check must fail a build that ignores kv_len."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    dt = str(dtype)[6:]
    kw = dict(causal=causal, kv_len=kv_len)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, **kw)

    def errors():
        out, lse = flash.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(lse).all())
        return max_err(out, ref), max_err(lse, ref_lse), finite

    err, lse_err, finite = errors()
    if not (err <= TOL[dt] and lse_err <= LSE_TOL and finite):
        raise AssertionError(f"flash_fwd_kv_len {name} {dt}: max abs error "
                             f"{err}, lse {lse_err}, finite lse {finite}")
    fault = None
    if fault_lib is not None:
        with planted("flash_fwd", fault_lib):
            f_err, f_lse, _ = errors()
        if f_err <= TOL[dt] and f_lse <= LSE_TOL:
            raise AssertionError(f"the kv_len check passed the planted "
                                 f"fault: {f_err}, {f_lse}")
        fault = dict(fault="kv_len ignored", max_abs_err=f_err,
                     lse_max_abs_err=f_lse, tol=TOL[dt])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = kv_len_mask(S, causal, kv_len)
    keys = S if kv_len is None else kv_len
    pairs = (sum(min(i + 1, keys) for i in range(S)) if causal
             else S * keys)
    item = q.element_size()
    # q and out whole, k and v up to kv_len (the keys the function needs),
    # lse; QK^T and PV over the visible pairs.
    nbytes = (2 * B * S * H * D + 2 * B * keys * Hkv * D) * item \
        + 4 * B * H * S
    row = dict(name=f"flash_fwd_kv_len {name} {dt}", shape=dict(
        B=B, S=S, H=H, Hkv=Hkv, D=D, causal=causal, kv_len=kv_len),
        max_abs_err=err, lse_max_abs_err=lse_err, tol=TOL[dt],
        planted_fault=fault,
        ms=time_ms(lambda: flash.flash_attention_fwd(q, k, v, **kw)),
        plain_ms=time_ms(lambda: flash.flash_attention_fwd_plain(
            q, k, v, **kw), iters=5),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=Hkv != H)),
        library="SDPA with the boolean key mask")
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * B * H * D * pairs,
                                             dt)
    return row


def flash_bwd_case(flash, name, B, S, H, Hkv, D, causal, kv_len, dtype,
                   gen):
    """Backward kernel against its plain version on one shape: dq, dk, dv
    from the same q, k, v, do and the plain forward's o and lse."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             kv_len=kv_len)
    o = o.contiguous()
    kw = dict(causal=causal, kv_len=kv_len)
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ref = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    dt = str(dtype)[6:]
    # No atomics: a second call gives the same bits.
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_bwd {name} {dt}: a second call gave "
                             "other gradients")
    err = max(max_err(a, b) for a, b in zip(got, ref))
    worst, rel_l2 = grad_errors(got, ref, dt)
    if not (worst <= 1 and rel_l2 <= BWD_TOL[dt][2]):
        raise AssertionError(
            f"flash_bwd {name} {dt}: worst error {worst} of its elementwise "
            f"bound (max 1), relative L2 {rel_l2} (max {BWD_TOL[dt][2]})")
    # SDPA's backward at the same shape: fwd+bwd minus fwd (a yardstick;
    # the port never calls it).
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    mask = None if kv_len is None else (
        torch.arange(S, device="cuda") < kv_len)[None, None, None, :]
    dot = do.transpose(1, 2)

    def lib_fwd():
        return sdpa(*leaves, attn_mask=mask, is_causal=causal,
                    enable_gqa=Hkv != H)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), leaves, dot)

    item = q.element_size()
    keys = S if kv_len is None else kv_len
    pairs = S * (S + 1) // 2 if causal else S * keys
    nbytes = (4 * B * S * H * D + 4 * B * S * Hkv * D) * item + 4 * B * H * S
    ops = 5 * 2 * B * H * D * pairs  # 5 products over the visible pairs
    row = dict(name=f"flash_bwd {name} {dt}", shape=dict(
        B=B, S=S, H=H, Hkv=Hkv, D=D, causal=causal, kv_len=kv_len),
        max_abs_err=err, err_over_bound=worst, rel_l2_err=rel_l2,
        reproducible=True,
        tol=dict(zip(("rtol", "c_rms", "rel_l2"), BWD_TOL[dt])),
        ms=time_ms(lambda: flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                     **kw)),
        plain_ms=time_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), iters=5),
        library_ms=time_ms(lib_fwd_bwd) - time_ms(lib_fwd))
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dt)
    # The two-pass kernel recomputes s and dp in its second pass: 7
    # products, its own floor.
    row["floor_7_products_ms"] = bound(nbytes, ops * 7 / 5, dt)[0]
    # One call's split over its kernels (delta pre-pass, dq, dk/dv).
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "flash_bwd_" in e.name:
            key = e.name.split("flash_bwd_")[-1].split("(")[0]
            split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    row["kernels_ms"] = split
    return row


def kernel_spills(log: str, marker: str) -> dict:
    """Spill bytes (stores + loads) of each kernel whose mangled name holds
    ``marker`` in a ``-Xptxas -v`` log, by mangled name."""
    spills, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif name and "spill stores" in ln:
            if marker in name:
                nums = [int(w) for w in ln.replace(",", " ").split()
                        if w.isdigit()]
                spills[name] = nums[1] + nums[2]
            name = None
    return spills


def elementwise_errors(got, ref, tol) -> tuple[float, float]:
    """The worst |got - ref| / (rtol |ref| + c rms(ref)) over the elements
    (at most 1 passes) and the relative L2 error, for ``tol`` = (rtol, c,
    L2 bound)."""
    rtol, c, _ = tol
    tiny = torch.finfo(torch.float32).tiny
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = rtol * r.abs() + c * r.square().mean().sqrt()
    return (float((diff / scale.clamp_min(tiny)).max()),
            float(diff.norm() / r.norm().clamp_min(tiny)))


def moe_segments(Tk: int, E: int):
    """Uneven routing on the card: expert 0 empty, expert 1 over half the
    rows (its segment ends mid-tile: 8232 = 64 x 128 + 40), the rest spread
    unevenly."""
    heavy = Tk // 2 + 40
    weights = np.arange(1, E - 1)
    rest = np.random.default_rng(7).multinomial(Tk - heavy,
                                                weights / weights.sum())
    return segments_of(np.concatenate([[0, heavy], rest]))


def segments_of(counts):
    """starts and counts, int32 on the card, of segments in expert order."""
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return (torch.from_numpy(starts).cuda(), torch.from_numpy(counts).cuda())


def grouped_mm_ms(fn):
    """``library_ms`` of ``torch._grouped_mm`` where the installed torch has
    it and takes the call, else None and the reason."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm is missing from this torch"
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        return None, f"torch._grouped_mm refused: {str(exc)[:160]}"
    return time_ms(fn), "torch._grouped_mm"


def gmm_case(gmm, name, K, N, transpose_w, dtype, gen, starts, counts,
             fault_lib=None):
    """K4a against its plain version at one llama_moe shape: x [Tk, K] and
    w [E, K, N] (or [E, N, K] read transposed: the backward's dx). Two
    calls must give the same bits; with ``fault_lib``, the same check must
    fail a build that leaves one K slice of one tile out."""
    E, Tk = MOE_E, MOE_TK
    dt = str(dtype)[6:]
    x = torch.randn(Tk, K, generator=gen, device="cuda").to(dtype)
    shape = (E, N, K) if transpose_w else (E, K, N)
    w = (torch.randn(*shape, generator=gen, device="cuda") / K ** 0.5).to(
        dtype)
    args = (x, w, starts, counts)
    got = gmm.grouped_matmul(*args, transpose_w=transpose_w)
    ref = gmm.grouped_matmul_plain(*args, transpose_w=transpose_w)
    torch.cuda.synchronize()
    worst, rel_l2 = elementwise_errors(got, ref, GMM_TOL[dt])
    if not (worst <= 1 and rel_l2 <= GMM_TOL[dt][2]):
        raise AssertionError(f"gmm {name} {dt}: worst {worst} of its "
                             f"elementwise bound, relative L2 {rel_l2}")
    if not torch.equal(gmm.grouped_matmul(*args, transpose_w=transpose_w),
                       got):
        raise AssertionError(f"gmm {name} {dt}: a second call gave other "
                             "bits")
    fault = None
    if fault_lib is not None:
        with planted("grouped_matmul", fault_lib):
            bad = gmm.grouped_matmul(*args, transpose_w=transpose_w)
            torch.cuda.synchronize()
        f_worst, f_l2 = elementwise_errors(bad, ref, GMM_TOL[dt])
        if f_worst <= 1 and f_l2 <= GMM_TOL[dt][2]:
            raise AssertionError(f"the gmm check passed the planted fault: "
                                 f"{f_worst}, {f_l2}")
        fault = dict(dropped="the last K slice of work item 0",
                     err_over_bound=f_worst, rel_l2_err=f_l2,
                     max_abs_err=max_err(bad, ref))
    offs = counts.cumsum(0).to(torch.int32)
    wl = w.transpose(1, 2) if transpose_w else w
    lib_ms, lib = (grouped_mm_ms(lambda: torch._grouped_mm(x, wl, offs=offs))
                   if dtype == torch.bfloat16
                   else (None, "torch._grouped_mm takes bf16 only"))
    live = int((counts > 0).sum())
    item = x.element_size()
    row = dict(name=f"gmm {name} {dt}", shape=dict(
        Tk=Tk, K=K, N=N, E=E, transpose_w=transpose_w,
        counts=counts.tolist()), max_abs_err=max_err(got, ref),
        err_over_bound=worst, rel_l2_err=rel_l2, reproducible=True,
        tol=dict(zip(("rtol", "c_rms", "rel_l2"), GMM_TOL[dt])),
        planted_fault=fault,
        ms=time_ms(lambda: gmm.grouped_matmul(*args,
                                              transpose_w=transpose_w)),
        plain_ms=time_ms(lambda: gmm.grouped_matmul_plain(
            *args, transpose_w=transpose_w), iters=5),
        library_ms=lib_ms, library=lib)
    row["bound_ms"], row["bound_by"] = bound(
        (Tk * K + live * K * N + Tk * N) * item, 2.0 * Tk * K * N, dt)
    return row


def gmm_dw_case(gmm, name, M, N, dtype, gen, starts, counts, fault_lib):
    """K4b against its plain version at one llama_moe shape, x [Tk, M] and
    dout [Tk, N]. Two calls must give the same bits; for bf16 at the
    up-projection shape, the same check must fail the planted fault (the
    first slice of expert 1's first row chunk left out)."""
    E, Tk = MOE_E, MOE_TK
    dt = str(dtype)[6:]
    x = torch.randn(Tk, M, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(Tk, N, generator=gen, device="cuda").to(dtype)
    args = (x, dout, starts, counts)
    got = gmm.grouped_matmul_dw(*args)
    ref = gmm.grouped_matmul_dw_plain(*args)
    torch.cuda.synchronize()
    tol = BWD_TOL[dt]
    worst, rel_l2 = elementwise_errors(got, ref, tol)
    empty = [e for e, c in enumerate(counts.tolist()) if c == 0]
    if not (worst <= 1 and rel_l2 <= tol[2]) or got[empty].any():
        raise AssertionError(f"gmm_dw {name} {dt}: worst {worst} of its "
                             f"elementwise bound, relative L2 {rel_l2}")
    if not torch.equal(gmm.grouped_matmul_dw(*args), got):
        raise AssertionError(f"gmm_dw {name} {dt}: a second call gave other "
                             "bits")
    fault = None
    if fault_lib is not None:
        with planted("grouped_matmul", fault_lib):
            bad = gmm.grouped_matmul_dw(*args)
            torch.cuda.synchronize()
        f_worst, f_l2 = elementwise_errors(bad, ref, tol)
        if f_worst <= 1 and f_l2 <= tol[2]:
            raise AssertionError(f"the dw check passed the planted fault: "
                                 f"{f_worst}, {f_l2}")
        fault = dict(dropped="rows 0-63 of expert 1", err_over_bound=f_worst,
                     rel_l2_err=f_l2, max_abs_err=max_err(bad, ref))
    offs = counts.cumsum(0).to(torch.int32)
    # The library call rounds dw to bf16 (it takes no fp32 output here).
    lib_ms, lib = (grouped_mm_ms(lambda: torch._grouped_mm(x.t(), dout,
                                                           offs=offs))
                   if dtype == torch.bfloat16
                   else (None, "torch._grouped_mm takes bf16 only"))
    item = x.element_size()
    row = dict(name=f"gmm_dw {name} {dt}", shape=dict(
        Tk=Tk, M=M, N=N, E=E, counts=counts.tolist()),
        max_abs_err=max_err(got, ref), err_over_bound=worst,
        rel_l2_err=rel_l2, reproducible=True,
        tol=dict(zip(("rtol", "c_rms", "rel_l2"), tol)), planted_fault=fault,
        ms=time_ms(lambda: gmm.grouped_matmul_dw(*args)),
        plain_ms=time_ms(lambda: gmm.grouped_matmul_dw_plain(*args), iters=5),
        library_ms=lib_ms, library=lib)
    row["bound_ms"], row["bound_by"] = bound(
        (Tk * M + Tk * N) * item + 4 * E * M * N, 2.0 * Tk * M * N, dt)
    return row


def near_tie_rows(router, idx, ref_idx, logits) -> list:
    """Rows where the kernel's expert choice differs from the plain
    version's; each must be a near tie (at the first differing rank, the
    plain version's probabilities of that rank and the next within 4 ulp)
    or this raises."""
    rows = (idx != ref_idx).any(1).nonzero().flatten().tolist()
    for r in rows:
        j = int((idx[r] != ref_idx[r]).nonzero()[0])
        probs = router._softmax_lse(logits[r:r + 1].float())[0][0]
        top = torch.sort(probs, descending=True).values
        ulp = float(torch.nextafter(top[j], top.new_tensor(float("inf")))
                    - top[j])
        if not float(top[j] - top[j + 1]) <= 4 * ulp:
            raise AssertionError(f"router row {r} differs at rank {j} and "
                                 f"is no near tie: {top.tolist()}")
    return rows


def router_case(router, gen, fault_lib):
    """K5 against its plain version at the llama_moe shape: [8192, 8] fp32
    logits (the router is fp32 under every policy), k = 2, with exact ties
    planted on every third row; called twice for equal bits; the same
    check must fail ``fault_lib``, a build whose merge leaves one block's
    partial out of probs_mean."""
    T, E, k = MOE_TK // 2, MOE_E, 2
    logits = torch.randn(T, E, generator=gen, device="cuda") * 3
    logits[::3, E - 1] = logits[::3, 0]
    got = router.fused_router_fwd(logits, k)
    ref = router.fused_router_plain(logits, k)
    torch.cuda.synchronize()
    rows = near_tie_rows(router, got[1], ref[1], logits)
    keep = torch.ones(T, dtype=torch.bool, device="cuda")
    keep[rows] = False
    errs = [max_err(got[0][keep], ref[0][keep]),
            max_err(got[2], ref[2]), max_err(got[3], ref[3])]
    for what, err, r in zip(("gates", "lse", "probs_mean"), errs,
                            (ref[0], ref[2], ref[3])):
        check(f"fused_router {what}", err,
              ROUTER_TOL * max(1.0, float(r.abs().max())))
    if (got[1][::3, 0] == E - 1).any():
        raise AssertionError("fused_router: a tie went to the higher index")
    if not all(torch.equal(a, b) for a, b in
               zip(router.fused_router_fwd(logits, k), got)):
        raise AssertionError("fused_router: two calls differ")
    pm_tol = ROUTER_TOL * max(1.0, float(ref[3].abs().max()))
    with planted("fused_router", fault_lib):
        bad = max_err(router.fused_router_fwd(logits, k)[3], ref[3])
        torch.cuda.synchronize()
    if bad <= pm_tol:
        raise AssertionError(f"the router check passed the planted fault: "
                             f"probs_mean error {bad}")
    nbytes = 4 * (T * E + 2 * T * k + T + E)
    row = dict(name="fused_router float32", shape=dict(T=T, E=E, k=k),
               max_abs_err=max(errs), tol=ROUTER_TOL,
               rows_that_differ=rows, reproducible=True,
               planted_fault=dict(dropped="block 1's probs_mean partial",
                                  probs_mean_max_abs_err=bad),
               ms=time_ms(lambda: router.fused_router_fwd(logits, k)),
               ms_clean_l2=time_ms(lambda: router.fused_router_fwd(logits, k),
                                   clean_l2=True),
               # An empty kernel on the router's grid, in the same harness:
               # the least any one launch reads here.
               launch_floor_ms=time_ms(lambda: router.empty_launch(T, E)),
               plain_ms=time_ms(lambda: router.fused_router_plain(logits, k),
                                iters=5),
               library_ms=None,
               library="none: no single PyTorch call computes it")
    row["bound_ms"], row["bound_by"] = bound(nbytes, (6.0 + 2 * k) * T * E,
                                             "float32")
    return row


def bn_matmul_case(fbm, bn_bench, name, N, K, C, affine, relu, dtype, gen,
                   fault_lib=None):
    """K3 against its plain version at one shape: x [N, K], w [K, C], scale
    and bias [K] when ``affine``; with ``fault_lib``, the same check must
    fail a build whose merge leaves one block's partial out of the
    statistics. With the prologue whole, the bench's unfused arm is timed
    beside it, and every row times cuBLAS alone on the prologue's output
    (``matmul_ms``)."""
    dt = str(dtype)[6:]
    x = torch.randn(N, K, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(K, C, generator=gen, device="cuda") / K ** 0.5).to(dtype)
    aff = ((1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(dtype),
           (0.1 * torch.randn(K, generator=gen, device="cuda")).to(dtype)
           ) if affine else (None, None)
    args = (x, w, *aff)
    ref = fbm.fused_stats_matmul_plain(*args, relu=relu)

    def errors(got):
        (y, stats), (ry, rstats) = got, ref
        msq = rstats[1] / N
        mean, rmean = stats[0] / N, rstats[0] / N
        var, rvar = stats[1] / N - mean * mean, msq - rmean * rmean
        worst, rel_l2 = elementwise_errors(y, ry, GMM_TOL[dt])
        return dict(err_over_bound=worst, rel_l2_err=rel_l2,
                    max_abs_err=max_err(y, ry),
                    mean_err=float(((mean - rmean).abs() / msq.sqrt()).max()),
                    var_err=float(((var - rvar).abs() / msq).max()))

    def passes(e):
        return (e["err_over_bound"] <= 1 and e["rel_l2_err"] <= GMM_TOL[dt][2]
                and e["mean_err"] <= BN_STATS_TOL
                and e["var_err"] <= BN_STATS_TOL)

    got = fbm.fused_stats_matmul(*args, relu=relu)
    torch.cuda.synchronize()
    errs = errors(got)
    if not passes(errs):
        raise AssertionError(f"fused_bn_matmul {name} {dt}: {errs}")
    if not torch.equal(fbm.fused_stats_matmul(*args, relu=relu)[1], got[1]):
        raise AssertionError(f"fused_bn_matmul {name} {dt}: the stats of "
                             "two calls differ")
    fault = None
    if fault_lib is not None:
        with planted("fused_bn_matmul", fault_lib):
            bad = errors(fbm.fused_stats_matmul(*args, relu=relu))
            torch.cuda.synchronize()
        if passes(bad):
            raise AssertionError(f"the BN-stats check passed the planted "
                                 f"fault: {bad}")
        fault = dict(dropped="slot 1's partial (one block's) in the merge",
                     **bad)
    item = x.element_size()
    # x and w read once, scale and bias, y written once, the fp32 stats.
    nbytes = (N * K + K * C + N * C + (2 * K if affine else 0)) * item \
        + 4 * 2 * C
    # cuBLAS alone on x already put through the prologue: the same bytes
    # as K3 without the prologue and the statistics, a yardstick.
    xn = x.float()
    if affine:
        xn = xn * aff[0].float() + aff[1].float()
    xn = (torch.relu(xn) if relu else xn).to(dtype)
    row = dict(name=f"fused_bn_matmul {name} {dt}", shape=dict(
        N=N, K=K, C=C, affine=affine, relu=relu), **errs,
        tol=dict(y=dict(zip(("rtol", "c_rms", "rel_l2"), GMM_TOL[dt])),
                 moments=BN_STATS_TOL),
        planted_fault=fault,
        ms=time_ms(lambda: fbm.fused_stats_matmul(*args, relu=relu)),
        ms_clean_l2=time_ms(lambda: fbm.fused_stats_matmul(*args, relu=relu),
                            clean_l2=True),
        matmul_ms=time_ms(lambda: torch.matmul(xn, w)),
        plain_ms=time_ms(lambda: fbm.fused_stats_matmul_plain(
            *args, relu=relu), iters=5),
        library_ms=None,
        library="none: no single PyTorch call computes it (the unfused "
                "arm, elementwise + cuBLAS matmul + 2 reductions, is "
                "unfused_ms)")
    if affine and relu:
        row["unfused_ms"] = time_ms(lambda: bn_bench.unfused(x, w, *aff))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * N * K * C, dt)
    return row


def long_prompt_requests(engine_lib, seed: int, lens, max_new: int,
                         vocab: int):
    rng = np.random.default_rng(seed)
    return [engine_lib.Request(request_id=f"long{i}",
                               prompt=rng.integers(1, vocab, n).tolist(),
                               max_new_tokens=max_new)
            for i, n in enumerate(lens)]


def device_profile(prof, wall_s: float, top: int = 8) -> dict:
    """Kernel time by name from a torch.profiler trace, and the share of
    the wall time the card was busy."""
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # work on the card itself
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    return {"wall_ms": 1e3 * wall_s, "device_ms": device_ms,
            "busy_share": device_ms / (1e3 * wall_s),
            # K6's kernels (the split kernel and its combine), K1f/K1o's
            # kernel and K2's three (delta pre-pass, dq, dk/dv)
            "paged_decode_ms": sum(ms for k, ms in by_name.items()
                                   if "paged_decode" in k),
            "flash_fwd_ms": sum(ms for k, ms in by_name.items()
                                if "flash_fwd_" in k),
            "flash_bwd_ms": sum(ms for k, ms in by_name.items()
                                if "flash_bwd_" in k),
            "top": [{"kernel": k[:80], "ms": ms, "share": ms / device_ms}
                    for k, ms in rows[:top]]}


def serve_engine(model, engine_lib, reqs, *, attn_impl="auto",
                 prompt_buckets=(1024,), num_pages=512, profile=False):
    """Warm an engine, then drain ``reqs`` through it (under
    ``torch.profiler`` when ``profile``); returns the engine, the warmed
    shape count, the drain's wall seconds and the profile or None."""
    spec = engine_lib.spec_for_module(model, num_pages=num_pages,
                                      page_size=16)
    eng = engine_lib.ContinuousBatchingEngine(
        model, spec, decode_buckets=DECODE_BUCKETS,
        prompt_buckets=prompt_buckets, attn_impl=attn_impl)
    warm = eng.warmup()
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile
        else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if len(done) != len(reqs) or eng.stats["nonfinite_logits"]:
        raise AssertionError(f"engine completed {len(done)}/{len(reqs)} "
                             f"requests, stats {eng.stats}")
    return eng, warm, wall, (device_profile(prof, wall) if profile else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pytorch_distributed_training_example_tpu_torch import (
        bridge, main as port)
    from pytorch_distributed_training_example_tpu_torch.bench import (
        fused_bn_bench as bn_bench)
    from pytorch_distributed_training_example_tpu_torch.core import (
        optim as optim_lib, train_loop, trainer as trainer_lib)
    from pytorch_distributed_training_example_tpu_torch.core.train_state import (
        TrainState)
    from pytorch_distributed_training_example_tpu_torch.data import (
        datasets as datasets_lib, prefetch)
    from pytorch_distributed_training_example_tpu_torch.models import (
        registry)
    from pytorch_distributed_training_example_tpu_torch.ops import (
        _build, flash_attention as flash, fused_bn_matmul as fbm,
        fused_router as router, grouped_matmul as gmm)
    from pytorch_distributed_training_example_tpu_torch.models import llama
    from pytorch_distributed_training_example_tpu_torch.serve import (
        engine as engine_lib)

    # fp32 products in full fp32 on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    # The largest SM clock, for the XU floor of the forward's rows (None
    # where nvidia-smi does not report it).
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    sm_clock_hz = (1e6 * float(clock[0])
                   if clock and clock[0].replace(".", "").isdigit() else None)
    emit("device", nvidia_smi=smi, kind=kind, max_sm_clock_hz=sm_clock_hz,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. Build every kernel from the checkout, one nvcc per source at once,
    # and beside them the planted-fault copies the checks must fail: of
    # grouped_matmul.cu (the gmm and dw checks), flash_fwd.cu (the kv_len
    # check and the causal check), fused_bn_matmul.cu (the BN-stats check),
    # fused_router.cu (the router's probs_mean check) and paged_decode.cu
    # (the B=1 long paged decode check).
    fault_dir = os.path.join(_build.BUILD_DIR, "planted_fault")
    os.makedirs(fault_dir, exist_ok=True)
    faults = {"gmm_dw": ("grouped_matmul", DROPPED_ROWS),
              "gmm": ("grouped_matmul", DROPPED_SLICE),
              "kv_len": ("flash_fwd", IGNORED_KV_LEN),
              "diagonal": ("flash_fwd", UNMASKED_DIAGONAL),
              "bn": ("fused_bn_matmul", DROPPED_PARTIAL),
              "router": ("fused_router", DROPPED_BLOCK),
              "split": ("paged_decode", DROPPED_SPLIT)}
    fault_libs, fault_procs = {}, []
    for key, (name, (old, new)) in faults.items():
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            source = f.read()
        if source.count(old) != 1:
            raise AssertionError(f"the planted fault's line is not in "
                                 f"{name}.cu exactly once: {old!r}")
        fault_src = os.path.join(fault_dir, f"{name}_{key}_fault.cu")
        with open(fault_src, "w") as f:
            f.write(source.replace(old, new))
        fault_libs[key] = os.path.join(fault_dir, f"lib{name}_{key}_fault.so")
        fault_procs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", fault_libs[key], fault_src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = _build.build_all()
    for proc in fault_procs:
        fault_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed on a planted fault:\n"
                                 f"{fault_log}")
    # The wgmma kernels (the bf16 attention forward and backward, the
    # grouped matmul and its dw, the BN-stats matmul at its three chunk
    # widths) and the split paged decode kernels (bf16 at head_dim 64 and
    # 128, ring depths 1-4) must not spill, nor serialise their wgmma
    # (ptxas C7513). A library built earlier, by the kernel tests, reports
    # no log: not checked then.
    spills = {}
    for name, n_kernels, marker in (("flash_fwd", 2, "wgmma"),
                                    ("flash_bwd", 4, "wgmma"),
                                    ("grouped_matmul", 3, "wgmma"),
                                    ("fused_bn_matmul", 3, "wgmma"),
                                    ("paged_decode", 8, "paged_decode_mma")):
        spills[name] = kernel_spills(built["logs"][name], marker)
        serialised = [ln for ln in built["logs"][name].splitlines()
                      if "C7513" in ln]
        if built["logs"][name] and (len(spills[name]) != n_kernels
                                    or any(spills[name].values())
                                    or serialised):
            raise AssertionError(f"{name}'s {marker} kernels spill or are "
                                 f"serialised: {spills[name]} {serialised}")
    emit("build", seconds=built["seconds"],
         ptxas={name: [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Performance Loss" in ln]
                for name, log in built["logs"].items()},
         flash_fwd_wgmma_spill_bytes=spills["flash_fwd"] or None,
         flash_bwd_wgmma_spill_bytes=spills["flash_bwd"] or None,
         grouped_matmul_wgmma_spill_bytes=spills["grouped_matmul"] or None,
         bn_matmul_wgmma_spill_bytes=spills["fused_bn_matmul"] or None,
         paged_decode_mma_spill_bytes=spills["paged_decode"] or None)

    # 3. Each kernel against its plain version at the serving shapes.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        # Paged decode at llama3_8b's decode shape: tight tables at B=1 and
        # B=8; in bf16 also B=8 at the serving engine's table width (255
        # columns), B=1 at llama3_8b's full context and B=8 at 2048 tokens
        # each (a pool of 1025 pages).
        b8 = [0, 15, 16, 47, 300, 511, 767, 1023]
        cases = [(1, [1000], "", 640, None), (8, b8, "", 640, None)]
        if dtype == torch.bfloat16:
            cases += [(8, b8, "engine_width", 640, ENGINE_TABLE_WIDTH),
                      (1, [8191], "long", 1025, None),
                      (8, [2047] * 8, "long", 1025, None)]
        for B, positions, label, P, width in cases:
            row = paged_decode_case(
                flash, B, positions, dtype, gen, label, P, width,
                fault_libs["split"] if label == "long" and B == 1 else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="paged_decode", **row)
        gc.collect()
        torch.cuda.empty_cache()
        # The causal forward at llama3_8b's prefill shapes, and at the
        # training microbatches of gpt2_124m and llama_moe; bf16 at gpt2's
        # also fails the planted fault. bf16 at head_dim 256 (no model's)
        # keeps the mma.sync kernel.
        d256 = (("D256", 1, 2048, 16, 4, 256),) \
            if dtype == torch.bfloat16 else ()
        for case in (("S=1024", 1, 1024, 32, 8, 128),
                     ("S=2048", 1, 2048, 32, 8, 128),
                     ("gpt2", 16, 1024, 12, 12, 64),
                     ("llama_moe", 4, 2048, 16, 4, 64)) + d256:
            row = flash_case(flash, *case, dtype, gen, sm_clock_hz,
                             fault_libs["diagonal"] if (
                                 case[0] == "gpt2"
                                 and dtype == torch.bfloat16) else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="flash_fwd", **row)
            gc.collect()
            torch.cuda.empty_cache()
    # The backward at the training shapes: gpt2_124m's microbatch (bf16 and
    # fp32), llama3_8b's GQA heads at 2048 tokens, ViT-B/16's 197 tokens
    # padded to 256 (keys past 197 masked, non-causal).
    for case in (("gpt2", 16, 1024, 12, 12, 64, True, None, torch.bfloat16),
                 ("gpt2", 16, 1024, 12, 12, 64, True, None, torch.float32),
                 ("llama_gqa", 1, 2048, 32, 8, 128, True, None,
                  torch.bfloat16),
                 ("llama_moe", 4, 2048, 16, 4, 64, True, None,
                  torch.bfloat16),
                 ("vit_padded", 2, 256, 12, 12, 64, False, 197,
                  torch.bfloat16),
                 ("vit_b16", 128, 256, 12, 12, 64, False, 197,
                  torch.bfloat16)):
        row = flash_bwd_case(flash, *case, gen)
        rows[row["name"]] = row
        emit("kernel_check", kernel="flash_bwd", **row)
        gc.collect()
        torch.cuda.empty_cache()

    # The MoE kernels at the llama_moe shapes (kT = 16384 routed rows, d
    # 1024, f 2048), uneven routing: the up and down products, the
    # backward's dx against w transposed for each, both weight gradients,
    # the router; bf16 also under the training step's balanced routing
    # (kT / E rows an expert), and the up shapes fail the planted faults.
    starts, counts = moe_segments(MOE_TK, MOE_E)
    balanced = segments_of([MOE_TK // MOE_E] * MOE_E)
    D, F = MOE_D, MOE_F
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for case in (("up", D, F, False), ("down", F, D, False),
                     ("dx_up", F, D, True), ("dx_down", D, F, True)):
            row = gmm_case(gmm, *case, dtype, gen, starts, counts,
                           fault_libs["gmm"] if case[0] == "up" and bf16
                           else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="gmm", **row)
        for name, M, N in (("up", D, F), ("down", F, D)):
            row = gmm_dw_case(gmm, name, M, N, dtype, gen, starts, counts,
                              fault_libs["gmm_dw"] if name == "up" and bf16
                              else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="gmm_dw", **row)
        if bf16:
            row = gmm_case(gmm, "up_balanced", D, F, False, dtype, gen,
                           *balanced)
            rows[row["name"]] = row
            emit("kernel_check", kernel="gmm", **row)
            row = gmm_dw_case(gmm, "up_balanced", D, F, dtype, gen,
                              *balanced, None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="gmm_dw", **row)
        gc.collect()
        torch.cuda.empty_cache()
    row = router_case(router, gen, fault_libs["router"])
    rows[row["name"]] = row
    emit("kernel_check", kernel="fused_router", **row)

    # The forward with kv_len (K1o) at ViT-B/16's microbatch (197 tokens
    # padded to 256), causal with kv_len, GQA at Llama's heads, and the
    # causal forward at 256 tokens without kv_len (the chunked one-shot
    # body's contract); bf16 at ViT's shape also fails the planted fault.
    for dtype in (torch.bfloat16, torch.float32):
        for case in (("vit", 128, 256, 12, 12, 64, False, 197),
                     ("causal_kv_len", 128, 256, 12, 12, 64, True, 197),
                     ("gqa", 8, 1024, 32, 8, 128, False, 1000),
                     ("causal_chunked", 128, 256, 12, 12, 64, True, None)):
            row = flash_kv_len_case(
                flash, *case, dtype, gen,
                fault_libs["kv_len"] if (case[0] == "vit"
                                 and dtype == torch.bfloat16) else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="flash_fwd_kv_len", **row)
        gc.collect()
        torch.cuda.empty_cache()

    # The fused BN-stats matmul (K3) at the bench's three ResNet-50 1x1-conv
    # shapes (batch 128, scale, bias and ReLU) and ragged ones: rows no
    # multiple of a tile without a prologue, rows and columns ragged with an
    # affine prologue and no ReLU, and in bf16 ragged rows with more than
    # 256 columns (several column chunks); bf16 at the first shape also
    # fails the planted fault.
    for dtype in (torch.bfloat16, torch.float32):
        wide = (("wide", 5003, 512, 1024, True, True),) \
            if dtype == torch.bfloat16 else ()
        for case in (("stage2_reduce", 401408, 256, 64, True, True),
                     ("stage2_expand", 401408, 64, 256, True, True),
                     ("stage3_reduce", 100352, 512, 128, True, True),
                     ("ragged_rows", 12345, 256, 64, False, False),
                     ("ragged_affine", 3001, 64, 200, True, False)) + wide:
            row = bn_matmul_case(
                fbm, bn_bench, *case, dtype, gen,
                fault_libs["bn"] if (case[0] == "stage2_reduce"
                                 and dtype == torch.bfloat16) else None)
            rows[row["name"]] = row
            emit("kernel_check", kernel="fused_bn_matmul", **row)
        gc.collect()
        torch.cuda.empty_cache()

    # 4-5. The main path: counts from 0, then serving through the port's
    # entry point, then the long-prompt path through the engine.
    counters = {"paged_decode": flash.paged_decode_attention,
                "flash_fwd": flash.flash_attention_fwd,
                "flash_fwd_kv_len": flash.flash_attention_fwd_kv_len,
                "flash_bwd": flash.flash_attention_bwd,
                "gmm": gmm.grouped_matmul, "gmm_dw": gmm.grouped_matmul_dw,
                "fused_router": router.fused_router_fwd,
                "fused_bn_matmul": fbm.fused_stats_matmul}
    for fn in counters.values():
        fn.launches = 0
    argv = ["--serve", "--model", "llama3_8b", "--precision", "bf16",
            "--serve-num-pages", "256"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port.main(argv)
    out = buf.getvalue()
    result = json.loads(out[out.index("{"):])
    if rc != 0 or result["requests_completed"] != 16 \
            or result["nonfinite_logits"] or not result["drained"]:
        raise AssertionError(f"serving through main failed: {result}")
    serve_launches = {"paged_decode": flash.paged_decode_attention.launches,
                      "flash_fwd": flash.flash_attention_fwd.launches}
    # Warmup runs each decode bucket once; then one decode forward per step.
    if serve_launches["paged_decode"] != LAYERS * (
            result["decode_steps"] + len(DECODE_BUCKETS)):
        raise AssertionError(f"paged decode launches {serve_launches}")
    emit("serve_main", argv=argv, seconds=time.perf_counter() - t0,
         launches=serve_launches, result=result)
    gc.collect()
    torch.cuda.empty_cache()

    model = registry.create_model("llama3_8b", dtype=torch.bfloat16,
                                  device="cuda", seed=0)
    lens = [600, 777, 901, 1024]
    reqs = long_prompt_requests(engine_lib, 1, lens, 16, model.vocab_size)
    eng, warm, wall, _ = serve_engine(model, engine_lib, reqs)
    launches = {"paged_decode": flash.paged_decode_attention.launches,
                "flash_fwd": flash.flash_attention_fwd.launches}
    long_launches = {k: launches[k] - serve_launches[k] for k in launches}
    if long_launches["flash_fwd"] != LAYERS * (eng.stats["prefills"] + 1) or \
            long_launches["paged_decode"] != LAYERS * (
                eng.stats["decode_steps"] + len(DECODE_BUCKETS)):
        raise AssertionError(f"long-prompt launches {long_launches}, "
                             f"stats {eng.stats}")
    emit("serve_long_prompts", prompt_lens=[len(r.prompt) for r in reqs],
         warmed_shapes=warm, seconds=wall, launches=long_launches,
         stats=eng.stats)
    for name in ("paged_decode", "flash_fwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 "path")
    path_launches = {"serve": {k: fn.launches
                               for k, fn in counters.items()}}

    # Where the device time of that drain goes: the same requests again,
    # under torch.profiler (its host overhead stretches the wall time, so
    # the busy share is taken against the unprofiled drain above).
    prof = serve_engine(model, engine_lib, long_prompt_requests(
        engine_lib, 1, lens, 16, model.vocab_size), profile=True)[3]
    emit("profile_long_prompts", unprofiled_wall_ms=1e3 * wall,
         busy_share=prof["device_ms"] / (1e3 * wall),
         paged_decode_ms=prof["paged_decode_ms"], profiled=prof)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()

    # 6. Greedy tokens with the kernels == with the plain versions, fp32,
    # llama3_8b widths with the depth cut to 2 layers (the one cut).
    tokens = {}
    for impl in ("auto", "xla"):
        model = registry.create_model("llama3_8b", dtype=torch.float32,
                                      device="cuda", seed=0, num_layers=2,
                                      attn_impl=impl)
        reqs = long_prompt_requests(engine_lib, 2, [40, 700, 1024], 12,
                                    model.vocab_size)
        before = (flash.paged_decode_attention.launches,
                  flash.flash_attention_fwd.launches)
        eng = serve_engine(model, engine_lib, reqs, attn_impl=impl,
                           prompt_buckets=(64, 1024), num_pages=256)[0]
        ran = (flash.paged_decode_attention.launches - before[0],
               flash.flash_attention_fwd.launches - before[1])
        # The kernel path launches both kernels; the plain path neither.
        if (impl == "auto" and min(ran) <= 0) or (impl == "xla" and any(ran)):
            raise AssertionError(f"{impl}: kernel launches {ran}")
        tokens[impl] = {r.request_id: r.generated for r in eng.completed}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    if tokens["auto"] != tokens["xla"]:
        raise AssertionError(f"greedy tokens differ: {tokens}")
    emit("token_identity", precision="fp32", num_layers=2,
         cut="depth 32 -> 2 layers; widths are llama3_8b's",
         prompt_lens=[40, 700, 1024], tokens_per_request=12, identical=True)

    # 7. The training path: counts from 0, then gpt2_124m at full width and
    # depth in bf16 through the port's entry point, global batch 256 as 16
    # microbatches of 16 x 1024 tokens, the epoch-end eval off (it is not
    # split into microbatches).
    for fn in counters.values():
        fn.launches = 0
    argv = ["--config", "gpt2_124m", "--grad-accum", str(GRAD_ACCUM),
            "--steps-per-epoch", str(TRAIN_STEPS), "--eval-every-epochs", "2",
            "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port.main(argv)
    seconds = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    train_launches = {k: fn.launches for k, fn in counters.items()}
    path_launches["train"] = train_launches
    per_step = GPT2_LAYERS * GRAD_ACCUM * summary["steps"]
    if rc != 0 or summary["steps"] != TRAIN_STEPS \
            or summary["global_batch"] != 256 \
            or not all(np.isfinite(summary["losses"] + summary["grad_norms"])):
        raise AssertionError(f"training through main failed: {summary}")
    if train_launches["flash_fwd"] != per_step or \
            train_launches["flash_bwd"] != per_step:
        raise AssertionError(f"training launches {train_launches}, expected "
                             f"{per_step} of flash_fwd and flash_bwd")
    steady = sorted(summary["step_time_s"][1:])   # the first step warms up
    step_s = steady[len(steady) // 2]
    tokens = summary["global_batch"] * summary["seq_len"]
    gpt2 = registry.create_bundle("gpt2", seq_len=1024, device="meta",
                                  seed=None)
    flops_tok = gpt2.fwd_flops_per_example / 1024
    del gpt2
    emit("train_main", argv=argv, seconds=seconds, launches=train_launches,
         step_ms=1e3 * step_s, step_ms_all=[1e3 * t for t in
                                             summary["step_time_s"]],
         tokens_per_s=tokens / step_s,
         mfu=3 * flops_tok * tokens / step_s / PEAK_OPS["bfloat16"],
         mfu_basis="3 x (2 N + 4 L S d) flops per token over 989 TF/s bf16",
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=summary["losses"], grad_norms=summary["grad_norms"])
    gc.collect()
    torch.cuda.empty_cache()

    # 8. Where one training step's device time goes: the same run's
    # configuration built through the trainer, one warm step, one timed
    # step, one step under torch.profiler.
    cfg = port.config_from_args(port.build_parser().parse_args(argv))
    trainer = trainer_lib.Trainer(cfg, device="cuda")
    batches = iter(trainer.train_loader)
    device_batches = prefetch.device_prefetch(batches, trainer.device)
    walls = []
    for _ in range(2):
        batch = next(device_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    batch = next(device_batches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    batches.close()
    profiled = device_profile(prof, prof_wall, top=10)
    emit("profile_train_step", unprofiled_step_ms=1e3 * walls[-1],
         busy_share=profiled["device_ms"] / (1e3 * walls[-1]),
         profiled=profiled)
    del trainer, batch, prof
    gc.collect()
    torch.cuda.empty_cache()

    # 9. Loss and gradients with the kernels == with the plain path, fp32,
    # gpt2_124m widths with the depth cut to 2 layers (the one cut), one
    # batch of 8 x 1024 tokens through the train step's gradient pass.
    data = datasets_lib.SyntheticTokenDataset(seq_len=1024, seed=0)
    items = [data[i] for i in range(8)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).cuda()
             for k in ("tokens", "targets")}
    task = train_loop.get_task("lm")
    losses, grads = {}, {}
    for impl in ("auto", "xla"):
        model = registry.create_model("gpt2", seq_len=1024,
                                      dtype=torch.float32, device="cuda",
                                      seed=0, num_layers=2, attn_impl=impl)
        before = (flash.flash_attention_fwd.launches,
                  flash.flash_attention_bwd.launches)
        losses[impl] = float(train_loop.accumulate_grads(model, task,
                                                         batch)[0])
        ran = (flash.flash_attention_fwd.launches - before[0],
               flash.flash_attention_bwd.launches - before[1])
        # The kernel path launches both kernels; the plain path neither.
        if (impl == "auto" and ran != (2, 2)) or (impl == "xla" and any(ran)):
            raise AssertionError(f"{impl}: kernel launches {ran}")
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    loss_rel = abs(losses["auto"] - losses["xla"]) / abs(losses["xla"])
    if not loss_rel <= 1e-5:
        raise AssertionError(f"losses differ: {losses}")
    # Each gradient's error against its own largest element, floored at
    # 1e-3 of the model's largest: a key bias's gradient is zero up to
    # rounding (softmax ignores a shift along the keys), so its own max is
    # noise and no scale for an error.
    top = max(float(g.abs().max()) for g in grads["xla"].values())
    worst = max((max_err(grads["auto"][n], g)
                 / max(float(g.abs().max()), 1e-3 * top), n)
                for n, g in grads["xla"].items())
    if not worst[0] <= GRAD_TOL:
        raise AssertionError(f"gradients differ: {worst}")
    emit("grad_identity", precision="fp32", num_layers=2,
         cut="depth 12 -> 2 layers; widths are gpt2_124m's", batch=[8, 1024],
         losses=losses, loss_rel_err=loss_rel, worst_grad_rel_err=worst[0],
         worst_param=worst[1], grad_tol=GRAD_TOL)
    del grads, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 10. The MoE training path: counts from 0, then llama_moe at full
    # width and depth in bf16 through the port's entry point, 32 x 2048
    # tokens a step as 8 microbatches, dropless dispatch, fused router.
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port.main(MOE_ARGV)
    seconds = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    moe_launches = {k: fn.launches for k, fn in counters.items()}
    path_launches["train_moe"] = moe_launches
    steps = summary["steps"]
    per_step = {"gmm": 4 * MOE_LAYERS * MOE_GRAD_ACCUM,
                "gmm_dw": 2 * MOE_LAYERS * MOE_GRAD_ACCUM,
                "fused_router": MOE_LAYERS * MOE_GRAD_ACCUM,
                "flash_fwd": MOE_LAYERS * MOE_GRAD_ACCUM,
                "flash_bwd": MOE_LAYERS * MOE_GRAD_ACCUM, "paged_decode": 0,
                "flash_fwd_kv_len": 0, "fused_bn_matmul": 0}
    # The reported loss carries the aux and z-loss terms, as the JAX step
    # reports it; the cross entropy is what is left without them.
    aux = summary["aux_losses"]
    ce = [loss - sum(terms) for loss, *terms in zip(summary["losses"],
                                                     *aux.values())]
    values = summary["losses"] + summary["grad_norms"] + sum(aux.values(),
                                                             [])
    if rc != 0 or steps != MOE_STEPS or summary["global_batch"] != 32 \
            or summary["seq_len"] != 2048 or sorted(aux) != [
                "moe_aux_loss", "moe_z_loss"] \
            or not all(np.isfinite(values)) or not ce[-1] < ce[0]:
        raise AssertionError(f"MoE training through main failed: {summary}")
    if any(moe_launches[k] != n * steps for k, n in per_step.items()):
        raise AssertionError(f"MoE training launches {moe_launches}, "
                             f"expected {per_step} a step")
    steady = sorted(summary["step_time_s"][1:])   # the first step warms up
    step_s = steady[len(steady) // 2]
    tokens = summary["global_batch"] * summary["seq_len"]
    moe_meta = registry.create_bundle("llama_moe", seq_len=2048,
                                      device="meta", seed=None)
    n_active = llama.num_params_active(moe_meta.model)
    emit("train_moe", argv=MOE_ARGV, seconds=seconds, launches=moe_launches,
         launches_per_step={k: v / steps for k, v in moe_launches.items()},
         step_ms=1e3 * step_s,
         step_ms_all=[1e3 * t for t in summary["step_time_s"]],
         tokens_per_s=tokens / step_s,
         mfu=6 * n_active * tokens / step_s / PEAK_OPS["bfloat16"],
         mfu_basis="6 x N_active flops per token over 989 TF/s bf16, "
                   f"N_active = {n_active}",
         mfu_with_attention=3 * moe_meta.fwd_flops_per_example / 2048
         * tokens / step_s / PEAK_OPS["bfloat16"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=summary["losses"], cross_entropy=ce, aux_losses=aux,
         grad_norms=summary["grad_norms"])
    del moe_meta
    gc.collect()
    torch.cuda.empty_cache()

    # 11. Where one MoE training step's device time goes: the same
    # configuration built through the trainer, one warm step, one timed
    # step, one step under torch.profiler.
    cfg = port.config_from_args(port.build_parser().parse_args(MOE_ARGV))
    trainer = trainer_lib.Trainer(cfg, device="cuda")
    batches = iter(trainer.train_loader)
    device_batches = prefetch.device_prefetch(batches, trainer.device)
    walls = []
    for _ in range(2):
        batch = next(device_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    batch = next(device_batches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    batches.close()
    profiled = device_profile(prof, prof_wall, top=16)
    emit("profile_train_moe", unprofiled_step_ms=1e3 * walls[-1],
         busy_share=profiled["device_ms"] / (1e3 * walls[-1]),
         profiled=profiled)
    del trainer, batch, prof
    gc.collect()
    torch.cuda.empty_cache()

    # 12. Loss and gradients with the kernels == the plain path, fp32,
    # llama_moe widths with the depth cut to 2 layers (the one cut), one
    # batch of 2 x 2048 tokens through the train step's gradient pass. The
    # kernel path routes dropless through the fused router (K1f, K2, K4a,
    # K4b, K5); the plain path is the JAX package's oracle: plain attention,
    # the reference router and the gather dispatch at a capacity that never
    # drops (cf = E / k: capacity T), which launch no kernel. The routing
    # decisions are held as K5's: equal, or near ties.
    data = datasets_lib.SyntheticTokenDataset(seq_len=2048, vocab_size=32000,
                                              seed=0)
    items = [data[i] for i in range(2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).cuda()
             for k in ("tokens", "targets")}
    paths = {"kernels": dict(attn_impl="auto", moe_dispatch_impl="dropless",
                             moe_router_impl="fused"),
             "plain": dict(attn_impl="xla", moe_dispatch_impl="gather",
                           moe_router_impl="reference",
                           moe_capacity_factor=MOE_E / 2)}
    losses, grads, logits_seen, ran = {}, {}, {}, {}
    for path, kw in paths.items():
        model = registry.create_model("llama_moe", seq_len=2048,
                                      dtype=torch.float32, device="cuda",
                                      seed=0, num_layers=2, **kw)
        seen = logits_seen[path] = []
        hooks = [b.moe.router.register_forward_hook(
            lambda _m, _i, out, seen=seen: seen.append(out.detach()))
            for b in model.blocks()]
        before = {k: fn.launches for k, fn in counters.items()}
        losses[path] = float(train_loop.accumulate_grads(model, task,
                                                         batch)[0])
        ran[path] = {k: fn.launches - before[k] for k, fn in counters.items()}
        for h in hooks:
            h.remove()
        grads[path] = {n: p.grad for n, p in model.named_parameters()}
        del model
    want = {k: 0 for k in counters}
    want.update(flash_fwd=2, flash_bwd=2, gmm=8, gmm_dw=4, fused_router=2)
    if ran["kernels"] != want or any(ran["plain"].values()):
        raise AssertionError(f"kernel launches {ran}, expected {want} and "
                             "none on the plain path")
    differ = [near_tie_rows(router, router.fused_router_fwd(a, 2)[1],
                            router.fused_router_plain(b, 2)[1], b)
              for a, b in zip(logits_seen["kernels"], logits_seen["plain"])]
    loss_rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    if not loss_rel <= 1e-5:
        raise AssertionError(f"MoE losses differ: {losses}")
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    worst = max((max_err(grads["kernels"][n], g)
                 / max(float(g.abs().max()), 1e-3 * top), n)
                for n, g in grads["plain"].items())
    if not worst[0] <= GRAD_TOL:
        raise AssertionError(f"MoE gradients differ: {worst}")
    emit("moe_identity", precision="fp32", num_layers=2,
         cut="depth 12 -> 2 layers; widths are llama_moe's", batch=[2, 2048],
         paths=paths, launches=ran, losses=losses, loss_rel_err=loss_rel,
         worst_grad_rel_err=worst[0], worst_param=worst[1],
         grad_tol=GRAD_TOL, router_rows_that_differ=differ)
    del grads, batch, logits_seen
    gc.collect()
    torch.cuda.empty_cache()

    # 13. The ViT training path: counts from 0, then vit_b16_imagenet at
    # full width and depth in bf16 through the port's entry point, global
    # batch 1024 as 8 microbatches of 128 images, attention through the
    # padded flash path (197 tokens padded to 256, kv_len 197).
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port.main(VIT_ARGV)
    seconds = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    vit_launches = {k: fn.launches for k, fn in counters.items()}
    path_launches["train_vit"] = vit_launches
    steps = summary["steps"]
    per_step = VIT_LAYERS * VIT_GRAD_ACCUM
    want = {k: 0 for k in counters}
    want.update(flash_fwd_kv_len=per_step * steps, flash_bwd=per_step * steps)
    accs = summary["acc_top1"] + summary["acc_top5"]
    # Random weights on random images: the first loss is about that of a
    # uniform guess over 1000 classes, ln 1000 = 6.91 (smoothing leaves it).
    if rc != 0 or steps != VIT_STEPS or summary["global_batch"] != 1024 \
            or summary["image_size"] != 224 \
            or not all(np.isfinite(summary["losses"] + summary["grad_norms"])) \
            or not all(0 <= a <= 1 for a in accs) \
            or not abs(summary["losses"][0] - np.log(1000)) < 1.5:
        raise AssertionError(f"ViT training through main failed: {summary}")
    if vit_launches != want:
        raise AssertionError(f"ViT training launches {vit_launches}, "
                             f"expected {want}")
    steady = sorted(summary["step_time_s"][1:])   # the first step warms up
    step_s = steady[len(steady) // 2]
    waits = sorted(summary["data_wait_s"][1:])
    images = summary["global_batch"]
    vit_meta = registry.create_bundle("vit_b16", device="meta", seed=None)
    flops_image = vit_meta.fwd_flops_per_example
    del vit_meta
    emit("train_vit", argv=VIT_ARGV, seconds=seconds, launches=vit_launches,
         launches_per_step={k: v / steps for k, v in vit_launches.items()},
         step_ms=1e3 * step_s,
         step_ms_all=[1e3 * t for t in summary["step_time_s"]],
         data_wait_ms=1e3 * waits[len(waits) // 2],
         data_wait_ms_all=[1e3 * t for t in summary["data_wait_s"]],
         images_per_s=images / step_s,
         mfu=3 * flops_image * images / step_s / PEAK_OPS["bfloat16"],
         mfu_basis=f"3 x {flops_image:.6g} flops per image over 989 TF/s "
                   "bf16",
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=summary["losses"], grad_norms=summary["grad_norms"],
         acc_top1=summary["acc_top1"], acc_top5=summary["acc_top5"])
    gc.collect()
    torch.cuda.empty_cache()

    # 14. Where one ViT step's device time goes, and the plain attention
    # path beside it: the same configuration built through the trainer
    # under --attn-impl flash, then xla; each takes one warm step, one
    # timed step and one step under torch.profiler on the same batches
    # (the device time compares the two paths' work apart from the host);
    # then the flash trainer's epoch-end eval (4 batches of 1024 images).
    walls, profiled, evaluated = {}, {}, None
    for impl in ("flash", "xla"):
        argv = VIT_ARGV[:2] + ["--attn-impl", impl] + VIT_ARGV[4:]
        cfg = port.config_from_args(port.build_parser().parse_args(argv))
        trainer = trainer_lib.Trainer(cfg, device="cuda")
        batches = iter(trainer.train_loader)
        device_batches = prefetch.device_prefetch(batches, trainer.device)
        walls[impl] = []
        for _ in range(2):
            batch = next(device_batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            walls[impl].append(time.perf_counter() - t0)
        batch = next(device_batches)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        profiled[impl] = device_profile(prof, prof_wall, top=12)
        del prof
        batches.close()
        if impl == "flash":
            t0 = time.perf_counter()
            evaluated = trainer.evaluate(0)
            eval_s = time.perf_counter() - t0
            rows_eval = [r for r in trainer.metric_logger.rows
                         if r["kind"] == "eval"]
            if not (rows_eval and rows_eval[-1]["count"] == 4 * 1024
                    and np.isfinite(evaluated["loss"])
                    and 0 <= evaluated["acc_top1"] <= evaluated["acc_top5"]
                    <= 1):
                raise AssertionError(f"ViT eval failed: {evaluated}")
        del trainer, batch, device_batches
        gc.collect()
        torch.cuda.empty_cache()
    emit("profile_train_vit", unprofiled_step_ms=1e3 * walls["flash"][-1],
         busy_share=profiled["flash"]["device_ms"]
         / (1e3 * walls["flash"][-1]),
         profiled=profiled["flash"], profiled_xla=profiled["xla"],
         device_ms_by_attn_impl={k: p["device_ms"]
                                 for k, p in profiled.items()},
         step_ms_by_attn_impl={k: 1e3 * w[-1] for k, w in walls.items()},
         step_ms_all_by_attn_impl={k: [1e3 * t for t in w]
                                   for k, w in walls.items()},
         eval=dict(seconds=eval_s, count=4 * 1024, **evaluated))

    # 15. Loss and gradients with the kernels == the plain path, fp32,
    # ViT-B/16 widths with the depth cut to 2 layers (the one cut), one
    # batch of 8 synthetic ImageNet images through the train step's
    # gradient pass (label smoothing 0.1): the padded flash path (K1o and
    # K2 with kv_len 197) against plain attention.
    data = datasets_lib.SyntheticImageDataset(8, 224, 1000, seed=0)
    items = [data[i] for i in range(8)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).cuda()
             for k in ("image", "label")}
    task = train_loop.get_task("classification", 0.1)
    losses, grads, ran = {}, {}, {}
    for impl in ("flash", "xla"):
        model = registry.create_model("vit_b16", dtype=torch.float32,
                                      device="cuda", seed=0, num_layers=2,
                                      attn_impl=impl)
        before = {k: fn.launches for k, fn in counters.items()}
        losses[impl] = float(train_loop.accumulate_grads(model, task,
                                                         batch)[0])
        ran[impl] = {k: fn.launches - before[k] for k, fn in counters.items()}
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    want = {k: 0 for k in counters}
    want.update(flash_fwd_kv_len=2, flash_bwd=2)
    if ran["flash"] != want or any(ran["xla"].values()):
        raise AssertionError(f"kernel launches {ran}, expected {want} and "
                             "none on the plain path")
    loss_rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    if not loss_rel <= 1e-5:
        raise AssertionError(f"ViT losses differ: {losses}")
    top = max(float(g.abs().max()) for g in grads["xla"].values())
    worst = max((max_err(grads["flash"][n], g)
                 / max(float(g.abs().max()), 1e-3 * top), n)
                for n, g in grads["xla"].items())
    if not worst[0] <= GRAD_TOL:
        raise AssertionError(f"ViT gradients differ: {worst}")
    emit("vit_identity", precision="fp32", num_layers=2,
         cut="depth 12 -> 2 layers; widths are vit_b16's", batch=[8, 224],
         launches=ran, losses=losses, loss_rel_err=loss_rel,
         worst_grad_rel_err=worst[0], worst_param=worst[1],
         grad_tol=GRAD_TOL)
    del grads, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 16. The fused BN-stats matmul's main path: counts from 0, then its
    # entry point, the bench module, at its three shapes (bf16, scale, bias,
    # ReLU), which times K3 against the unfused segment.
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bn_bench.main([])
    seconds = time.perf_counter() - t0
    bench_out = json.loads(buf.getvalue().strip().splitlines()[-1])
    bench_launches = {k: fn.launches for k, fn in counters.items()}
    path_launches["bench_fused_bn"] = bench_launches
    bench_rows = bench_out["rows"]
    # The unfused and ResNet arms round y (and the unfused arm its
    # prologue) to bf16 before their stats; K3 takes them from the fp32
    # product: a few bf16 ulps apart.
    if rc != 0 or len(bench_rows) != len(bn_bench.SHAPES) or any(
            not (r["fused_ms"] > 0 and r["unfused_ms"] > 0
                 and r["resnet_segment_ms"] > 0
                 and max(r["mean_gap"], r["var_gap"], r["resnet_mean_gap"],
                         r["resnet_var_gap"]) < 1e-2)
            for r in bench_rows):
        raise AssertionError(f"the fused BN bench failed: {bench_out}")
    if bench_launches["fused_bn_matmul"] <= 0 or any(
            v for k, v in bench_launches.items() if k != "fused_bn_matmul"):
        raise AssertionError(f"bench launches {bench_launches}")
    emit("bench_fused_bn", argv=[], seconds=seconds, launches=bench_launches,
         **bench_out)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. The ResNet training path: counts from 0, then resnet50_imagenet at
    # full width and depth (stages [3, 4, 6, 3] of Bottleneck blocks) in
    # bf16 through the port's entry point, global batch 1024 as 4
    # microbatches of 256 images, SGD with Nesterov momentum. It runs none
    # of the kernels (convolutions and BatchNorm go to cuDNN and PyTorch's
    # own kernels, as the JAX package leaves them to XLA).
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = port.main(RESNET_ARGV)
    seconds = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    resnet_launches = {k: fn.launches for k, fn in counters.items()}
    path_launches["train_resnet"] = resnet_launches
    steps = summary["steps"]
    accs = summary["acc_top1"] + summary["acc_top5"]
    rn50 = registry.create_bundle("resnet50", device="meta", seed=None)
    n_params = sum(p.numel() for p in rn50.model.parameters())
    flops_image = rn50.fwd_flops_per_example
    del rn50
    # Random weights on random images: the first loss is about that of a
    # uniform guess over 1000 classes, ln 1000 = 6.91.
    if rc != 0 or steps != RESNET_STEPS or summary["global_batch"] != 1024 \
            or summary["grad_accum"] != RESNET_GRAD_ACCUM \
            or summary["image_size"] != 224 or n_params != 25557032 \
            or not all(np.isfinite(summary["losses"] + summary["grad_norms"])) \
            or not all(0 <= a <= 1 for a in accs) \
            or not abs(summary["losses"][0] - np.log(1000)) < 1.5:
        raise AssertionError(f"ResNet training through main failed: "
                             f"{summary}")
    if any(resnet_launches.values()):
        raise AssertionError(f"ResNet training launched kernels of the "
                             f"port: {resnet_launches}")
    steady = sorted(summary["step_time_s"][1:])   # the first step warms up
    step_s = steady[len(steady) // 2]
    waits = sorted(summary["data_wait_s"][1:])
    images = summary["global_batch"]
    emit("train_resnet", argv=RESNET_ARGV, seconds=seconds,
         launches=resnet_launches, params=n_params,
         step_ms=1e3 * step_s,
         step_ms_all=[1e3 * t for t in summary["step_time_s"]],
         data_wait_ms=1e3 * waits[len(waits) // 2],
         data_wait_ms_all=[1e3 * t for t in summary["data_wait_s"]],
         images_per_s=images / step_s,
         mfu=3 * flops_image * images / step_s / PEAK_OPS["bfloat16"],
         mfu_basis=f"3 x {flops_image:.6g} flops per image over 989 TF/s "
                   "bf16 (the JAX package's table, which counts "
                   "multiply-adds)",
         mfu_two_flop=2 * 3 * flops_image * images / step_s
         / PEAK_OPS["bfloat16"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=summary["losses"], grad_norms=summary["grad_norms"],
         acc_top1=summary["acc_top1"], acc_top5=summary["acc_top5"])
    gc.collect()
    torch.cuda.empty_cache()

    # 18. Where one ResNet step's device time goes: the same configuration
    # built through the trainer, one warm step, one timed step, one step
    # under torch.profiler, each with its batch already on the card; then
    # the epoch-end eval (4 batches of 1024 images, by the running
    # statistics).
    cfg = port.config_from_args(port.build_parser().parse_args(RESNET_ARGV))
    trainer = trainer_lib.Trainer(cfg, device="cuda")
    batches = iter(trainer.train_loader)
    device_batches = prefetch.device_prefetch(batches, trainer.device)
    walls = []
    for _ in range(2):
        batch = next(device_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    batch = next(device_batches)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    batches.close()
    profiled = device_profile(prof, prof_wall, top=12)
    del prof
    t0 = time.perf_counter()
    evaluated = trainer.evaluate(0)
    eval_s = time.perf_counter() - t0
    rows_eval = [r for r in trainer.metric_logger.rows if r["kind"] == "eval"]
    if not (rows_eval and rows_eval[-1]["count"] == 4 * 1024
            and np.isfinite(evaluated["loss"])
            and 0 <= evaluated["acc_top1"] <= evaluated["acc_top5"] <= 1):
        raise AssertionError(f"ResNet eval failed: {evaluated}")
    emit("profile_train_resnet", unprofiled_step_ms=1e3 * walls[-1],
         step_ms_all=[1e3 * t for t in walls],
         busy_share=profiled["device_ms"] / (1e3 * walls[-1]),
         profiled=profiled, eval=dict(seconds=eval_s, count=4 * 1024,
                                      **evaluated))
    del trainer, batch, device_batches
    gc.collect()
    torch.cuda.empty_cache()

    # 19. ResNet on the card == the plain path: ResNet-50 at full width
    # with one block a stage (the one cut), its weights made on the CPU from
    # seed 0 with the BatchNorm scales, biases and running statistics moved
    # off their init, carried into each model by load_state_dict; the
    # running statistics read back into the flax batch_stats tree by
    # bridge.py. Two train steps of 8 synthetic ImageNet images as 2
    # microbatches (the warmup's lr 0, then 0.133) on the card (cuDNN and
    # PyTorch's CUDA kernels, TF32 off) and on the CPU (PyTorch's CPU
    # kernels), in fp64 and in fp32. fp64: the losses, the second step's
    # gradients, the updated parameters and the running statistics chained
    # through the four microbatches agree to 1e-6 of their scale (the
    # logits and the loss are fp32 in either, as in the JAX module, and the
    # running statistics are kept in fp32: fp32 rounding, ~1e-7, and no
    # ReLU lands on the other side of zero at fp64's ~1e-15). fp32: the
    # forward-only quantities (losses, running statistics) to 1e-5; the
    # gradients only in relative L2, to 5e-2: a ReLU whose input lies within
    # fp32 rounding of zero (a few in 10^6 elements) takes opposite sides on
    # the two devices, which moves that element's gradient by its full size
    # and, through BatchNorm's backward, its channel's.
    data = datasets_lib.SyntheticImageDataset(8, 224, 1000, seed=0)
    items = [data[i] for i in range(8)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("image", "label")}
    base = registry.create_model("resnet50", dtype=torch.float32,
                                 device="cpu", seed=0, num_layers=1)
    cpu_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in base.state_dict().items():
            if name.endswith(("running_var", "BatchNorm_0.weight",
                              "BatchNorm_1.weight", "BatchNorm_2.weight",
                              "norm.weight", "bn_init.weight")):
                t.copy_(1 + 0.2 * torch.rand(t.shape, generator=cpu_gen))
            elif name.endswith(("running_mean", "bias")) and t.ndim == 1 \
                    and not name.startswith("head"):
                t.copy_(0.1 * torch.randn(t.shape, generator=cpu_gen))
    state = base.state_dict()
    cfg = port.config_from_args(port.build_parser().parse_args(RESNET_ARGV))
    task = train_loop.get_task("classification")

    def resnet_steps(device, dtype):
        model = registry.create_model("resnet50", dtype=dtype,
                                      param_dtype=dtype, device=device,
                                      seed=None, num_layers=1)
        model.load_state_dict(state)
        opt, schedule = optim_lib.build_optimizer(cfg, RESNET_STEPS, model)
        # The gradients as the update finds them (the multi-tensor SGD on
        # the card adds the momentum into them in place).
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}))
        step = train_loop.make_train_step(task, 2)
        tstate = TrainState(model, opt, schedule)
        on_dev = {k: v.to(device) for k, v in batch.items()}
        losses = [float(step(tstate, on_dev)["loss"]) for _ in range(2)]
        return dict(losses=losses, lrs=[schedule(0), schedule(1)],
                    grads=grads,
                    params={n: p.detach().cpu() for n, p in
                            model.named_parameters()},
                    stats=dict(bridge._flatten(bridge.batch_stats_of(model))))

    def worst(got, ref, l2=False):
        """The worst tensor's error over its largest element (or, with
        ``l2``, its relative L2 error), and the tensor's name."""
        def err(a, b):
            a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
            if l2:
                return float((a - b).norm() / b.norm().clamp_min(1e-300))
            return float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-300))
        return max((err(got[n], r), "/".join(n) if isinstance(n, tuple)
                    else n) for n, r in ref.items())

    identity = {}
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        card = resnet_steps("cuda", dtype)
        ref = resnet_steps("cpu", dtype)
        dt = str(dtype)[6:]
        row = dict(
            losses=card["losses"], cpu_losses=ref["losses"], lrs=card["lrs"],
            loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(
                card["losses"], ref["losses"])),
            running_stats=worst(card["stats"], ref["stats"]),
            grads=worst(card["grads"], ref["grads"]),
            grads_l2=worst(card["grads"], ref["grads"], l2=True),
            params=worst(card["params"], ref["params"]),
            params_l2=worst(card["params"], ref["params"], l2=True))
        exact = ("loss_rel_err", "running_stats") + (
            ("grads", "params") if dtype == torch.float64 else ())
        bad = [k for k in exact if not (
            row[k] if k == "loss_rel_err" else row[k][0]) <= tol]
        if dtype == torch.float32:
            bad += [k for k in ("grads_l2", "params_l2")
                    if not row[k][0] <= 5e-2]
        if bad or not card["lrs"][1] > 0:
            raise AssertionError(f"ResNet {dt} on the card differs from the "
                                 f"CPU in {bad}: {row}")
        identity[dt] = dict(row, tol=tol, held_to_tol=list(exact))
        del card, ref
    emit("resnet_identity", cut="stages [3, 4, 6, 3] -> [1, 1, 1, 1] "
         "blocks; widths are resnet50's", batch=[8, 224], grad_accum=2,
         steps=2, tf32=False, reference="the same model and weights on "
         "the CPU", fp32_l2_tol=5e-2, **identity)
    del batch, base, state
    gc.collect()
    torch.cuda.empty_cache()

    # 20. The kernels line: launches from the main paths (serving, phases
    # 4-5; gpt2 training, phase 7; MoE training, phase 10; ViT training,
    # phase 13; the fused BN bench, phase 16; ResNet training, phase 17,
    # which launches none), numbers at the main paths' shapes (bf16; the
    # router's logits are fp32).
    head = {"paged_decode": rows["paged_decode B=8 bfloat16"],
            "flash_fwd": rows["flash_fwd S=1024 bfloat16"],
            "flash_bwd": rows["flash_bwd gpt2 bfloat16"],
            "gmm": rows["gmm up bfloat16"],
            "gmm_dw": rows["gmm_dw up bfloat16"],
            "fused_router": rows["fused_router float32"],
            "flash_fwd_kv_len": rows["flash_fwd_kv_len vit bfloat16"],
            "fused_bn_matmul": rows["fused_bn_matmul stage2_reduce bfloat16"]}
    flash_py = "pytorch_distributed_training_example_tpu/ops/flash_attention.py"
    gmm_py = "pytorch_distributed_training_example_tpu/ops/grouped_matmul.py"
    meta = {
        "paged_decode": dict(route="cuda",
                             source=f"{PKG}/csrc/paged_decode.cu",
                             design="split-KV + TMA ring + mma.sync",
                             replaces=f"{flash_py}:1037"),
        "flash_fwd": dict(route="cuda", source=f"{PKG}/csrc/flash_fwd.cu",
                          design="wgmma + TMA ring",
                          replaces=f"{flash_py}:93"),
        "flash_bwd": dict(route="cuda", source=f"{PKG}/csrc/flash_bwd.cu",
                          design="wgmma + TMA ring",
                          replaces=f"{flash_py}:643", also_replaces=[
                              f"{flash_py}:200", f"{flash_py}:241",
                              f"{flash_py}:601", f"{flash_py}:809"]),
        "gmm": dict(route="cuda", source=f"{PKG}/csrc/grouped_matmul.cu",
                    design="wgmma + TMA ring", replaces=f"{gmm_py}:128"),
        "gmm_dw": dict(route="cuda", source=f"{PKG}/csrc/grouped_matmul.cu",
                       design="wgmma + TMA ring", replaces=f"{gmm_py}:162"),
        "fused_router": dict(
            route="cuda", source=f"{PKG}/csrc/fused_router.cu",
            design="one launch, last-arriver ordered merge",
            replaces="pytorch_distributed_training_example_tpu/ops/"
                     "fused_router.py:54"),
        "flash_fwd_kv_len": dict(route="cuda",
                                 source=f"{PKG}/csrc/flash_fwd.cu",
                                 design="wgmma + TMA ring",
                                 replaces=f"{flash_py}:490",
                                 also_replaces=[f"{flash_py}:512"]),
        "fused_bn_matmul": dict(
            route="cuda", source=f"{PKG}/csrc/fused_bn_matmul.cu",
            design="persistent wgmma + TMA ring, last-arriver ordered merge",
            replaces="pytorch_distributed_training_example_tpu/ops/"
                     "fused_bn_matmul.py:49"),
    }
    kernels = []
    for name, r in head.items():
        n = sum(p[name] for p in path_launches.values())
        if n <= 0:
            raise AssertionError(f"{name} never launched on a main path")
        dt = r["name"].split()[-1]
        kernels.append(dict(
            name=name, **meta[name], launches=n,
            launches_by_path={k: p[name] for k, p in path_launches.items()},
            max_abs_err=max(x["max_abs_err"] for x in rows.values()
                            if x["name"].split()[0] == name
                            and x["name"].endswith(dt)),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["name"], **({"unfused_ms": r["unfused_ms"]}
                                if "unfused_ms" in r else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
