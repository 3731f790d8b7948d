"""Attention for the port: the plain reference and the dispatcher.

Counterpart of ``pytorch_distributed_training_example_tpu/ops/attention.py``.
Shapes follow the JAX package's ``[batch, seq, heads, head_dim]`` (BSHD);
GQA is served by passing fewer K/V heads than Q heads.

- :func:`dot_product_attention` is the single-device oracle: fp32 scores
  and softmax, output in the inputs' dtype.
- :func:`attention` is the dispatcher the models call, with the JAX rules:
  ``auto`` takes the flash kernel for long, tile-aligned sequences on the
  card (:func:`_flash_eligible`) and the plain path otherwise.

Ring, zigzag-ring and Ulysses context parallelism, and the padded one-shot
flash path, are not ported yet: asking for them raises.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

_NOT_PORTED = ("ring", "ring_zigzag", "ring_allgather", "ulysses")


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Broadcast GQA KV heads up to the Q head count."""
    num_kv = k.shape[2]
    if num_kv == num_q_heads:
        return k
    if num_q_heads % num_kv:
        raise ValueError(f"H={num_q_heads} not a multiple of Hkv={num_kv}")
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=2)


def _causal_masked(logits: torch.Tensor) -> torch.Tensor:
    sq, sk = logits.shape[-2], logits.shape[-1]
    q_pos = torch.arange(sq, device=logits.device)[:, None]
    k_pos = torch.arange(sk, device=logits.device)[None, :]
    return logits.masked_fill(q_pos < k_pos, NEG_INF)


def attention_logits(q: torch.Tensor, k: torch.Tensor, *,
                     causal: bool = False) -> torch.Tensor:
    """Scaled, masked fp32 scores [B, H, Sq, Skv] of the oracle.

    Operands are upcast to fp32 before the product, which is what the JAX
    oracle's ``preferred_element_type=float32`` computes for bf16 and fp32
    inputs (a bf16 x bf16 product is exact in fp32)."""
    k = _repeat_kv(k, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        logits = _causal_masked(logits)
    return logits


def attention_output(logits: torch.Tensor, v: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax of ``logits``, rounded to v's dtype before the PV
    product as in the JAX oracle; [B, Sq, H, D] in ``out_dtype``."""
    v = _repeat_kv(v, logits.shape[1])
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(out_dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False) -> torch.Tensor:
    """Reference attention; fp32 scores and softmax, inputs' dtype out."""
    return attention_output(attention_logits(q, k, causal=causal), v,
                            q.dtype)


def attention(q, k, v, *, causal: bool = False, impl: str = "auto"):
    """Dispatcher used by the models.

    impl: 'auto' | 'xla' | 'flash'. 'auto' takes the flash kernel on the
    card for sequences of at least 1024 tokens that are a multiple of 512
    (the JAX package's rule), else the plain path. 'xla' keeps the JAX
    name for the plain path. 'flash' forces the flash wrapper: its kernel on
    a CUDA tensor (or a ValueError for a shape the kernel does not take),
    its plain version on a CPU one.
    """
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"attn_impl={impl!r} (context parallelism) is not yet ported to "
            "PyTorch; use 'auto', 'xla' or 'flash'")
    if impl == "auto":
        impl = "flash" if _flash_eligible(q, k) else "xla"
    if impl == "flash":
        if q.is_cuda and not _flash_eligible(q, k, explicit=True):
            raise ValueError(
                f"attn_impl='flash' cannot serve q={tuple(q.shape)} "
                f"k={tuple(k.shape)}: the kernel needs seq % 512 == 0 and "
                "head_dim in {64, 128, 256}")
        from pytorch_distributed_training_example_tpu_torch.ops import (
            flash_attention)

        return flash_attention.flash_attention(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attn_impl {impl!r}")
    return dot_product_attention(q, k, v, causal=causal)


def _flash_eligible(q, k, explicit: bool = False) -> bool:
    """Whether the flash kernel can (explicit) / should (auto) run.

    ``auto`` additionally requires seq >= 1024, as in the JAX package (below
    that the plain path is already fast); an explicit ``impl='flash'`` only
    needs the hard shape constraints. Only CUDA tensors qualify, as only a
    TPU did in the JAX package.
    """
    seq_ok = q.shape[1] % 512 == 0 and k.shape[1] % 512 == 0
    if not explicit:
        seq_ok = seq_ok and q.shape[1] >= 1024
    return q.is_cuda and seq_ok and q.shape[-1] in (64, 128, 256)
