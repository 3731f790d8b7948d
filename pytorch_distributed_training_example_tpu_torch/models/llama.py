"""Llama-3 family in PyTorch — counterpart of
``pytorch_distributed_training_example_tpu/models/llama.py``.

RMSNorm (pre-norm, fp32 math), rotary position embeddings (theta 500k, fp32
trig), grouped-query attention, SwiGLU MLP, no biases, untied output head.
Submodule names follow the flax parameter tree (``embed``, ``block_<i>``,
``attn/query|key|value|out``, ``gate``, ``up``, ``down``, ``attn_norm``,
``mlp_norm``, ``final_norm``, ``lm_head``), so ``bridge.py`` maps a JAX
checkpoint leaf by leaf.

Two forwards, as in the JAX module:

- ``model(tokens)`` is the training forward: [B, S] -> [B, S, vocab] fp32.
- ``model(tokens, decode_ctx=...)`` is the serving forward: K/V are
  appended through the page table into the per-layer pools carried in
  ``decode_ctx["cache"]`` (written in place), attention reads the cache,
  and the result is the next-token logits [B, vocab] fp32 taken at
  ``decode_ctx["last_index"]``.

Not ported yet: MoE blocks, ``scan_layers``, remat policies, sequence
parallelism and the speculative-decode ``all_logits`` head.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_example_tpu_torch.ops import (
    attention as attn_lib)
from pytorch_distributed_training_example_tpu_torch.ops import (
    flash_attention as flash_lib)
from pytorch_distributed_training_example_tpu_torch.serve import kv_cache


class RMSNorm(nn.Module):
    """fp32 normalisation, then scale, then cast to the model dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            torch.mean(torch.square(x32), dim=-1, keepdim=True)
            + self.epsilon)
        return (norm * self.weight.float()).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings on [B, S, H, D] (rotate half, fp32 trig).

    Frequencies are ``theta ** (-arange(d/2) / (d/2))`` in fp32, exactly as
    the JAX module computes them (not a float64 ``inv_freq``)."""
    d_half = x.shape[-1] // 2
    exponent = -torch.arange(0, d_half, dtype=torch.float32,
                             device=x.device) / d_half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    angles = positions[..., None].float() * freqs           # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :]                  # over heads
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _linear(fan_in, fan_out, dtype, device):
    return nn.Linear(fan_in, fan_out, bias=False, dtype=dtype, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, d_model, num_heads, num_kv_heads, head_dim,
                 rope_theta, dtype, attn_impl="auto", device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.attn_impl = attn_impl
        self.query = _linear(d_model, num_heads * head_dim, dtype, device)
        self.key = _linear(d_model, num_kv_heads * head_dim, dtype, device)
        self.value = _linear(d_model, num_kv_heads * head_dim, dtype, device)
        self.out = _linear(num_heads * head_dim, d_model, dtype, device)

    def forward(self, x, decode_ctx: dict | None = None, layer: int = 0):
        B, S, _ = x.shape
        q = self.query(x).view(B, S, self.num_heads, self.head_dim)
        k = self.key(x).view(B, S, self.num_kv_heads, self.head_dim)
        v = self.value(x).view(B, S, self.num_kv_heads, self.head_dim)
        if decode_ctx is not None:
            out = self._decode(q, k, v, decode_ctx, layer)
        else:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            q = rope(q, positions, self.rope_theta)
            k = rope(k, positions, self.rope_theta)
            out = attn_lib.attention(q, k, v, causal=True,
                                     impl=self.attn_impl)
        return self.out(out.reshape(B, S, self.num_heads * self.head_dim))

    def _decode(self, q, k, v, decode_ctx, layer):
        """Serving path: RoPE at explicit per-request positions, K/V
        appended through the page table into this layer's pools (in place),
        then attention reads the cache. S == 1 is a decode step (paged
        decode kernel); S > 1 is prefill. A fresh prefill starts at position
        0, where causal self-attention over the chunk is the full answer, so
        it reuses the training dispatcher (the flash kernel for long
        buckets); a window with ``history`` reads back through the page
        table instead."""
        S = q.shape[1]
        positions = decode_ctx["positions"]             # [B, S] int32
        page_table = decode_ctx["page_table"]           # [B, max_pages]
        k_pages, v_pages = decode_ctx["cache"][layer]
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        kv_cache.append_pages(k_pages, k, page_table, positions)
        kv_cache.append_pages(v_pages, v, page_table, positions)
        if S == 1:
            return flash_lib.paged_decode_attention(
                q[:, 0], k_pages, v_pages, page_table, positions[:, 0],
                impl=decode_ctx.get("attn_impl", "auto"))[:, None]
        if decode_ctx.get("history"):
            return flash_lib.paged_prefill_attention(
                q, k_pages, v_pages, page_table, positions)
        return attn_lib.attention(q, k, v, causal=True, impl=self.attn_impl)


class LlamaBlock(nn.Module):
    def __init__(self, d_model, num_heads, num_kv_heads, head_dim, ffn_dim,
                 rope_theta, dtype, attn_impl="auto", device=None):
        super().__init__()
        self.attn_norm = RMSNorm(d_model, dtype=dtype, device=device)
        self.attn = LlamaAttention(d_model, num_heads, num_kv_heads,
                                   head_dim, rope_theta, dtype, attn_impl,
                                   device)
        self.mlp_norm = RMSNorm(d_model, dtype=dtype, device=device)
        self.gate = _linear(d_model, ffn_dim, dtype, device)
        self.up = _linear(d_model, ffn_dim, dtype, device)
        self.down = _linear(ffn_dim, d_model, dtype, device)

    def forward(self, x, decode_ctx: dict | None = None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), decode_ctx, layer)
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class Llama(nn.Module):
    """Dense Llama with the JAX module's defaults (llama3_8b's shape)."""

    def __init__(self, vocab_size: int = 128256, num_layers: int = 32,
                 num_heads: int = 32, num_kv_heads: int = 8,
                 d_model: int = 4096, ffn_dim: int = 14336,
                 max_seq_len: int = 8192, rope_theta: float = 500000.0,
                 dtype=torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.d_model = d_model
        self.ffn_dim = ffn_dim
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.embed = nn.Embedding(vocab_size, d_model, dtype=dtype,
                                  device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", LlamaBlock(
                d_model, num_heads, num_kv_heads, self.head_dim, ffn_dim,
                rope_theta, dtype, attn_impl, device))
        self.final_norm = RMSNorm(d_model, dtype=dtype, device=device)
        self.lm_head = _linear(d_model, vocab_size, dtype, device)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The port's seeded init, drawn where the parameters live (on the
        card for a GPU model: no host round trip for 8B parameters). Linear
        and embedding weights are N(0, 1/fan_in) (lecun normal, untruncated),
        norm scales are ones. JAX draws other bits from the same seed; tests
        that compare the two packages carry weights across with
        ``bridge.py`` instead."""
        device = self.embed.weight.device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:  # Linear [out, in] and Embedding [vocab, d]
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)

    def forward(self, tokens: torch.Tensor, decode_ctx: dict | None = None):
        """``decode_ctx`` switches to the serving forward: a dict with
        ``positions`` [B,S], ``page_table`` [B,max_pages], ``cache`` (one
        (k_pages, v_pages) pair per layer), ``last_index`` [B] and optionally
        ``attn_impl`` / ``history``. Returns next-token logits [B, vocab]
        fp32 at ``last_index``; the training forward returns [B, S, vocab]
        fp32."""
        x = self.embed(tokens)
        for i, block in enumerate(self.blocks()):
            x = block(x, decode_ctx, i)
        if decode_ctx is not None:
            # Only the last real position's logits matter: gather the hidden
            # row BEFORE the [d, vocab] head matmul.
            idx = decode_ctx["last_index"].long()
            x = x[torch.arange(x.shape[0], device=x.device), idx]
        return self.lm_head(self.final_norm(x)).float()


def llama3_8b(**kw) -> Llama:
    return Llama(**kw)


def llama_400m(**kw) -> Llama:
    """One-chip bench scale: full Llama architecture at ~400M params."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("num_layers", 16)
    kw.setdefault("num_heads", 16)
    kw.setdefault("num_kv_heads", 4)
    kw.setdefault("d_model", 1024)
    kw.setdefault("ffn_dim", 4096)
    kw.setdefault("max_seq_len", 2048)
    return Llama(**kw)


def llama_tiny(**kw) -> Llama:
    """Test-scale Llama (same architecture, toy dims)."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("d_model", 128)
    kw.setdefault("ffn_dim", 256)
    kw.setdefault("max_seq_len", 256)
    return Llama(**kw)


def num_params(model: Llama) -> int:
    d, L, V = model.d_model, model.num_layers, model.vocab_size
    hd = model.head_dim
    attn = d * model.num_heads * hd + 2 * d * model.num_kv_heads * hd \
        + model.num_heads * hd * d
    mlp = 3 * d * model.ffn_dim
    return V * d + L * (attn + mlp + 2 * d) + d + d * V
