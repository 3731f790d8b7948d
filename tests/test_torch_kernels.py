"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda``-marked tests need an NVIDIA GPU and nvcc: the kernels have no
CPU or interpret mode, so they skip elsewhere. This file imports neither JAX
nor the JAX package, so on the card it runs without the repository's
conftest (which imports jax):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: fp32 1e-4 (fp32 sums in another order); bf16 2e-2 (outputs are
rounded to bf16, ~4e-3 relative near 1, and the plain flash version rounds
probabilities to bf16 before PV where the kernel keeps them in fp32).
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_example_tpu_torch.ops import (
    _build, flash_attention as flash)
from pytorch_distributed_training_example_tpu_torch.serve.kv_cache import (
    PagePool, pages_for_tokens)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _paged_inputs(B, H, Hkv, D, page_size, num_pages, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = rng.standard_normal((2, num_pages, page_size, Hkv, D)
                             ).astype(np.float32)
    pool = PagePool(num_pages)
    table = np.zeros((B, pages_for_tokens(max(lens) + 1, page_size)),
                     np.int32)
    for b, n in enumerate(lens):
        pages = pool.alloc(f"r{b}", pages_for_tokens(n + 1, page_size))
        table[b, :len(pages)] = pages
    return [torch.from_numpy(a) for a in
            (q, kv[0], kv[1], table, np.asarray(lens, np.int32))]


def _qkv(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    loaded = dict(_build._loaded)
    n_dec = flash.paged_decode_attention.launches
    n_fla = flash.flash_attention_fwd.launches
    args = _paged_inputs(2, 4, 2, 8, 4, 8, [3, 9])
    torch.testing.assert_close(flash.paged_decode_attention(*args),
                               flash.paged_decode_attention_plain(*args))
    q, k, v = _qkv(1, 8, 8, 4, 2, 8)
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(lse, ref_lse)
    assert lse.shape == (1, 4, 8) and lse.dtype == torch.float32
    assert flash.paged_decode_attention.launches == n_dec
    assert flash.flash_attention_fwd.launches == n_fla
    assert _build._loaded == loaded


def test_library_names_follow_source_and_flags():
    src, lib = _build._paths("paged_decode")
    assert src.endswith("csrc/paged_decode.cu") and lib.endswith(".so")
    assert lib.startswith(_build.BUILD_DIR)
    assert set(_build.SOURCES) == {"paged_decode", "flash_fwd"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (8, 8, 64), (4, 1, 128)])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, H, Hkv, D):
    # Page edges at 16: first slot, last slot, first of the next page, a
    # long tail; the last row is a filler row on the scratch page.
    lens = [0, 15, 16, 17, 250, 1023, 0]
    args = _paged_inputs(len(lens), H, Hkv, D, 16, 160, lens)
    args[3][-1] = 0
    args = [t.to(cuda_device) for t in args]
    args[:3] = [t.to(dtype) for t in args[:3]]
    n = flash.paged_decode_attention.launches
    got = flash.paged_decode_attention(*args)
    assert flash.paged_decode_attention.launches == n + 1
    ref = flash.paged_decode_attention(*args, impl="xla")
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 1024, 32, 8, 128),
                                         (2, 200, 4, 2, 64),
                                         (1, 192, 2, 1, 256)])
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, causal, B, S, H,
                                        Hkv, D):
    q, k, v = (t.to(cuda_device, dtype) for t in _qkv(B, S, S, H, Hkv, D))
    n = flash.flash_attention_fwd.launches
    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    assert flash.flash_attention_fwd.launches == n + 1
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and lse.shape == (B, H, S)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_kernels_take_fp16_in_fp32_and_reject_bad_args(cuda_device):
    q, k, v = (t.to(cuda_device) for t in _qkv(1, 128, 128, 4, 2, 64))
    out, _ = flash.flash_attention_fwd(q.half(), k.half(), v.half(),
                                       causal=True)
    ref, _ = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    assert out.dtype == torch.float16
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_fwd(q[..., :48].contiguous(),
                                  k[..., :48].contiguous(),
                                  v[..., :48].contiguous())
    args = [t.to(cuda_device) for t in _paged_inputs(1, 4, 2, 64, 16, 4,
                                                     [5])]
    with pytest.raises(ValueError, match="same CUDA device"):
        flash.paged_decode_attention(args[0], args[1], args[2],
                                     args[3].cpu(), args[4])
