"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda``-marked tests need an NVIDIA GPU and nvcc: the kernels have no
CPU or interpret mode, so they skip elsewhere. This file imports neither JAX
nor the JAX package, so on the card it runs without the repository's
conftest (which imports jax):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: fp32 1e-4 (fp32 sums in another order); bf16 2e-2 (outputs are
rounded to bf16, ~4e-3 relative near 1, and the plain flash version rounds
probabilities to bf16 before PV where the kernel keeps them in fp32). The
backward's gradients span orders of magnitude (late keys and rows of a
causal sequence get small ones), so each element is held to its own scale,
|got - ref| <= rtol |ref| + c rms(ref), and each tensor's relative L2 error
to a bound (``GRAD_TOL``). For bf16 and fp16, c is four eps of the dtype
(the kernel and the plain version round p and ds from scores summed in
another order, and a rounding that flips moves one term of a sum by an
ulp), rtol 2e-2 (bf16) or 2e-3 (fp16); fp32 takes 1e-4 for both. A kernel that drops one tile's share of the sums
fails this (``test_flash_bwd_check_catches_dropped_tiles``). Grads through
``attention()`` are held against the plain path's autograd, which rounds a
different product to bf16 (dp, the grad of its bf16 probabilities, where
the kernel rounds ds): one more rounding of every term, so c is 2^-3 and
the L2 bound 1e-2 there (``PATH_GRAD_TOL``).

The paged decode kernel is held at page edges, half and all of
llama3_8b's context (positions 4095 and 8191), G in {1, 4, 8}, and at the
serving engine's table width (255 columns, the unused ones holding other
requests' pages), to ``TOL`` and to a relative L2 bound (``PAGED_L2``:
bf16 5e-3, fp32 1e-5; at long positions the outputs are small, so the max
error alone does not see a lost split); two bf16 calls give the same bits
(``test_paged_decode_is_bitwise_reproducible``), and a kernel whose
combine leaves a request's last split out fails the check
(``test_paged_decode_check_catches_a_dropped_split``).

The causal forward is held at llama3_8b's prefill, a ragged prompt
(S 1000), small ragged shapes and llama_moe's training microbatch (GQA
16/4, S 2048); two calls give the same bits
(``test_flash_fwd_is_bitwise_reproducible``), and a kernel that leaves the
tiles crossing the diagonal unmasked fails the check
(``test_flash_fwd_check_catches_unmasked_diagonal``).

The forward with ``kv_len`` (the one-shot kernels' contract, which the
padded path runs) is held in the forward's tolerances at ViT-B/16's
microbatch (197 tokens padded to 256), a causal case, a GQA case, and
the causal forward at S 256 without ``kv_len`` (the chunked one-shot
body's contract), with random, non-zero values in the padded rows: a
kernel that ignores ``kv_len`` fails the check
(``test_flash_fwd_kv_len_check_catches_ignored_kv_len``). Grads through
the padded path are held as the other path grads.

The MoE kernels, at the llama_moe shapes with uneven routing (one expert
empty, one holding over half the rows and ending mid-tile): the grouped
matmul's outputs in the same elementwise form (``GMM_TOL``: bf16 one ulp,
2^-7 |ref|, twice over; fp32 1e-4 |ref| + 1e-5 rms), which fails a planted
kernel that leaves one K slice of one tile out
(``test_gmm_check_catches_a_dropped_k_slice``), its fp32 weight gradient
in the backward's (``GRAD_TOL``), which fails a planted kernel that leaves
one slice of one expert's rows out
(``test_gmm_dw_check_catches_a_dropped_row_tile``); grads through
``grouped_ffn`` in ``PATH_GRAD_TOL``'s. Both bf16 kernels give the same
bits call to call, each gmm row keeps its bits wherever it falls in its
tile, and edge routings (one expert holding every row, segments of 1-7
rows, 37 rows, one expert, dw's split of a heavy expert) match. The fused router's expert choices
equal the plain version's except on rows that are near ties (the plain
version's two probabilities at the first differing rank within 4 ulp), its
gates, logsumexp and mean probabilities within 1e-6, at T 1, 129 and 8192
and E up to 64; two calls give the same bits, and a kernel whose merge
leaves one block's partial out fails the check
(``test_fused_router_check_catches_a_dropped_block``).

The fused BN-stats matmul (K3), at the bench's three ResNet-50 shapes and
ragged ones (rows and columns no multiple of a tile, fewer rows than a
tile, more than 256 columns, with and without the affine prologue and
ReLU): y in ``GMM_TOL``'s form, the mean and the biased variance of each
column within 1e-5 of its root mean square and mean square
(``BN_STATS_TOL``: fp32 sums of the same products in another order), y
and the statistics bitwise the same on a second call. A kernel whose
merge leaves one block's partial out of the statistics fails the check
(``test_fused_bn_matmul_check_catches_a_dropped_partial``). The router and
the BN-stats matmul are one kernel a call, counted under torch.profiler.
"""

import ctypes
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from pytorch_distributed_training_example_tpu_torch.ops import (
    _build, attention as attn, flash_attention as flash,
    fused_bn_matmul as fbm, fused_router as router, grouped_matmul as gmm)
from pytorch_distributed_training_example_tpu_torch.serve.kv_cache import (
    PagePool, pages_for_tokens)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: Backward grads: (rtol of |ref|, c of rms(ref), relative L2 bound).
GRAD_TOL = {torch.float32: (1e-4, 1e-4, 1e-5),
            torch.bfloat16: (2e-2, 2.0 ** -5, 5e-3),
            torch.float16: (2e-3, 2.0 ** -8, 2e-3)}
PATH_GRAD_TOL = {**GRAD_TOL, torch.bfloat16: (2e-2, 2.0 ** -3, 1e-2)}


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
    n_bwd = flash.flash_attention_bwd.launches
    args = _paged_inputs(2, 4, 2, 8, 4, 8, [3, 9])
    torch.testing.assert_close(flash.paged_decode_attention(*args),
                               flash.paged_decode_attention_plain(*args))
    q, k, v = _qkv(1, 8, 8, 4, 2, 8)
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(lse, ref_lse)
    assert lse.shape == (1, 4, 8) and lse.dtype == torch.float32
    grads = flash.flash_attention_bwd(q, k, v, out, lse, q, causal=True)
    ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, q, causal=True)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r)
    assert flash.paged_decode_attention.launches == n_dec
    assert flash.flash_attention_fwd.launches == n_fla
    assert flash.flash_attention_bwd.launches == n_bwd
    assert _build._loaded == loaded


def test_library_names_follow_source_and_flags():
    src, lib = _build._paths("paged_decode")
    assert src.endswith("csrc/paged_decode.cu") and lib.endswith(".so")
    assert lib.startswith(_build.BUILD_DIR)
    assert set(_build.SOURCES) == {"paged_decode", "flash_fwd", "flash_bwd",
                                   "grouped_matmul", "fused_router",
                                   "fused_bn_matmul"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


class _FakeLibrary:
    """Stands in for a ctypes.CDLL: each attribute is an object of its own
    that takes argtypes and restype."""

    def __getattr__(self, name):
        fn = type(name, (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("getter,library,symbol", [
    (flash._flash_fwd_fn, "flash_fwd", "pdtx_flash_fwd"),
    (flash._flash_bwd_fn, "flash_bwd", "pdtx_flash_bwd"),
    (flash._paged_decode_fn, "paged_decode", "pdtx_paged_decode"),
    (gmm._gmm_fn, "grouped_matmul", "pdtx_gmm"),
    (gmm._gmm_dw_fn, "grouped_matmul", "pdtx_gmm_dw"),
    (router._router_fn, "fused_router", "pdtx_fused_router"),
    (fbm._kernel_fn, "fused_bn_matmul", "pdtx_bn_matmul")],
    ids=["flash_fwd", "flash_bwd", "paged_decode", "gmm", "gmm_dw",
         "fused_router", "fused_bn_matmul"])
def test_using_swaps_a_library_and_restores_it(getter, library, symbol):
    """Inside ``_build.using`` a wrapper's cached C function comes from the
    library given; after it, from the one loaded before, or none."""
    def fn():
        got = getter()
        return got[0] if isinstance(got, tuple) else got

    loaded = dict(_build._loaded)
    outer, inner = _FakeLibrary(), _FakeLibrary()
    with _build.using(library, outer):
        assert fn() is getattr(outer, symbol)
        with _build.using(library, inner):
            assert fn() is getattr(inner, symbol)
        assert fn() is getattr(outer, symbol)
    assert _build._loaded == loaded
    assert getter.cache_info().currsize == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: Paged decode outputs, relative L2 error beside ``TOL``: at long
#: positions the outputs are small, so the max error alone does not see a
#: dropped split. bf16 rounds the probabilities before P V and the output
#: (2^-9 relative each, ~2e-3 together); fp32 sums in another order.
PAGED_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _paged_close(got, ref, dtype) -> bool:
    diff = got.float() - ref.float()
    return bool(diff.abs().max() <= TOL[dtype]
                and diff.norm() <= PAGED_L2[dtype] * ref.float().norm())


def _engine_width(args, width, seed=0):
    """The page table widened to ``width`` columns (the serving engine's
    255), the columns past each request's pages holding other requests'
    pages: in range, so the plain version's gather reads them, and never
    attended to."""
    rng = np.random.default_rng(seed)
    table, lens = args[3], args[4]
    pages = np.unique(table.numpy())
    wide = np.zeros((table.shape[0], width), np.int32)
    for b, n in enumerate(lens.tolist()):
        k = pages_for_tokens(n + 1, 16)
        wide[b, :k] = table[b, :k].numpy()
        wide[b, k:] = rng.choice(pages[pages > 0], width - k)
    return args[:3] + [torch.from_numpy(wide), lens]


def _paged_cuda(lens, H, Hkv, D, num_pages, dtype, device, seed=0):
    args = _paged_inputs(len(lens), H, Hkv, D, 16, num_pages, lens, seed)
    args = [t.to(device) for t in args]
    args[:3] = [t.to(dtype) for t in args[:3]]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["tight", "engine_width"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (8, 8, 64), (4, 1, 128),
                                     (64, 8, 128)])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, H, Hkv, D,
                                           table):
    # Page edges at 16: first slot, last slot, first of the next page, a
    # long tail, and at a tight table half and all of llama3_8b's context;
    # the last row is a filler row on the scratch page. At the engine's
    # width (255 columns) the columns past each request's pages hold other
    # requests' pages.
    lens = [0, 15, 16, 17, 250, 1023, 0]
    if table == "tight":
        lens[-1:-1] = [4095, 8191]
    args = _paged_inputs(len(lens), H, Hkv, D, 16, 900, lens)
    args[3][-1] = 0
    if table == "engine_width":
        args = _engine_width(args, 255)
    args = [t.to(cuda_device) for t in args]
    args[:3] = [t.to(dtype) for t in args[:3]]
    n = flash.paged_decode_attention.launches
    got = flash.paged_decode_attention(*args)
    assert flash.paged_decode_attention.launches == n + 1
    ref = flash.paged_decode_attention(*args, impl="xla")
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    assert _paged_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[8191], [2047] * 8,
                                  [0, 15, 16, 47, 300, 511, 767, 1023]],
                         ids=["B1_long", "B8_long", "B8"])
def test_paged_decode_is_bitwise_reproducible(cuda_device, lens):
    """No float atomics: the splits of a request merge in split order, so
    two bf16 calls give the same bits."""
    args = _paged_cuda(lens, 32, 8, 128, 1100, torch.bfloat16, cuda_device)
    assert torch.equal(flash.paged_decode_attention(*args),
                       flash.paged_decode_attention(*args))


#: The planted fault: the combine leaves the last split of each (request,
#: KV head) out.
_DROPPED_SPLIT = (
    "  const int n_merge = n_live;\n",
    "  const int n_merge = n_live - 1;  // planted fault: last split dropped\n")


@pytest.mark.cuda
def test_paged_decode_check_catches_a_dropped_split(cuda_device, tmp_path):
    """At llama3_8b's full context (B=1, position 8191), bf16, the paged
    decode check passes the kernel as built and fails a build whose combine
    leaves each (request, KV head)'s last split out."""
    with open(os.path.join(_build.CSRC_DIR, "paged_decode.cu")) as f:
        source = f.read()
    old, new = _DROPPED_SPLIT
    assert source.count(old) == 1
    src = tmp_path / "paged_decode_fault.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / "libpaged_decode_fault.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    args = _paged_cuda([8191], 32, 8, 128, 600, torch.bfloat16, cuda_device)
    ref = flash.paged_decode_attention(*args, impl="xla")
    assert _paged_close(flash.paged_decode_attention(*args), ref,
                        torch.bfloat16)
    with _build.using("paged_decode", ctypes.CDLL(str(lib))):
        assert not _paged_close(flash.paged_decode_attention(*args), ref,
                                torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 1024, 32, 8, 128),
                                         (2, 200, 4, 2, 64),
                                         (1, 192, 2, 1, 256),
                                         (4, 2048, 16, 4, 64),
                                         (1, 1000, 32, 8, 128)])
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


#: K1o cases (B, S, H, Hkv, D, causal, kv_len): ViT-B/16's microbatch, a
#: causal case with kv_len, a GQA case, and the causal forward at S 256
#: with no kv_len (the contract of ``_oneshot_fwd_kernel_chunked``).
KV_LEN_CASES = [(128, 256, 12, 12, 64, False, 197),
                (2, 256, 8, 8, 64, True, 150),
                (2, 320, 8, 2, 128, False, 250),
                (128, 256, 12, 12, 64, True, None)]


def _kv_len_fwd_close(q, k, v, causal, kv_len) -> bool:
    """The forward against its plain version in the forward's tolerances
    (``TOL`` for the output, 1e-3 for lse), with finite lse everywhere."""
    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal,
                                         kv_len=kv_len)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                   kv_len=kv_len)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    print(json.dumps({"max_abs_err": err, "lse_max_abs_err": lse_err}))
    return bool(torch.isfinite(lse).all()) and err <= TOL[q.dtype] \
        and lse_err <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,kv_len", KV_LEN_CASES)
def test_flash_fwd_kv_len_kernel_matches_plain(cuda_device, dtype, B, S, H,
                                               Hkv, D, causal, kv_len):
    """Every row of q, k and v is random, the padded ones too; a kv_len
    call counts as the one-shot forward's launch, not the online one's."""
    q, k, v = (t.to(cuda_device, dtype) for t in _qkv(B, S, S, H, Hkv, D))
    n_online = flash.flash_attention_fwd.launches
    n_oneshot = flash.flash_attention_fwd_kv_len.launches
    assert _kv_len_fwd_close(q, k, v, causal, kv_len)
    assert flash.flash_attention_fwd_kv_len.launches == \
        n_oneshot + (kv_len is not None)
    assert flash.flash_attention_fwd.launches == n_online + (kv_len is None)
    with pytest.raises(ValueError, match="kv_len"):
        flash.flash_attention_fwd(q, k, v, kv_len=0)
    with pytest.raises(ValueError, match="kv_len"):
        flash.flash_attention_fwd(q, k, v, kv_len=S + 1)


#: The planted fault: the forward kernel ignores kv_len (attends to every
#: key, the padded ones too).
IGNORED_KV_LEN = (
    "  if (kv_len < 1 || kv_len > Skv) return (int)cudaErrorInvalidValue;\n",
    "  kv_len = Skv;  // planted fault: kv_len ignored\n")


@pytest.mark.cuda
def test_flash_fwd_kv_len_check_catches_ignored_kv_len(cuda_device, tmp_path):
    """At ViT-B/16's shape (batch cut to 8), bf16, the forward check passes
    the kernel as built and fails a build that ignores kv_len."""
    with open(os.path.join(_build.CSRC_DIR, "flash_fwd.cu")) as f:
        source = f.read()
    old, new = IGNORED_KV_LEN
    assert source.count(old) == 1
    src = tmp_path / "flash_fwd_fault.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / "libflash_fwd_fault.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _qkv(8, 256, 256, 12, 12, 64))
    assert _kv_len_fwd_close(q, k, v, False, 197)
    with _build.using("flash_fwd", ctypes.CDLL(str(lib))):
        assert not _kv_len_fwd_close(q, k, v, False, 197)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 1024, 12, 12, 64),
                                         (1, 2048, 16, 4, 64),
                                         (1, 1000, 32, 8, 128)])
def test_flash_fwd_is_bitwise_reproducible(cuda_device, B, S, H, Hkv, D):
    """Two calls give identical bf16 outputs and lse, at the gpt2 shape
    (batch cut to 2), llama_moe's GQA 16/4 heads and a ragged prompt."""
    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _qkv(B, S, S, H, Hkv, D))
    first = flash.flash_attention_fwd(q, k, v, causal=True)
    second = flash.flash_attention_fwd(q, k, v, causal=True)
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


#: The planted fault: the wgmma forward leaves the key tiles that cross the
#: diagonal unmasked.
UNMASKED_DIAGONAL = (
    "  const bool edge = (causal && k0 + kBN - 1 > qw0) || k0 + kBN > kvl;\n",
    "  const bool edge = k0 + kBN > kvl;  // planted fault: diagonal open\n")


def _causal_fwd_close(q, k, v) -> bool:
    """The causal forward against its plain version in the forward's
    tolerances (``TOL`` for the output, 1e-3 for lse)."""
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    print(json.dumps({"max_abs_err": err, "lse_max_abs_err": lse_err}))
    return err <= TOL[q.dtype] and lse_err <= 1e-3


@pytest.mark.cuda
def test_flash_fwd_check_catches_unmasked_diagonal(cuda_device, tmp_path):
    """At the gpt2 training shape (batch cut to 2), bf16, the causal check
    passes the kernel as built and fails a build that leaves the diagonal
    tiles unmasked."""
    with open(os.path.join(_build.CSRC_DIR, "flash_fwd.cu")) as f:
        source = f.read()
    old, new = UNMASKED_DIAGONAL
    assert source.count(old) == 1
    src = tmp_path / "flash_fwd_fault.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / "libflash_fwd_fault.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _qkv(2, 1024, 1024, 12, 12, 64))
    assert _causal_fwd_close(q, k, v)
    with _build.using("flash_fwd", ctypes.CDLL(str(lib))):
        assert not _causal_fwd_close(q, k, v)


def _grad_errors(got, ref, tol):
    """Per tensor: the worst |got - ref| / (rtol |ref| + c rms(ref)) over
    its elements (at most 1 passes) and its relative L2 error."""
    rtol, c, _ = tol
    tiny = torch.finfo(torch.float32).tiny
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        g, r = g.float(), r.float()
        diff = (g - r).abs()
        scale = rtol * r.abs() + c * r.square().mean().sqrt()
        out[name] = (float((diff / scale.clamp_min(tiny)).max()),
                     float(diff.norm() / r.norm().clamp_min(tiny)))
    return out


def _grads_close(got, ref, tol) -> bool:
    errs = _grad_errors(got, ref, tol)
    print(json.dumps(errs))  # (worst / bound, relative L2), shown with -rP
    return all(w <= 1 and l2 <= tol[2] for w, l2 in errs.values())


def _assert_grads_close(got, ref, tol):
    assert _grads_close(got, ref, tol), \
        f"(worst / bound, relative L2) over {tol}: {_grad_errors(got, ref, tol)}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None),
                                           (False, 150)])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 256, 8, 2, 128),
                                         (2, 200, 4, 4, 64),
                                         (1, 192, 2, 1, 256),
                                         (1, 2048, 16, 4, 64)])
def test_flash_bwd_kernel_matches_plain(cuda_device, dtype, causal, kv_len,
                                        B, S, H, Hkv, D):
    q, k, v = (t.to(cuda_device, dtype) for t in _qkv(B, S, S, H, Hkv, D))
    do = _qkv(B, S, S, H, Hkv, D, seed=1)[0].to(cuda_device, dtype)
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             kv_len=kv_len)
    n = flash.flash_attention_bwd.launches
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    kv_len=kv_len)
    assert flash.flash_attention_bwd.launches == n + 1
    ref = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                          kv_len=kv_len)
    _assert_grads_close(got, ref, GRAD_TOL[dtype])


#: Planted faults in the bf16 wgmma passes' consumer loops, each one
#: tile's share of the sums dropped where gradients are small (the tile is
#: still waited for and its stage freed, so the ring stays in step): key
#: tile 0 from the dq of the last quarter of the rows, the last q tile from
#: the dk/dv of the last quarter of the keys.
_DROPPED_TILES = {
    "dq": ("  for (int t = 0; t < n_tiles; ++t) {\n"
           "    const int k0 = t * kKv;\n"
           "    const bool skip = qw0 >= a.Sq || (a.causal && k0 > qw0 + 63);",
           "  for (int t = 0; t < n_tiles; ++t) {\n"
           "    const int k0 = t * kKv;\n"
           "    const bool skip = qw0 >= a.Sq || (a.causal && k0 > qw0 + 63) ||\n"
           "                      (t == 0 && q0 >= a.Sq * 3 / 4);"),
    "dkv": ("    const int qs0 = t * kQ;\n"
            "    const bool skip = !live || (a.causal && qs0 + kQ <= kw0);",
            "    const int qs0 = t * kQ;\n"
            "    const bool skip = !live || (a.causal && qs0 + kQ <= kw0) ||\n"
            "                      (t == t0 + n_t - 1 && k0 >= a.Skv * 3 / 4);"),
}


@pytest.mark.cuda
def test_flash_bwd_check_catches_dropped_tiles(cuda_device, tmp_path):
    """The bf16 grad check is sharp enough to fail a kernel that drops one
    tile's share of dq or of dk/dv, at the gpt2 training shape (batch cut
    to 2), where the same check passes the kernel as built."""
    with open(os.path.join(_build.CSRC_DIR, "flash_bwd.cu")) as f:
        source = f.read()
    procs = {}
    for name, (old, new) in _DROPPED_TILES.items():
        assert source.count(old) == 1, name
        src = tmp_path / f"flash_bwd_{name}.cu"
        src.write_text(source.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", str(tmp_path / f"lib_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out

    dtype, tol = torch.bfloat16, GRAD_TOL[torch.bfloat16]
    q, k, v = (t.to(cuda_device, dtype) for t in _qkv(2, 1024, 1024, 12, 12, 64))
    do = _qkv(2, 1024, 1024, 12, 12, 64, seed=1)[0].to(cuda_device, dtype)
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    ref = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert _grads_close(flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=True), ref, tol)
    for name in _DROPPED_TILES:
        with _build.using("flash_bwd",
                          ctypes.CDLL(str(tmp_path / f"lib_{name}.so"))):
            got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        # What a bound of 2e-2 of the largest gradient would have read.
        print(json.dumps({"dropped": name, "max_abs_err": max(
            float((g.float() - r.float()).abs().max())
            for g, r in zip(got, ref)), "bound_2e-2_of_max": 2e-2 * max(
            float(r.float().abs().max()) for r in ref)}))
        assert not _grads_close(got, ref, tol), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv", [(2, 1024, 12, 12), (1, 2048, 16, 4)])
def test_flash_bwd_is_bitwise_reproducible(cuda_device, B, S, H, Hkv):
    """No atomics: two calls give identical bf16 dq, dk, dv, at the gpt2
    shape (batch cut to 2) and at llama_moe's GQA 16/4 heads."""
    dtype = torch.bfloat16
    q, k, v = (t.to(cuda_device, dtype) for t in _qkv(B, S, S, H, Hkv, 64))
    do = _qkv(B, S, S, H, Hkv, 64, seed=1)[0].to(cuda_device, dtype)
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    first = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = flash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_grads_through_kernels_match_plain(cuda_device, dtype):
    """A CUDA call with requires_grad keeps its graph: attention() takes the
    forward and backward kernels and its grads equal the plain path's."""
    B, S, H, Hkv, D = 2, 1024, 4, 2, 64
    leaves = [t.to(cuda_device, dtype).requires_grad_()
              for t in _qkv(B, S, S, H, Hkv, D)]
    g = _qkv(B, S, S, H, Hkv, D, seed=1)[0].to(cuda_device, dtype)
    n_fwd = flash.flash_attention_fwd.launches
    n_bwd = flash.flash_attention_bwd.launches
    out = attn.attention(*leaves, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    assert flash.flash_attention_fwd.launches == n_fwd + 1
    assert flash.flash_attention_bwd.launches == n_bwd + 1
    ref_out = attn.attention(*leaves, causal=True, impl="xla")
    ref = torch.autograd.grad(ref_out, leaves, g)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[dtype],
                               rtol=0)
    _assert_grads_close(got, ref, PATH_GRAD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_attention_grads_through_kernels_match_plain(cuda_device,
                                                            dtype):
    """ViT-B/16's 197 tokens under impl='flash': the padded path launches
    the kv_len forward and the backward once each, and its output and
    grads equal the plain path's."""
    B, S, H, D = 4, 197, 12, 64
    leaves = [t.to(cuda_device, dtype).requires_grad_()
              for t in _qkv(B, S, S, H, H, D)]
    g = _qkv(B, S, S, H, H, D, seed=1)[0].to(cuda_device, dtype)
    n_fwd = flash.flash_attention_fwd_kv_len.launches
    n_bwd = flash.flash_attention_bwd.launches
    out = attn.attention(*leaves, impl="flash")
    assert out.shape == (B, S, H, D)
    got = torch.autograd.grad(out, leaves, g)
    assert flash.flash_attention_fwd_kv_len.launches == n_fwd + 1
    assert flash.flash_attention_bwd.launches == n_bwd + 1
    ref_out = attn.attention(*leaves, impl="xla")
    ref = torch.autograd.grad(ref_out, leaves, g)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[dtype],
                               rtol=0)
    _assert_grads_close(got, ref, PATH_GRAD_TOL[dtype])


@pytest.mark.cuda
def test_flash_bwd_takes_fp16_in_fp32_and_rejects_bad_args(cuda_device):
    q, k, v, do = (t.to(cuda_device).half() for t in
                   _qkv(1, 128, 128, 4, 2, 64) + _qkv(1, 128, 128, 4, 2, 64,
                                                      seed=1)[:1])
    o, lse = flash.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                             causal=True)
    ref = flash.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                          lse, do.float(), causal=True)
    got = flash.flash_attention_bwd(q, k, v, o.half(), lse, do, causal=True)
    assert [t.dtype for t in got] == [torch.float16] * 3
    _assert_grads_close([t.float() for t in got],
                        [t.half().float() for t in ref],
                        GRAD_TOL[torch.float16])
    q, k, v, do = (t.float() for t in (q, k, v, do))
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, k, v, o, lse[:, :2].contiguous(), do)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_bwd(q, k, v, o, lse,
                                  do.transpose(1, 2).contiguous()
                                  .transpose(1, 2))


# ---------------------------------------------------------------------------
# MoE: grouped matmul (K4a, K4b) and fused router (K5)
# ---------------------------------------------------------------------------

#: gmm outputs, rounded to the operand dtype on both sides: (rtol of |ref|,
#: c of rms(ref), relative L2). A bf16 element differs where the two fp32
#: sums round to neighbouring bf16 values: one ulp, at most 2^-7 |ref|.
GMM_TOL = {torch.float32: (1e-4, 1e-5, 1e-5),
           torch.bfloat16: (2.0 ** -6, 2.0 ** -8, 5e-3)}


def _moe_segments(Tk, E, device="cpu"):
    """Uneven routing: expert 0 empty, expert 1 over half the rows (its
    segment ends mid-tile), the rest spread unevenly."""
    heavy = Tk // 2 + min(40, Tk // 4)
    weights = np.arange(1, E - 1)
    rest = np.random.default_rng(7).multinomial(Tk - heavy,
                                                weights / weights.sum())
    counts = np.concatenate([[0, heavy], rest]).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return (torch.from_numpy(starts).to(device),
            torch.from_numpy(counts).to(device))


def _elementwise_close(got, ref, tol) -> bool:
    rtol, c, l2 = tol
    tiny = torch.finfo(torch.float32).tiny
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    worst = float((diff / (rtol * r.abs() + c * r.square().mean().sqrt())
                   .clamp_min(tiny)).max())
    rel_l2 = float(diff.norm() / r.norm().clamp_min(tiny))
    print(json.dumps({"worst_over_bound": worst, "rel_l2": rel_l2}))
    return worst <= 1 and rel_l2 <= l2


def test_moe_wrappers_take_plain_versions_on_cpu():
    loaded = dict(_build._loaded)
    counts = (gmm.grouped_matmul.launches, gmm.grouped_matmul_dw.launches,
              router.fused_router_fwd.launches)
    starts, cnt = _moe_segments(64, 4)
    x = torch.randn(64, 16)
    w = torch.randn(4, 16, 8)
    torch.testing.assert_close(gmm.grouped_matmul(x, w, starts, cnt),
                               gmm.grouped_matmul_plain(x, w, starts, cnt))
    dout = torch.randn(64, 8)
    torch.testing.assert_close(gmm.grouped_matmul_dw(x, dout, starts, cnt),
                               gmm.grouped_matmul_dw_plain(x, dout, starts,
                                                           cnt))
    logits = torch.randn(40, 8)
    for a, b in zip(router.fused_router_fwd(logits, 2),
                    router.fused_router_plain(logits, 2)):
        torch.testing.assert_close(a, b)
    assert (gmm.grouped_matmul.launches, gmm.grouped_matmul_dw.launches,
            router.fused_router_fwd.launches) == counts
    assert _build._loaded == loaded


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,transpose_w", [(1024, 2048, False),
                                             (2048, 1024, False),
                                             (2048, 1024, True),
                                             (40, 24, True)])
def test_gmm_kernel_matches_plain(cuda_device, dtype, K, N, transpose_w):
    E, Tk = 8, 4100
    starts, counts = _moe_segments(Tk, E, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(Tk, K, generator=gen, device=cuda_device).to(dtype)
    shape = (E, N, K) if transpose_w else (E, K, N)
    w = (torch.randn(*shape, generator=gen, device=cuda_device)
         / K ** 0.5).to(dtype)
    n = gmm.grouped_matmul.launches
    got = gmm.grouped_matmul(x, w, starts, counts, transpose_w=transpose_w)
    assert gmm.grouped_matmul.launches == n + 1
    ref = gmm.grouped_matmul_plain(x, w, starts, counts,
                                   transpose_w=transpose_w)
    assert got.dtype == dtype and got.shape == (Tk, N)
    assert _elementwise_close(got, ref, GMM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N", [(1024, 2048), (2048, 1024), (40, 24)])
def test_gmm_dw_kernel_matches_plain(cuda_device, dtype, M, N):
    E, Tk = 8, 4100
    starts, counts = _moe_segments(Tk, E, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(Tk, M, generator=gen, device=cuda_device).to(dtype)
    dout = torch.randn(Tk, N, generator=gen, device=cuda_device).to(dtype)
    n = gmm.grouped_matmul_dw.launches
    got = gmm.grouped_matmul_dw(x, dout, starts, counts)
    assert gmm.grouped_matmul_dw.launches == n + 1
    ref = gmm.grouped_matmul_dw_plain(x, dout, starts, counts)
    assert got.dtype == torch.float32 and not got[0].any()
    assert _elementwise_close(got, ref, GRAD_TOL[dtype])


#: The planted faults. dw: the plan leaves the first 64-row slice of expert
#: 1's first row chunk out. gmm: work item 0 (the first row tile's first
#: column tile) leaves its last 64-deep K slice out.
_DROPPED_ROWS = (
    "      const int k0 = start[e] + j * s;\n",
    "      const int k0 = start[e] + j * s + (e == 1 && j == 0 ? kSliceK : 0);\n")
_DROPPED_SLICE = ("    n_k = (a.K + kSliceK - 1) / kSliceK;\n",
                  "    n_k = (a.K + kSliceK - 1) / kSliceK - (i == 0);\n")


def _planted_gmm(tmp_path, fault, name):
    """A build of grouped_matmul.cu with the fault's line replaced."""
    with open(os.path.join(_build.CSRC_DIR, "grouped_matmul.cu")) as f:
        source = f.read()
    old, new = fault
    assert source.count(old) == 1
    src = tmp_path / f"grouped_matmul_{name}.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / f"libgmm_{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.mark.cuda
def test_gmm_dw_check_catches_a_dropped_row_tile(cuda_device, tmp_path):
    """The dw check fails a kernel that leaves the first 64-row slice of
    one expert's first row chunk out of its sum, at the llama_moe
    up-projection shape, where it passes the kernel as built."""
    fault = _planted_gmm(tmp_path, _DROPPED_ROWS, "rows")
    starts, counts = _moe_segments(16384, 8, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(16384, 1024, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    dout = torch.randn(16384, 2048, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    ref = gmm.grouped_matmul_dw_plain(x, dout, starts, counts)
    tol = GRAD_TOL[torch.bfloat16]
    assert _elementwise_close(gmm.grouped_matmul_dw(x, dout, starts, counts),
                              ref, tol)
    with _build.using("grouped_matmul", fault):
        got = gmm.grouped_matmul_dw(x, dout, starts, counts)
    assert not _elementwise_close(got, ref, tol)


@pytest.mark.cuda
def test_gmm_check_catches_a_dropped_k_slice(cuda_device, tmp_path):
    """The gmm check fails a kernel that leaves one 64-deep K slice of one
    tile out, at the llama_moe up and dx_down shapes (w read as stored and
    transposed), where it passes the kernel as built."""
    fault = _planted_gmm(tmp_path, _DROPPED_SLICE, "slice")
    starts, counts = _moe_segments(16384, 8, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(16384, 1024, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    tol = GMM_TOL[torch.bfloat16]
    for transpose_w in (False, True):
        w = (torch.randn(8, 1024, 2048, generator=gen, device=cuda_device)
             / 32).to(torch.bfloat16)
        if transpose_w:
            w = w.transpose(1, 2).contiguous()
        args = (x, w, starts, counts)
        ref = gmm.grouped_matmul_plain(*args, transpose_w=transpose_w)
        assert _elementwise_close(
            gmm.grouped_matmul(*args, transpose_w=transpose_w), ref, tol)
        with _build.using("grouped_matmul", fault):
            got = gmm.grouped_matmul(*args, transpose_w=transpose_w)
        assert not _elementwise_close(got, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gmm", "gmm_transpose_w", "gmm_dw"])
def test_gmm_kernels_are_bitwise_reproducible(cuda_device, kernel):
    """No float atomics: two calls give the same bits, the dw one with its
    heavy expert split into row chunks whose partials are summed."""
    starts, counts = _moe_segments(16384, 8, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(16384, 1024, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    if kernel == "gmm_dw":
        dout = torch.randn(16384, 2048, generator=gen, device=cuda_device).to(
            torch.bfloat16)
        run = lambda: gmm.grouped_matmul_dw(x, dout, starts, counts)
    else:
        transpose_w = kernel == "gmm_transpose_w"
        shape = (8, 2048, 1024) if transpose_w else (8, 1024, 2048)
        w = (torch.randn(*shape, generator=gen, device=cuda_device) / 32).to(
            torch.bfloat16)
        run = lambda: gmm.grouped_matmul(x, w, starts, counts,
                                         transpose_w=transpose_w)
    assert torch.equal(run(), run())


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_w", [False, True])
def test_gmm_rows_do_not_depend_on_their_tile_offset(cuda_device,
                                                    transpose_w):
    """Each output row depends only on its row and its expert's weights,
    bitwise: 37 rows put in front of expert 2's segment (and taken from
    the end of expert 0's, so Tk stays) move its rows to other offsets in
    their tiles, and their outputs keep their bits."""
    E, K, N = 4, 256, 520
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    rows = [torch.randn(n, K, generator=gen, device=cuda_device).to(
        torch.bfloat16) for n in (300, 200, 400, 124, 37)]
    shape = (E, N, K) if transpose_w else (E, K, N)
    w = (torch.randn(*shape, generator=gen, device=cuda_device) / 16).to(
        torch.bfloat16)

    def run(segments):
        counts = [len(t) for t in segments]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        out = gmm.grouped_matmul(
            torch.cat(segments), w,
            torch.tensor(starts, dtype=torch.int32, device=cuda_device),
            torch.tensor(counts, dtype=torch.int32, device=cuda_device),
            transpose_w=transpose_w)
        return out.split(counts)

    x0, x1, x2, x3, extra = rows
    a = run([x0, x1, x2, x3])
    b = run([x0[:263], x1, torch.cat([extra, x2]), x3])
    assert torch.equal(a[2], b[2][37:])
    assert torch.equal(a[0][:263], b[0]) and torch.equal(a[3], b[3])


#: Edge routings (counts per expert): every row in one expert, segments of
#: 1-7 rows, 37 rows in all, one expert, and an expert heavy enough that
#: dw splits it into row chunks.
EDGE_ROUTINGS = {"one_expert": [0, 0, 3000, 0],
                 "tiny_segments": [1, 2, 3, 4, 5, 6, 7, 100],
                 "tk_37": [20, 0, 17],
                 "one_of_one": [515],
                 "dw_split": [9000, 100, 0, 200]}


@pytest.mark.cuda
@pytest.mark.parametrize("routing", list(EDGE_ROUTINGS))
def test_gmm_kernels_on_edge_routings(cuda_device, routing):
    """gmm (w as stored and transposed) and dw against their plain versions
    in bf16 at K 136 and N 264 (a ragged last K slice and column tile),
    reproducible, and zeros for an empty expert's dw."""
    counts = EDGE_ROUTINGS[routing]
    E, Tk, K, N = len(counts), sum(counts), 136, 264
    starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                          dtype=torch.int32, device=cuda_device)
    counts_t = torch.tensor(counts, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(Tk, K, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    dout = torch.randn(Tk, N, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    for transpose_w in (False, True):
        shape = (E, N, K) if transpose_w else (E, K, N)
        w = (torch.randn(*shape, generator=gen, device=cuda_device) / 12).to(
            torch.bfloat16)
        args = (x, w, starts, counts_t)
        got = gmm.grouped_matmul(*args, transpose_w=transpose_w)
        assert torch.equal(got, gmm.grouped_matmul(*args,
                                                   transpose_w=transpose_w))
        assert _elementwise_close(got, gmm.grouped_matmul_plain(
            *args, transpose_w=transpose_w), GMM_TOL[torch.bfloat16])
    dw = gmm.grouped_matmul_dw(x, dout, starts, counts_t)
    assert torch.equal(dw, gmm.grouped_matmul_dw(x, dout, starts, counts_t))
    assert not any(dw[e].any() for e, c in enumerate(counts) if c == 0)
    assert _elementwise_close(
        dw, gmm.grouped_matmul_dw_plain(x, dout, starts, counts_t),
        GRAD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_grads_through_kernels_match_plain(cuda_device, dtype):
    """gmm on CUDA tensors keeps its graph: grouped_ffn takes the forward
    kernel twice and, in the backward, the dx (w read transposed) and dw
    kernels twice each; its output and grads equal autograd through the
    plain versions."""
    E, Tk, d, f = 8, 2100, 256, 512
    starts, counts = _moe_segments(Tk, E, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    leaves = [torch.randn(Tk, d, generator=gen, device=cuda_device),
              torch.randn(E, d, f, generator=gen, device=cuda_device) / 16,
              torch.randn(E, f, d, generator=gen, device=cuda_device) / 22]
    leaves = [t.to(dtype).requires_grad_() for t in leaves]
    g = torch.randn(Tk, d, generator=gen, device=cuda_device).to(dtype)
    n = (gmm.grouped_matmul.launches, gmm.grouped_matmul_dw.launches)
    out = gmm.grouped_ffn(*leaves, starts, counts)
    got = torch.autograd.grad(out, leaves, g)
    assert (gmm.grouped_matmul.launches - n[0],
            gmm.grouped_matmul_dw.launches - n[1]) == (4, 2)

    def plain_ffn(x, w_up, w_down):
        h = gmm.grouped_matmul_plain(x, w_up, starts, counts)
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return gmm.grouped_matmul_plain(h, w_down, starts, counts)

    ref_out = plain_ffn(*leaves)
    ref = torch.autograd.grad(ref_out, leaves, g)
    assert _elementwise_close(out, ref_out, PATH_GRAD_TOL[dtype])
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert _elementwise_close(a, b, PATH_GRAD_TOL[dtype])


def _near_tie_rows(idx, ref_idx, logits):
    """Rows where the kernel's choice differs from the plain version's,
    each checked to be a near tie: at the first position that differs, the
    plain version's probabilities of that rank and the next within 4 ulp."""
    rows = (idx != ref_idx).any(1).nonzero().flatten().tolist()
    for r in rows:
        j = int((idx[r] != ref_idx[r]).nonzero()[0])
        probs = router._softmax_lse(logits[r:r + 1])[0][0]
        top = torch.sort(probs, descending=True).values
        ulp = torch.nextafter(top[j], torch.tensor(float("inf"),
                                                   device=top.device)) - top[j]
        assert float(top[j] - top[j + 1]) <= 4 * float(ulp), (r, j, top)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k", [(8192, 8, 2), (1000, 6, 3), (129, 64, 2),
                                   (1, 8, 2), (129, 8, 1), (1, 64, 64)])
def test_fused_router_kernel_matches_plain(cuda_device, T, E, k):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    logits = torch.randn(T, E, generator=gen, device=cuda_device) * 3
    logits[::3, E - 1] = logits[::3, 0]  # exact ties: the lower index wins
    n = router.fused_router_fwd.launches
    got = router.fused_router_fwd(logits, k)
    assert router.fused_router_fwd.launches == n + 1
    ref = router.fused_router_plain(logits, k)
    assert got[1].dtype == torch.int32 and got[1].shape == (T, k)
    rows = _near_tie_rows(got[1], ref[1], logits)
    print(json.dumps({"rows_that_differ": rows}))
    keep = torch.ones(T, dtype=torch.bool, device=cuda_device)
    keep[rows] = False
    torch.testing.assert_close(got[0][keep], ref[0][keep], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-6, atol=1e-6)
    if E > 1 and k < E:
        assert (got[1][::3, 0] != E - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T,E", [(8192, 8), (129, 64)])
def test_fused_router_is_bitwise_reproducible(cuda_device, T, E):
    """One launch a call, its probs_mean merged in a fixed order in the
    block that arrives last: two calls give the same bits."""
    logits = torch.randn(T, E, device=cuda_device) * 3
    for a, b in zip(router.fused_router_fwd(logits, 2),
                    router.fused_router_fwd(logits, 2)):
        assert torch.equal(a, b)


def _kernels_a_call(fn) -> list:
    """The device kernels one call of ``fn`` launches, by name, under
    torch.profiler (after a warm-up call that builds and loads)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memset" not in e.name.lower()
            and "memcpy" not in e.name.lower()]


@pytest.mark.cuda
def test_fused_router_and_bn_matmul_launch_one_kernel(cuda_device):
    """The router and the BN-stats matmul are one kernel a call each: the
    merge runs in the same launch (the outputs and the workspace are
    ``torch.empty``, so nothing else runs on the card)."""
    logits = torch.randn(8192, 8, device=cuda_device)
    names = _kernels_a_call(lambda: router.fused_router_fwd(logits, 2))
    assert len(names) == 1 and "router_kernel" in names[0], names
    x, w, scale, bias = _bn_inputs(12345, 256, 64, True, torch.bfloat16,
                                   cuda_device)
    args = (x, w, scale.float(), bias.float())  # no cast to fp32 a call
    names = _kernels_a_call(lambda: fbm.fused_stats_matmul(*args))
    assert len(names) == 1 and "bn_matmul_wgmma" in names[0], names
    args = _bn_inputs(5003, 512, 1024, True, torch.float32, cuda_device)
    names = _kernels_a_call(lambda: fbm.fused_stats_matmul(*args))
    assert len(names) == 1 and "bn_matmul_simt" in names[0], names


#: The planted fault: the router's merge leaves block 1's partial out.
_DROPPED_BLOCK = (
    "        const bool in = b < nb;\n",
    "        const bool in = b < nb && b != 1;  // planted fault\n")


@pytest.mark.cuda
def test_fused_router_check_catches_a_dropped_block(cuda_device, tmp_path):
    """At the llama_moe shape (T 8192, 256 blocks), the probs_mean check
    passes the kernel as built and fails a build whose merge leaves one
    block's partial out (1/256 of each mean)."""
    with open(os.path.join(_build.CSRC_DIR, "fused_router.cu")) as f:
        source = f.read()
    old, new = _DROPPED_BLOCK
    assert source.count(old) == 1
    src = tmp_path / "fused_router_fault.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / "libfused_router_fault.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    logits = torch.randn(8192, 8, device=cuda_device) * 3
    ref = router.fused_router_plain(logits, 2)[3]

    def close(pm):
        return bool(torch.allclose(pm, ref, rtol=1e-6, atol=1e-6))

    assert close(router.fused_router_fwd(logits, 2)[3])
    with _build.using("fused_router", ctypes.CDLL(str(lib))):
        got = router.fused_router_fwd(logits, 2)[3]
    assert not close(got)


@pytest.mark.cuda
def test_moe_kernels_reject_bad_args(cuda_device):
    starts, counts = _moe_segments(64, 4, cuda_device)
    x = torch.randn(64, 20, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(4, 20, 8, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        gmm.grouped_matmul(x, w, starts, counts)
    with pytest.raises(TypeError, match="int32"):
        gmm.grouped_matmul(x[:, :16].contiguous(), w[:, :16].contiguous(),
                           starts.long(), counts)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm.grouped_matmul(x.half(), w.half(), starts, counts)
    with pytest.raises(ValueError, match="experts"):
        router.fused_router_fwd(torch.zeros(4, 65, device=cuda_device), 2)


# ---------------------------------------------------------------------------
# Fused BN-stats matmul (K3)
# ---------------------------------------------------------------------------

#: Mean and biased variance of each column of y, against its root mean
#: square and mean square.
BN_STATS_TOL = 1e-5


def _bn_inputs(N, K, C, affine, dtype, device, seed=5):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(N, K, generator=gen, device=device).to(dtype)
    w = (torch.randn(K, C, generator=gen, device=device) / K ** 0.5).to(dtype)
    if not affine:
        return x, w, None, None
    return (x, w, (1 + 0.1 * torch.randn(K, generator=gen, device=device)
                   ).to(dtype),
            (0.1 * torch.randn(K, generator=gen, device=device)).to(dtype))


def _bn_close(got, ref, dtype) -> bool:
    """y elementwise in GMM_TOL; the moments within BN_STATS_TOL."""
    (y, stats), (ry, rstats) = got, ref
    n = y.shape[0]
    msq = rstats[1] / n
    mean, rmean = stats[0] / n, rstats[0] / n
    var, rvar = stats[1] / n - mean * mean, msq - rmean * rmean
    mean_err = float(((mean - rmean).abs() / msq.sqrt()).max())
    var_err = float(((var - rvar).abs() / msq).max())
    print(json.dumps({"mean_err": mean_err, "var_err": var_err}))
    return (_elementwise_close(y, ry, GMM_TOL[dtype])
            and mean_err <= BN_STATS_TOL and var_err <= BN_STATS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K,C,affine,relu", [
    (401408, 256, 64, True, True),   # the bench's shapes: stage-2 reduce,
    (401408, 64, 256, True, True),   # stage-2 expand,
    (100352, 512, 128, True, True),  # stage-3 reduce
    (12345, 256, 64, False, False),  # ragged rows, no prologue
    (3001, 64, 200, True, False),    # ragged rows and columns, no ReLU
    (77, 8, 8, False, True),         # fewer rows than a tile
    (5003, 512, 1024, True, True)])  # four column chunks, w streamed
def test_fused_bn_matmul_kernel_matches_plain(cuda_device, dtype, N, K, C,
                                              affine, relu):
    args = _bn_inputs(N, K, C, affine, dtype, cuda_device)
    n = fbm.fused_stats_matmul.launches
    got = fbm.fused_stats_matmul(*args, relu=relu)
    assert fbm.fused_stats_matmul.launches == n + 1
    ref = fbm.fused_stats_matmul_plain(*args, relu=relu)
    assert got[0].dtype == dtype and got[0].shape == (N, C)
    assert got[1].dtype == torch.float32 and got[1].shape == (2, C)
    assert _bn_close(got, ref, dtype)
    again = fbm.fused_stats_matmul(*args, relu=relu)
    assert torch.equal(again[1], got[1]) and torch.equal(again[0], got[0])


#: The planted fault: the merge leaves slot 1's partials out.
_DROPPED_PARTIAL = (
    "          const bool in = pp < n_slots && j < n_vals;\n",
    "          const bool in = pp < n_slots && j < n_vals && pp != 1;\n")


@pytest.mark.cuda
def test_fused_bn_matmul_check_catches_a_dropped_partial(cuda_device,
                                                         tmp_path):
    """The check fails a kernel whose merge leaves one block's partial
    out of the statistics, at the bench's first shape (one of 132), where
    it passes the kernel as built."""
    with open(os.path.join(_build.CSRC_DIR, "fused_bn_matmul.cu")) as f:
        source = f.read()
    old, new = _DROPPED_PARTIAL
    assert source.count(old) == 1
    src = tmp_path / "fused_bn_matmul_fault.cu"
    src.write_text(source.replace(old, new))
    lib = tmp_path / "libfused_bn_matmul_fault.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    args = _bn_inputs(401408, 256, 64, True, torch.bfloat16, cuda_device)
    ref = fbm.fused_stats_matmul_plain(*args)
    assert _bn_close(fbm.fused_stats_matmul(*args), ref, torch.bfloat16)
    with _build.using("fused_bn_matmul", ctypes.CDLL(str(lib))):
        got = fbm.fused_stats_matmul(*args)
    assert not _bn_close(got, ref, torch.bfloat16)


@pytest.mark.cuda
def test_fused_bn_matmul_rejects_bad_args(cuda_device):
    x, w, scale, bias = _bn_inputs(64, 24, 16, True, torch.bfloat16,
                                   cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fbm.fused_stats_matmul(x[:, :20].contiguous(), w[:20].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fbm.fused_stats_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="cpu"):
        fbm.fused_stats_matmul(x, w, scale.cpu(), bias.cpu())
    with pytest.raises(TypeError, match="one dtype"):
        fbm.fused_stats_matmul(x, w.float())
    # Scale and bias at any fp32 offset: the kernel stages them one value
    # a thread, so storage that is not 8-byte aligned is taken.
    params = torch.randn(2 * 24 + 1, device=cuda_device)
    assert _bn_close(fbm.fused_stats_matmul(x, w, params[1:25], params[25:]),
                     fbm.fused_stats_matmul_plain(x, w, params[1:25],
                                                  params[25:]),
                     torch.bfloat16)
