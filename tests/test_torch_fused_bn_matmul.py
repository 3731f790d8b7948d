"""The port's fused BN-stats matmul against the JAX package's.

The port's plain version (``fused_stats_matmul_plain``, what its wrapper
runs for CPU tensors and what the CUDA kernel is held to on the card) is
held against the JAX ``bn_stats_matmul`` with its Pallas kernel in
interpret mode, under ``jax.jit``, at the shapes of
``tests/test_fused_bn_matmul.py`` and a row count that is no multiple of a
tile. Inputs are numpy from a seed.

Tolerances: fp32 y within rtol 1e-5 and atol 1e-5, mean within 1e-5 and
the biased variance within rtol 1e-4 and atol 1e-5 (the JAX tests' bounds:
fp32 sums in another order). bf16: both packages take the statistics from
the fp32 product, so mean and variance keep the fp32 bounds; y is rounded
to bf16 from sums in another order, so it may differ by one bf16 ulp (rtol
2^-7). With an affine prologue in bf16 the JAX kernel rounds ``x * scale``
and then ``+ bias`` to bf16 where the port rounds their fp32 result once,
so an input of the product may differ by one ulp: there each element of y
is held to 2^-6 (|ref| + rms(ref)) (a few of the K = 128 terms off by 2^-8
of themselves, then y's own rounding on each side), and the moments to
1e-2 of rms(y) and rms(y)^2.

The kernel's persistent schedule (``_bn_schedule``: grid, tiles a block,
workspace and counter, from N, C and the SM count) is checked for the
bench's shapes and for covering every tile of every column chunk once, and
the kernel's reduction order is emulated in fp32: per-block partials of
the plain product, merged as the last block merges them (8 warps over the
slots in order, then the warps in order), held to the JAX
``bn_stats_matmul`` in the fp32 bounds above, for a ragged last tile, one
tile, more SMs than tiles, more than 256 columns and the fp32 schedule.

The bench module's pieces run here too (the three arms agree on the CPU;
the logical bytes are the JAX bench's count), and its entry point refuses
to run without a GPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_training_example_tpu.ops import (
    fused_bn_matmul as jax_fbm)
from pytorch_distributed_training_example_tpu_torch.bench import (
    fused_bn_bench as bench)
from pytorch_distributed_training_example_tpu_torch.ops import (
    _build, fused_bn_matmul as fbm)


def _inputs(N, K, C, affine, seed):
    r = np.random.RandomState(seed)
    x = r.randn(N, K).astype(np.float32)
    w = (r.randn(K, C) / np.sqrt(K)).astype(np.float32)
    scale = (1.0 + 0.1 * r.randn(1, K)).astype(np.float32) if affine else None
    bias = (0.1 * r.randn(1, K)).astype(np.float32) if affine else None
    return x, w, scale, bias


def _jax(x, w, scale, bias, relu, block_n, dtype):
    fn = jax.jit(functools.partial(jax_fbm.bn_stats_matmul, relu=relu,
                                   block_n=block_n, interpret=True))
    as_j = lambda a: None if a is None else jnp.asarray(a, dtype)
    y, mean, var = fn(as_j(x), as_j(w), as_j(scale), as_j(bias))
    return (np.asarray(y.astype(jnp.float32)), np.asarray(mean),
            np.asarray(var))


def _port(x, w, scale, bias, relu, dtype):
    as_t = lambda a: None if a is None else torch.from_numpy(a).to(dtype)
    y, stats = fbm.fused_stats_matmul_plain(as_t(x), as_t(w), as_t(scale),
                                            as_t(bias), relu=relu)
    n = x.shape[0]
    mean = stats[0] / n
    var = stats[1] / n - mean * mean
    assert y.dtype == dtype and stats.shape == (2, w.shape[1])
    return y.float().numpy(), mean.numpy(), var.numpy()


@pytest.mark.parametrize("N,K,C,affine,relu,block_n", [
    (256, 128, 64, False, False, 64),
    (256, 128, 64, True, True, 64),
    (128, 256, 64, False, False, 64),    # Cout 64: JAX pads to 128 lanes
    (200, 64, 40, True, True, 1024),     # ragged N (one JAX block of 200)
])
def test_plain_matches_jax_interpret_fp32(N, K, C, affine, relu, block_n):
    x, w, scale, bias = _inputs(N, K, C, affine, seed=N + K)
    ry, rmean, rvar = _jax(x, w, scale, bias, relu, block_n, jnp.float32)
    y, mean, var = _port(x, w, scale, bias, relu, torch.float32)
    assert y.shape == ry.shape == (N, C) and mean.shape == (C,)
    np.testing.assert_allclose(y, ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean, rmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, rvar, rtol=1e-4, atol=1e-5)


def test_plain_matches_jax_interpret_bf16_stats_from_fp32_accumulator():
    x, w, _, _ = _inputs(256, 128, 128, False, seed=2)
    ry, rmean, rvar = _jax(x, w, None, None, True, 128, jnp.bfloat16)
    y, mean, var = _port(x, w, None, None, True, torch.bfloat16)
    np.testing.assert_allclose(y, ry, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(mean, rmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, rvar, rtol=1e-4, atol=1e-5)
    # The stats are the fp32 product's, not the rounded y's.
    yb = torch.from_numpy(y)
    assert not np.allclose(var, (yb.var(0, unbiased=False)).numpy(),
                           rtol=1e-6, atol=0)


def test_plain_matches_jax_interpret_bf16_affine_within_one_ulp_inputs():
    x, w, scale, bias = _inputs(256, 128, 64, True, seed=3)
    ry, rmean, rvar = _jax(x, w, scale, bias, True, 128, jnp.bfloat16)
    y, mean, var = _port(x, w, scale, bias, True, torch.bfloat16)
    rms = np.sqrt(np.mean(ry ** 2))
    assert (np.abs(y - ry) <= 2.0 ** -6 * (np.abs(ry) + rms)).all()
    assert np.abs(mean - rmean).max() <= 1e-2 * rms
    assert np.abs(var - rvar).max() <= 1e-2 * rms ** 2


def test_wrapper_takes_plain_version_on_cpu_and_launches_nothing():
    loaded = dict(_build._loaded)
    n = fbm.fused_stats_matmul.launches
    x, w, scale, bias = (torch.from_numpy(a) for a in
                         _inputs(70, 16, 24, True, seed=4))
    got = fbm.fused_stats_matmul(x, w, scale, bias, relu=False)
    ref = fbm.fused_stats_matmul_plain(x, w, scale, bias, relu=False)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r)
    # A missing scale or bias is ones or zeros, as in the JAX wrapper.
    torch.testing.assert_close(
        fbm.fused_stats_matmul(x, w, None, bias)[1],
        fbm.fused_stats_matmul(x, w, torch.ones(16), bias)[1])
    y, mean, var = fbm.bn_stats_matmul(x, w, scale, bias)
    assert y.shape == (70, 24) and mean.shape == var.shape == (24,)
    assert fbm.fused_stats_matmul.launches == n
    assert _build._loaded == loaded
    with pytest.raises(ValueError, match="not \\[N, K\\]"):
        fbm.fused_stats_matmul(x, w.T)
    with pytest.raises(TypeError, match="one dtype"):
        fbm.fused_stats_matmul(x, w.double())
    with pytest.raises(ValueError, match="scale has 3"):
        fbm.fused_stats_matmul(x, w, torch.ones(3))


def _tiles_of(plan, b):
    """The chunk and the row tiles block b of the schedule walks."""
    return (b % plan.n_chunks,
            list(range(b // plan.n_chunks, plan.n_tiles, plan.slots)))


def test_schedule_at_the_bench_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    S = fbm._bn_schedule
    assert S(401408, 64, bf16, 132) == (64, 128, 1, 3136, 132, 132, 24,
                                        132 * 2 * 64, 1)
    assert S(401408, 256, bf16, 132) == (256, 64, 1, 6272, 132, 132, 48,
                                         132 * 2 * 256, 1)
    assert S(100352, 128, bf16, 132) == (128, 128, 1, 784, 132, 132, 6,
                                         132 * 2 * 128, 1)
    # More than 256 columns: four chunks of 33 blocks each.
    assert S(5003, 1024, bf16, 132) == (256, 64, 4, 79, 33, 132, 3,
                                        33 * 2 * 1024, 1)
    # fp32: five blocks an SM, chunks of 64 columns, 64-row tiles.
    assert S(401408, 64, f32, 132)[:6] == (64, 64, 1, 6272, 660, 660)
    # Fewer tiles than SMs: one block a tile.
    assert S(77, 8, bf16, 132).grid == 1


@pytest.mark.parametrize("N,C,dtype,sm", [
    (3001, 200, torch.bfloat16, 132), (5003, 1024, torch.bfloat16, 7),
    (12345, 64, torch.float32, 5), (1, 8, torch.bfloat16, 132)])
def test_schedule_covers_every_tile_of_every_chunk_once(N, C, dtype, sm):
    plan = fbm._bn_schedule(N, C, dtype, sm)
    assert plan.grid == plan.slots * plan.n_chunks <= max(
        fbm._BLOCKS_PER_SM[dtype] * sm, plan.n_chunks)
    assert plan.n_chunks * plan.chunk >= C > (plan.n_chunks - 1) * plan.chunk
    assert plan.n_tiles * plan.tile_rows >= N
    seen = {}
    for b in range(plan.grid):
        chunk, tiles = _tiles_of(plan, b)
        assert 1 <= len(tiles) <= plan.tiles_per_block
        for t in tiles:
            seen[chunk, t] = seen.get((chunk, t), 0) + 1
    assert seen == {(c, t): 1 for c in range(plan.n_chunks)
                    for t in range(plan.n_tiles)}
    assert plan.workspace == plan.slots * 2 * C and plan.counters == 1


def _emulated_stats(acc, plan):
    """The kernel's statistics from the fp32 product ``acc`` [N, C]: each
    block's [2, chunk] partial over its tiles' rows into its slot of the
    [slots, 2, C] workspace, then the merge's order: warp w of 8 sums
    slots w, w + 8, ... in order, then the 8 warps' sums in order."""
    N, C = acc.shape
    partial = torch.zeros(plan.slots, 2, C)
    for b in range(plan.grid):
        chunk, tiles = _tiles_of(plan, b)
        cols = slice(chunk * plan.chunk, min(C, (chunk + 1) * plan.chunk))
        rows = torch.cat([torch.arange(t * plan.tile_rows,
                                       min(N, (t + 1) * plan.tile_rows))
                          for t in tiles])
        a = acc[rows, cols]
        partial[b // plan.n_chunks, 0, cols] = a.sum(0)
        partial[b // plan.n_chunks, 1, cols] = (a * a).sum(0)
    flat = partial.reshape(plan.slots, 2 * C)
    total = torch.zeros(2 * C)
    for w in range(8):
        warp = torch.zeros(2 * C)
        for p in range(w, plan.slots, 8):
            warp = warp + flat[p]
        total = total + warp
    return total.reshape(2, C)


@pytest.mark.parametrize("N,K,C,dtype,sm", [
    (300, 64, 40, torch.bfloat16, 2),    # ragged last tile (44 of 128 rows)
    (100, 32, 24, torch.bfloat16, 4),    # one tile
    (200, 16, 64, torch.bfloat16, 132),  # more SMs than tiles
    (260, 48, 520, torch.bfloat16, 7),   # three chunks of 256 columns
    (300, 64, 136, torch.float32, 3),    # the fp32 schedule
])
def test_emulated_reduction_order_matches_jax_interpret(N, K, C, dtype, sm):
    x, w, scale, bias = _inputs(N, K, C, True, seed=N + C)
    ry, rmean, rvar = _jax(x, w, scale, bias, True, N, jnp.float32)
    plan = fbm._bn_schedule(N, C, dtype, sm)
    acc = torch.relu(torch.from_numpy(x) * torch.from_numpy(scale)
                     + torch.from_numpy(bias)) @ torch.from_numpy(w)
    stats = _emulated_stats(acc, plan)
    mean = (stats[0] / N).numpy()
    var = (stats[1] / N).numpy() - mean * mean
    np.testing.assert_allclose(acc.numpy(), ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean, rmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, rvar, rtol=1e-4, atol=1e-5)


def test_bench_arms_agree_and_count_the_jax_bench_bytes():
    assert bench.SHAPES == [(401408, 256, 64), (401408, 64, 256),
                            (100352, 512, 128)]
    N, K, C = 300, 64, 32
    args = bench.make_inputs(N, K, C, device="cpu")
    assert all(a.dtype == torch.bfloat16 for a in args)
    gap = bench.moments_gap(bench.fused(*args), bench.unfused(*args), N)
    # The unfused arm rounds y and its prologue to bf16 (the JAX arm's
    # arithmetic): the moments agree to a few bf16 ulps of their scale.
    assert gap["mean_gap"] < 1e-2 and gap["var_gap"] < 1e-2
    # The ResNet arm (BatchNorm apply, ReLU, conv2d in channels_last, the
    # next BatchNorm's batch moments) on 3 images of 10 x 10: y as the
    # fused arm's to a bf16 rounding, its moments from the rounded y.
    seg = bench.resnet_inputs(*args, batch=3)
    assert seg[0].is_contiguous(memory_format=torch.channels_last)
    ry, rs, rq = bench.resnet_segment(*seg)
    assert ry.shape == (3, C, 10, 10) and ry.dtype == torch.bfloat16
    torch.testing.assert_close(
        ry.permute(0, 2, 3, 1).reshape(N, C).float(),
        bench.fused(*args)[0].float(), rtol=2.0 ** -7, atol=1e-3)
    gap = bench.moments_gap((ry, rs, rq), bench.fused(*args), N)
    assert gap["mean_gap"] < 1e-2 and gap["var_gap"] < 1e-2
    with pytest.raises(ValueError, match="square"):
        bench.resnet_inputs(*args, batch=7)
    # The JAX bench's count: 3 passes over x and 2 over y unfused, 1 each
    # fused: 256.9 MB fused at the first shape.
    un, fu = bench.logical_bytes(*bench.SHAPES[0], 2)
    assert (un, fu) == (2 * 401408 * 256 * 2 + 401408 * 256 * 2
                        + 2 * 401408 * 64 * 2, 256901120)


def test_bench_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        bench.main([])
