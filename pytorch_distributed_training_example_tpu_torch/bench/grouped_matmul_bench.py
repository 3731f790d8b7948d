"""Microbenchmark: the grouped expert matmul kernels (K4a, K4b) against
``torch._grouped_mm``, on the GPU.

At the llama_moe shapes (kT = 16384 routed rows, d 1024, f 2048, 8
experts) it times, under three routings of the rows over the experts:

    gmm    (K4a, ops/grouped_matmul.py ``grouped_matmul``): the up and down
           products and the backward's dx against each w read transposed;
    gmm_dw (K4b, ``grouped_matmul_dw``): the up and down weight gradients,
           fp32 out (the library call gives bf16 out);

and beside each, one ``torch._grouped_mm`` call on the same inputs (a
yardstick; the port never calls it) and the least time the card could
take (the flops over 989 TF/s bf16, or the bytes each input read once and
each output written once over 3.35 TB/s, whichever is larger). The
routings:

    skewed     chip_smoke.py's check: expert 0 empty, expert 1 over half
               the rows (8232), the rest split 1:2:...:6 at random;
    balanced   kT / E rows an expert, the training step's routing;
    one_expert every row in expert 1 (dw splits it into row chunks).

Each call is timed alone with CUDA events behind a 1 GB write that evicts
the 50 MB L2, as ``chip_smoke.py`` times its rows. For one dw call at each
routing, ``torch.profiler`` splits the device time between the planning
kernel and the main one. It prints the card's name and power limit, then
one JSON line. It writes no file.

    python -m pytorch_distributed_training_example_tpu_torch.bench.grouped_matmul_bench

It needs a CUDA GPU and exits with an error without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.autograd import DeviceType

from pytorch_distributed_training_example_tpu_torch.bench.fused_bn_bench import (
    card, time_ms)
from pytorch_distributed_training_example_tpu_torch.ops import (
    grouped_matmul as gmm)

ITERS = 20  # timed calls per arm and case
E, TK, D, F = 8, 16384, 1024, 2048  # llama_moe: 4 x 2048 tokens, top-2
HBM_BYTES_PER_S, PEAK_BF16 = 3.35e12, 989e12
# (name, K, N, w read transposed) of K4a; (name, M, N) of K4b.
GMM_CASES = (("up", D, F, False), ("down", F, D, False),
             ("dx_up", F, D, True), ("dx_down", D, F, True))
DW_CASES = (("up", D, F), ("down", F, D))


def routing_counts(name: str) -> np.ndarray:
    """Rows an expert (int32 [E], summing to TK) for a routing's name."""
    if name == "skewed":
        heavy = TK // 2 + 40
        weights = np.arange(1, E - 1)
        rest = np.random.default_rng(7).multinomial(TK - heavy,
                                                    weights / weights.sum())
        counts = np.concatenate([[0, heavy], rest])
    elif name == "balanced":
        counts = np.full(E, TK // E)
    elif name == "one_expert":
        counts = np.zeros(E)
        counts[1] = TK
    else:
        raise ValueError(f"unknown routing {name!r}")
    return counts.astype(np.int32)


ROUTINGS = ("skewed", "balanced", "one_expert")


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16)


def library_ms(fn):
    """``torch._grouped_mm``'s time, or None where this torch lacks it or
    refuses the call."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    try:
        fn()
    except (RuntimeError, TypeError, ValueError):
        return None
    return time_ms(fn, ITERS)


def dw_split_ms(x, dout, starts, counts) -> dict:
    """One dw call's device time by kernel (the plan and the main one)."""
    gmm.grouped_matmul_dw(x, dout, starts, counts)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gmm.grouped_matmul_dw(x, dout, starts, counts)
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "gmm_dw_" in e.name:
            key = e.name.split("gmm_dw_")[-1].split("_kernel")[0]
            split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return split


def bench_routing(name: str, gen) -> list[dict]:
    counts_np = routing_counts(name)
    starts_np = np.concatenate([[0], np.cumsum(counts_np)[:-1]])
    starts = torch.from_numpy(starts_np.astype(np.int32)).cuda()
    counts = torch.from_numpy(counts_np).cuda()
    offs = counts.cumsum(0).to(torch.int32)
    live = int((counts_np > 0).sum())
    rows = []
    for case, K, N, transpose_w in GMM_CASES:
        x = torch.randn(TK, K, generator=gen, device="cuda").bfloat16()
        shape = (E, N, K) if transpose_w else (E, K, N)
        w = (torch.randn(*shape, generator=gen, device="cuda")
             / K ** 0.5).bfloat16()
        wl = w.transpose(1, 2) if transpose_w else w
        ms = time_ms(lambda: gmm.grouped_matmul(
            x, w, starts, counts, transpose_w=transpose_w), ITERS)
        lib = library_ms(lambda: torch._grouped_mm(x, wl, offs=offs))
        rows.append(dict(routing=name, kernel="gmm", case=case, K=K, N=N,
                         ms=ms, library_ms=lib,
                         bound_ms=bound_ms(2 * (TK * K + live * K * N
                                                + TK * N), 2.0 * TK * K * N)))
    for case, M, N in DW_CASES:
        x = torch.randn(TK, M, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(TK, N, generator=gen, device="cuda").bfloat16()
        ms = time_ms(lambda: gmm.grouped_matmul_dw(x, dout, starts, counts),
                     ITERS)
        lib = library_ms(lambda: torch._grouped_mm(x.t(), dout, offs=offs))
        rows.append(dict(routing=name, kernel="gmm_dw", case=case, M=M, N=N,
                         ms=ms, library_ms=lib,
                         bound_ms=bound_ms(2 * TK * (M + N) + 4 * E * M * N,
                                           2.0 * TK * M * N),
                         kernels_ms=dw_split_ms(x, dout, starts, counts)))
    for row in rows:
        row["x_library"] = (row["ms"] / row["library_ms"]
                            if row["library_ms"] else None)
        row["x_bound"] = row["ms"] / row["bound_ms"]
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("grouped_matmul_bench: torch.cuda.is_available() "
                         "is False; the bench times the kernels on a CUDA "
                         "GPU")
    smi = card()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [row for name in ROUTINGS for row in bench_routing(name, gen)]
    print(json.dumps({"bench": "grouped_matmul_vs_grouped_mm",
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "iters": ITERS,
                      "counts": {n: routing_counts(n).tolist()
                                 for n in ROUTINGS},
                      "timing": "CUDA events around each call, behind a 1 GB "
                                "L2 flush; mean over the calls",
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
