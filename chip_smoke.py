#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``<package>/csrc`` with nvcc, holds each
kernel against its plain PyTorch version at the shapes the serving path
gives it (bf16 and fp32), times kernel, plain version, library call and
bound, then serves ``llama3_8b`` at full width and depth in bf16 through
the port's entry point, runs the long-prompt path (flash prefill + paged
decode) and profiles where its device time goes, and checks greedy token
identity between the kernel and plain paths at fp32. Each phase prints one JSON line; the ``kernels`` line and
then ``{"ok": true, "device": ...}`` close the run. Any failed phase raises,
so the exit code is non-zero and no ``ok`` line is printed.

Run from the repository root: ``python3 chip_smoke.py`` (one GPU, nvcc under
``/usr/local/cuda`` or ``$CUDA_HOME``). Without CUDA, or without the port's
package beside this script, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
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
LSE_TOL = 1e-3
LAYERS = 32        # llama3_8b: each kernel launches once per layer per forward
DECODE_BUCKETS = (1, 2, 4, 8)   # the engine's default, warmed once each


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed alone
    with CUDA events. Before each, a 1 GB write evicts the 50 MB L2 (the
    serving loop finds a layer's cache cold) and keeps the card busy for
    ~0.3 ms, longer than the host needs to enqueue ``fn``, so the events
    time the device work and not the Python in front of it."""
    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
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


def paged_decode_case(flash, B, positions, dtype, gen):
    """Random pool and scattered page tables at llama3_8b's decode shapes."""
    H, Hkv, D, ps, P = 32, 8, 128, 16, 640
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k_pages = torch.randn(P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn(P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    width = max(positions) // ps + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B, width, dtype=torch.int32, device="cuda")
    used = 0
    for b, pos in enumerate(positions):
        n = pos // ps + 1
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    pos_t = torch.tensor(positions, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, table, pos_t)
    out = flash.paged_decode_attention(*args)
    ref = flash.paged_decode_attention(*args, impl="xla")
    torch.cuda.synchronize()
    name = f"paged_decode B={B} {str(dtype)[6:]}"
    err = max_err(out, ref)
    check(name, err, TOL[str(dtype)[6:]])
    live = sum(p + 1 for p in positions)
    item = q.element_size()
    nbytes = (2 * live * Hkv * D + 2 * B * H * D) * item \
        + 4 * (B + table.numel())
    ops = 4 * live * H * D
    row = dict(name=name, positions=positions, max_abs_err=err,
               tol=TOL[str(dtype)[6:]],
               ms=time_ms(lambda: flash.paged_decode_attention(*args)),
               plain_ms=time_ms(
                   lambda: flash.paged_decode_attention(*args, impl="xla")),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, str(dtype)[6:])
    return row


def flash_case(flash, S, dtype, gen):
    """Causal prefill attention at llama3_8b's shapes, [B, S, H, D]."""
    B, H, Hkv, D = 1, 32, 8, 128
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    out, lse = flash.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    name = f"flash_fwd S={S} {str(dtype)[6:]}"
    err = max_err(out, ref)
    check(name, err, TOL[str(dtype)[6:]])
    lse_err = max_err(lse, ref_lse)
    check(name + " lse", lse_err, LSE_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    item = q.element_size()
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * item + 4 * B * H * S
    ops = 2 * B * H * S * S * D
    row = dict(name=name, max_abs_err=err, lse_max_abs_err=lse_err,
               tol=TOL[str(dtype)[6:]],
               ms=time_ms(lambda: flash.flash_attention_fwd(
                   q, k, v, causal=True)),
               plain_ms=time_ms(lambda: flash.flash_attention_fwd_plain(
                   q, k, v, causal=True), iters=5),
               library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)))
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, str(dtype)[6:])
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
    from pytorch_distributed_training_example_tpu_torch import main as port
    from pytorch_distributed_training_example_tpu_torch.models import (
        registry)
    from pytorch_distributed_training_example_tpu_torch.ops import (
        _build, flash_attention as flash)
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
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. Build every kernel from the checkout, one nvcc per source at once.
    built = _build.build_all()
    emit("build", seconds=built["seconds"],
         ptxas={name: [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
                for name, log in built["logs"].items()})

    # 3. Each kernel against its plain version at the serving shapes.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, positions in ((1, [1000]),
                             (8, [0, 15, 16, 47, 300, 511, 767, 1023])):
            row = paged_decode_case(flash, B, positions, dtype, gen)
            rows[row["name"]] = row
            emit("kernel_check", kernel="paged_decode", **row)
        for S in (1024, 2048):
            row = flash_case(flash, S, dtype, gen)
            rows[row["name"]] = row
            emit("kernel_check", kernel="flash_fwd", **row)
    torch.cuda.empty_cache()

    # 4-5. The main path: counts from 0, then serving through the port's
    # entry point, then the long-prompt path through the engine.
    flash.paged_decode_attention.launches = 0
    flash.flash_attention_fwd.launches = 0
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # Where the device time of that drain goes: the same requests again,
    # under torch.profiler (its host overhead stretches the wall time, so
    # the busy share is taken against the unprofiled drain above).
    prof = serve_engine(model, engine_lib, long_prompt_requests(
        engine_lib, 1, lens, 16, model.vocab_size), profile=True)[3]
    emit("profile_long_prompts", unprofiled_wall_ms=1e3 * wall,
         busy_share=prof["device_ms"] / (1e3 * wall), profiled=prof)
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

    # 7. The kernels line: launches from the main path (phases 4-5),
    # numbers at the main path's bf16 shapes.
    head = {"paged_decode": rows["paged_decode B=8 bfloat16"],
            "flash_fwd": rows["flash_fwd S=1024 bfloat16"]}
    meta = {
        "paged_decode": dict(
            route="cuda", source=f"{PKG}/csrc/paged_decode.cu",
            replaces="pytorch_distributed_training_example_tpu/ops/"
                     "flash_attention.py:1037"),
        "flash_fwd": dict(
            route="cuda", source=f"{PKG}/csrc/flash_fwd.cu",
            replaces="pytorch_distributed_training_example_tpu/ops/"
                     "flash_attention.py:93"),
    }
    kernels = []
    for name in ("paged_decode", "flash_fwd"):
        r = head[name]
        kernels.append(dict(
            name=name, **meta[name], launches=launches[name],
            max_abs_err=max(x["max_abs_err"] for x in rows.values()
                            if x["name"].startswith(name)
                            and x["name"].endswith("bfloat16")),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["name"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
