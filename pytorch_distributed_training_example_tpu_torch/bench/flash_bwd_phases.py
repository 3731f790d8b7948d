"""Where the time of the bf16 flash backward goes, phase by phase.

GPU only. Builds a copy of ``csrc/flash_bwd.cu`` with ``clock64()`` probes
around the phases of the wgmma passes' loops: each consumer warpgroup's
leader thread, and the producer's first lane, add their clocks into a
``__device__`` array that an added C function copies out. The script runs
the backward once at the gpt2 and ViT training shapes (bf16, head_dim 64)
and prints the card, then one JSON line: the mean SM clocks a consumer
warpgroup spends on one streamed tile in each phase, and the producer's
clocks per tile. The probes' atomics slow the kernel (read the phases'
shares, not the totals); the copy lands in ``_build/phases/``.

Run: ``python -m pytorch_distributed_training_example_tpu_torch.bench.flash_bwd_phases``
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

from pytorch_distributed_training_example_tpu_torch.ops import _build
from pytorch_distributed_training_example_tpu_torch.ops import (
    flash_attention as flash)

SHAPES = {"gpt2": (16, 1024, 12, 12, 64, True, None),
          "vit_b16": (128, 256, 12, 12, 64, False, 197)}

_ADD = "if (threadIdx.x % 128 == 0) atomicAdd(&g_probe[{}], " \
       "(unsigned long long)({}));"
_LANE0 = "if (lane == 0) atomicAdd(&g_probe[{}], (unsigned long long)({}));"

# (anchor, text inserted before it, text inserted after it); each anchor
# must occur in the source exactly once.
_PROBES = [
    # dk/dv consumer: wait for the stage, s and dp, exponentials and
    # packing, dk and dv, the whole step.
    ("    mbar_wait(&full[s], (j / kStages) & 1);\n",
     "    long long t_a = clock64();\n",
     "    long long t_b = clock64(); " + _ADD.format(0, "t_b - t_a") + "\n"),
    ("      reg_fence(sc);\n      reg_fence(dp);\n      // p^T in sc",
     "      long long t_c = clock64(); " + _ADD.format(1, "t_c - t_b") + "\n",
     ""),
    ("      const uint64_t omd =",
     "      long long t_d = clock64(); " + _ADD.format(2, "t_d - t_c") + "\n",
     ""),
    ("      wgmma_wait<0>();\n      reg_fence(dv);\n      reg_fence(dk);\n"
     "    }\n", "",
     "    " + _ADD.format(3, "clock64() - t_a") + "\n"),
    ("      wgmma_wait<0>();\n      reg_fence(dv);\n", "",
     "      " + _ADD.format(4, "clock64() - t_d") + " "
     + _ADD.format(5, "1") + "\n"),
    # dk/dv producer: waiting for a free stage, the rest of its step.
    ("      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);\n",
     "      long long p_a = clock64();\n",
     "      long long p_b = clock64(); " + _LANE0.format(6, "p_b - p_a")
     + "\n"),
    ("      if (j + 1 < w.n_iter) fetch(j + 1);\n", "",
     "      " + _LANE0.format(7, "clock64() - p_b") + " "
     + _LANE0.format(8, "1") + "\n"),
    # dq consumer: wait for the stage, s and dp (and the previous tile's
    # dq product), exponentials and packing.
    ("    mbar_wait(&full[s], (t / kStages) & 1);\n",
     "    long long t_a = clock64();\n",
     "    long long t_b = clock64(); " + _ADD.format(16, "t_b - t_a") + "\n"),
    ("    if (prev >= 0) {\n      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(&empty[prev]);\n    }\n    prev = s;",
     "    long long t_c = clock64(); " + _ADD.format(17, "t_c - t_b") + "\n",
     ""),
    ("    const uint64_t kmd =",
     "    " + _ADD.format(18, "clock64() - t_c") + " "
     + _ADD.format(19, "1") + "\n", ""),
]

_READ = '''
extern "C" int pdtx_probe(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[32] = {0};
    return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
}
'''


def probed_source(src: str) -> str:
    """``src`` with the probes, the counters and their reader added."""
    for anchor, before, after in _PROBES:
        if src.count(anchor) != 1:
            raise AssertionError(f"probe anchor not in flash_bwd.cu exactly "
                                 f"once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    head = "namespace {\n\nusing namespace pdtx;"
    if src.count(head) != 1:
        raise AssertionError("flash_bwd.cu's namespace opening moved")
    src = src.replace(head, "__device__ unsigned long long g_probe[32];\n"
                      + head)
    return src + _READ


def build() -> ctypes.CDLL:
    out_dir = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "flash_bwd.cu")) as f:
        src = probed_source(f.read())
    path = os.path.join(out_dir, "flash_bwd_phases.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libflash_bwd_phases.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probed copy:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def phases(lib, shape) -> dict:
    B, S, H, Hkv, D, causal, kv_len = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv, H))
    o, lse = flash.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             kv_len=kv_len)
    o = o.contiguous()
    kw = dict(causal=causal, kv_len=kv_len)
    flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # warm
    counts = (ctypes.c_ulonglong * 32)()
    _build.check(lib.pdtx_probe(counts, 1), "probe reset")
    flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    _build.check(lib.pdtx_probe(counts, 0), "probe read")
    c = list(counts)
    per = max(c[5], 1)
    dkv = {"wait_stage": c[0] / per, "s_dp": c[1] / per,
           "exp_pack": c[2] / per, "dk_dv": c[4] / per,
           "step": c[3] / per}
    per_q = max(c[19], 1)
    dq = {"wait_stage": c[16] / per_q, "s_dp_prev_dq": c[17] / per_q,
          "exp_pack": c[18] / per_q}
    per_p = max(c[8], 1)
    return {"shape": dict(B=B, S=S, H=H, Hkv=Hkv, D=D, causal=causal,
                          kv_len=kv_len),
            "dkv_clocks_per_tile": dkv, "dkv_tiles": c[5],
            "dq_clocks_per_tile": dq, "dq_tiles": c[19],
            "dkv_producer_clocks_per_tile": {"wait_free_stage": c[6] / per_p,
                                             "rest": c[7] / per_p}}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    with _build.using("flash_bwd", lib):
        rows = {name: phases(lib, shape) for name, shape in SHAPES.items()}
    assert all(math.isfinite(x) for r in rows.values()
               for x in r["dkv_clocks_per_tile"].values())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
