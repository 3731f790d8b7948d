"""Where the time of the bf16 flash forward goes, phase by phase.

GPU only. Builds a copy of ``csrc/flash_fwd.cu`` with ``clock64()`` probes
around the phases of the wgmma kernel's consumer loop (a key tile after the
first of a work item): each consumer warpgroup's leader thread, and the
producer's thread, add their clocks into a ``__device__`` array that an
added C function copies out. The script runs the forward once at the
gpt2, llama_moe and ViT training shapes (head_dim 64) and at llama3_8b's
prefill (head_dim 128, S 2048), and prints the card, then one JSON line:
the mean SM clocks a consumer warpgroup spends on one key tile in each
phase, and the producer's clocks per tile. The probes' atomics slow the
kernel (read the phases' shares, not the totals); the copy lands in
``_build/phases/``.

Run: ``python -m pytorch_distributed_training_example_tpu_torch.bench.flash_fwd_phases``
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

# (B, S, H, Hkv, D, causal, kv_len)
SHAPES = {"gpt2": (16, 1024, 12, 12, 64, True, None),
          "llama_moe": (4, 2048, 16, 4, 64, True, None),
          "vit_b16": (128, 256, 12, 12, 64, False, 197),
          "llama_prefill": (1, 2048, 32, 8, 128, True, None)}

_ADD = "if (threadIdx.x % 128 == 0) atomicAdd(&g_probe[{}], " \
       "(unsigned long long)({}));"
_ONE = "atomicAdd(&g_probe[{}], (unsigned long long)({}));"

# (anchor, text inserted before it, text inserted after it); each anchor
# must occur in the source exactly once.
_PROBES = [
    # consumer, one key tile after the first of a work item: waiting for
    # its stage; its S (issued with the previous tile's P V) until done;
    # the online softmax (ex2); the rest of the previous P V; the rescale
    # of O and the bf16 packs.
    ("      s = it % kStages;\n      mbar_wait(&full[s], (it / kStages) & 1);\n",
     "      long long t_a = clock64();\n",
     "      long long t_b = clock64(); " + _ADD.format(0, "t_b - t_a") + "\n"),
    ("      wgmma_wait<1>();\n      reg_fence(sc);\n", "",
     "      long long t_c = clock64(); " + _ADD.format(1, "t_c - t_b") + "\n"),
    ("      wgmma_wait<0>();\n      reg_fence(o);\n      reg_fence(p);\n",
     "      long long t_d = clock64(); " + _ADD.format(2, "t_d - t_c") + "\n",
     "      long long t_e = clock64(); " + _ADD.format(3, "t_e - t_d") + "\n"),
    ("        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];\n"
     "      to_a_frags<kBN>(sc, p);\n",
     "",
     "      " + _ADD.format(4, "clock64() - t_e") + " "
     + _ADD.format(5, "clock64() - t_a") + " " + _ADD.format(6, "1") + "\n"),
    # producer: waiting for a free stage, the rest of its step.
    ("        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);\n",
     "        long long p_a = clock64();\n",
     "        long long p_b = clock64(); " + _ONE.format(8, "p_b - p_a")
     + "\n"),
    ("        tma_load_tile<D>(v_s + s * kBN * D, &map_v, &full[s], kBN, wk.hk,\n"
     "                         t * kBN, wk.b);\n", "",
     "        " + _ONE.format(9, "clock64() - p_b") + " "
     + _ONE.format(10, "1") + "\n"),
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

_HEAD = "namespace {\n\nconstexpr float kNegInf"

def probed_source(src: str) -> str:
    """``src`` with the probes, the counters and their reader added."""
    for anchor, before, after in _PROBES:
        if src.count(anchor) != 1:
            raise AssertionError(f"probe anchor not in flash_fwd.cu exactly "
                                 f"once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    if src.count(_HEAD) != 1:
        raise AssertionError("flash_fwd.cu's namespace opening moved")
    src = src.replace(_HEAD, "__device__ unsigned long long g_probe[32];\n"
                      + _HEAD)
    return src + _READ


def build() -> ctypes.CDLL:
    out_dir = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "flash_fwd.cu")) as f:
        src = probed_source(f.read())
    path = os.path.join(out_dir, "flash_fwd_phases.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libflash_fwd_phases.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probed copy:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def _inputs(shape):
    B, S, H, Hkv, D, causal, kv_len = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    return (q, k, v), dict(causal=causal, kv_len=kv_len)


def phases(lib, shape) -> dict:
    args, kw = _inputs(shape)
    flash.flash_attention_fwd(*args, **kw)  # warm
    counts = (ctypes.c_ulonglong * 32)()
    _build.check(lib.pdtx_probe(counts, 1), "probe reset")
    flash.flash_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    _build.check(lib.pdtx_probe(counts, 0), "probe read")
    c = list(counts)
    per = max(c[6], 1)
    per_p = max(c[10], 1)
    B, S, H, Hkv, D, causal, kv_len = shape
    return {"shape": dict(B=B, S=S, H=H, Hkv=Hkv, D=D, causal=causal,
                          kv_len=kv_len),
            "consumer_clocks_per_tile": {
                "wait_stage": c[0] / per, "s_until_done": c[1] / per,
                "softmax_ex2": c[2] / per, "pv_rest": c[3] / per,
                "rescale_pack": c[4] / per, "step": c[5] / per},
            "consumer_tiles": c[6],
            "producer_clocks_per_tile": {"wait_free_stage": c[8] / per_p,
                                         "rest": c[9] / per_p}}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    with _build.using("flash_fwd", lib):
        rows = {name: phases(lib, shape) for name, shape in SHAPES.items()}
    assert all(math.isfinite(x) for r in rows.values()
               for x in r["consumer_clocks_per_tile"].values())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
