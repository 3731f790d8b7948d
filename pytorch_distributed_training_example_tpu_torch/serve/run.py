"""CLI serving session behind the port's ``main --serve``.

Counterpart of ``pytorch_distributed_training_example_tpu/serve/run.py``:
builds the decode-capable model from the Config directly on the device,
initialised from ``cfg.seed``, and drains a seeded synthetic request stream
through the continuous-batching engine, printing a JSON summary. The stream
is shaped exactly as in the JAX session, so both packages serve the same
requests for the same flags.

Not ported yet, and refused by ``main`` when asked for: ``--resume``
(params-only restore waits for the checkpoint port), prefix caching,
chunked prefill, disaggregation, replicas behind the router, speculative
decoding, SLO tracing and the metrics endpoint.
"""

from __future__ import annotations

import json
import time

from pytorch_distributed_training_example_tpu_torch.utils import resilience


def serve_loop(driver, eng, drain_timeout_s: float = 5.0) -> dict:
    """Drive the open-loop stream until drained — or gracefully shut down.

    When a SIGTERM lands (``resilience.preempted()``, handler installed by
    :func:`main`), the loop stops pumping new requests and *drains*: active
    slots keep decoding to completion via ``eng.step(admit=False)``, bounded
    by ``drain_timeout_s``, and the session then exits
    ``PREEMPTED_EXIT_CODE``.
    """
    t0 = time.perf_counter()
    drain_deadline = None
    while driver.remaining or eng.has_work:
        if drain_deadline is None and resilience.preempted():
            drain_deadline = time.perf_counter() + drain_timeout_s
        if drain_deadline is not None:
            if eng.num_active == 0 or time.perf_counter() >= drain_deadline:
                break
            eng.step(admit=False)
            continue
        driver.pump(eng, time.perf_counter() - t0)
        if eng.has_work:
            eng.step()
        else:
            time.sleep(0.0005)
    return {"wall_s": time.perf_counter() - t0,
            "preempted": drain_deadline is not None,
            "drained": eng.num_active == 0}


def buckets(spec: str) -> tuple[int, ...]:
    """A comma-separated bucket flag as ints."""
    return tuple(int(t) for t in spec.split(",") if t)


def stream_for(cfg, max_seq_len: int, vocab_size: int):
    """The synthetic request stream for ``cfg``, shaped as the JAX session
    shapes it: prompts no longer than the largest prompt bucket, prompt +
    new tokens within the model-length budget, template prefix + random
    suffix within the prompt cap."""
    from pytorch_distributed_training_example_tpu_torch.serve import loadgen

    plen_cap = max(buckets(cfg.serve_prompt_buckets))
    len_budget = (cfg.serve_max_model_len or max_seq_len) - plen_cap
    defaults = loadgen.LoadSpec()
    pfx_min_s, _, pfx_max_s = cfg.serve_prefix_len.partition(":")
    pfx_max = min(int(pfx_max_s or pfx_min_s),
                  plen_cap - defaults.prompt_len_min)
    pfx_min = min(int(pfx_min_s), pfx_max)
    suffix_cap = plen_cap - (pfx_max if cfg.serve_templates else 0)
    return loadgen.generate_requests(loadgen.LoadSpec(
        num_requests=cfg.serve_requests, rate=cfg.serve_rate,
        prompt_len_min=min(defaults.prompt_len_min, suffix_cap),
        prompt_len_max=max(1, min(defaults.prompt_len_max, suffix_cap)),
        max_new_min=max(1, min(defaults.max_new_min, len_budget)),
        max_new_max=max(1, min(defaults.max_new_max, len_budget)),
        vocab_size=int(vocab_size), seed=cfg.seed,
        num_templates=cfg.serve_templates, zipf_a=cfg.serve_zipf_a,
        prefix_len_min=pfx_min, prefix_len_max=pfx_max))


def main(cfg, device="cuda") -> dict:
    """Serve ``cfg``'s synthetic stream on ``device``; returns (and prints)
    the JSON summary."""
    import numpy as np
    import torch

    from pytorch_distributed_training_example_tpu_torch.models import registry
    from pytorch_distributed_training_example_tpu_torch.serve import (
        engine as engine_lib, loadgen)

    dtype = torch.float32 if cfg.precision == "fp32" else torch.bfloat16
    module = registry.create_model(cfg.model, seq_len=cfg.seq_len,
                                   dtype=dtype, device=device, seed=cfg.seed)
    spec = engine_lib.spec_for_module(module, num_pages=cfg.serve_num_pages,
                                      page_size=cfg.serve_page_size)
    eng = engine_lib.ContinuousBatchingEngine(
        module, spec, decode_buckets=buckets(cfg.serve_decode_buckets),
        prompt_buckets=buckets(cfg.serve_prompt_buckets),
        max_model_len=cfg.serve_max_model_len or None)
    eng.warmup()
    requests = stream_for(cfg, module.max_seq_len, module.vocab_size)
    # SIGTERM becomes a bounded drain + exit 75 instead of a mid-step death.
    # Install is idempotent and a no-op off the main thread.
    resilience.install()
    outcome = serve_loop(loadgen.OpenLoopDriver(requests), eng,
                         drain_timeout_s=cfg.serve_drain_timeout)
    wall = outcome["wall_s"]
    stats = dict(eng.stats)
    completed = eng.completed
    ttfts = sorted(r.ttft_s for r in completed if r.ttft_s is not None)
    result = {
        "mode": "serve",
        "model": cfg.model,
        "device": str(eng.device),
        "restored_step": None,
        "requests_completed": len(completed),
        "tokens_generated": stats["tokens_generated"],
        "tokens_per_s": round(stats["tokens_generated"] / max(wall, 1e-9), 2),
        "ttft_p50_ms": (round(1e3 * float(np.percentile(ttfts, 50)), 3)
                        if ttfts else None),
        "compiles": stats["compiles"],
        "decode_steps": stats["decode_steps"],
        "evictions": stats["evictions"],
        "nonfinite_logits": stats["nonfinite_logits"],
        "preempted": outcome["preempted"],
        "drained": outcome["drained"],
    }
    print(json.dumps(result, indent=2))
    if outcome["preempted"]:
        raise resilience.PreemptedExit()
    return result
