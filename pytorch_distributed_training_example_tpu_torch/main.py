#!/usr/bin/env python
"""Entry point of the PyTorch port — ``--serve`` only, for now.

Counterpart of the repository's root ``main.py``: the same flag names and
defaults for every ``--serve*`` flag and for the model, precision and seed
flags, so one command line describes a serving run of either package.
``--device {cuda,cpu}`` takes the place of ``--platform``: the port runs on
the GPU unless ``--device cpu`` is given, and raises when CUDA is missing
rather than carrying on on the CPU.

Run: ``python -m pytorch_distributed_training_example_tpu_torch.main
--serve --model llama3_8b``.
"""

from __future__ import annotations

import argparse
import dataclasses

#: Serving options of the JAX session that the port does not have yet,
#: with the value that leaves each one off. Asking for another value raises.
NOT_YET_PORTED = {
    "resume": (None, "params-only checkpoint restore (the checkpoint port)"),
    "checkpoint_dir": (None, "run records under the checkpoint directory "
                             "(run id, flight recorder)"),
    "metrics_port": (None, "the Prometheus metrics endpoint"),
    "serve_prefix_cache": (False, "prefix caching"),
    "serve_prefill_chunk": (0, "chunked prefill"),
    "serve_disaggregate": (False, "prefill/decode disaggregation"),
    "serve_replicas": (1, "replicas behind the router"),
    "serve_spec_decode": ("off", "speculative decoding"),
    "serve_slo": (False, "SLO tracing"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA port: continuous-batching serving")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs; cuda (the default) raises if "
                        "no CUDA device is present")
    p.add_argument("--config", default=None,
                   help="preset name (resnet18_cifar10, resnet50_imagenet, "
                        "vit_b16_imagenet, gpt2_124m, llama3_8b)")
    p.add_argument("--model", default=None)
    p.add_argument("--precision", default=None,
                   choices=["fp32", "bf16", "pure_bf16", "fp16"])
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="run records directory (not yet ported)")
    p.add_argument("--resume", default=None, nargs="?", const="auto",
                   help="checkpoint dir or 'auto' (not yet ported)")
    p.add_argument("--metrics-port", type=int, default=None,
                   dest="metrics_port",
                   help="Prometheus endpoint port (not yet ported)")
    p.add_argument("--serve", action="store_true", default=None,
                   help="run the continuous-batching decode engine (serve/)")
    p.add_argument("--serve-page-size", type=int, default=None,
                   dest="serve_page_size",
                   help="KV cache page size in tokens (default 16)")
    p.add_argument("--serve-num-pages", type=int, default=None,
                   dest="serve_num_pages",
                   help="KV cache pool size in pages (default 128)")
    p.add_argument("--serve-max-model-len", type=int, default=None,
                   dest="serve_max_model_len",
                   help="per-request token cap; 0 = model/cache capacity")
    p.add_argument("--serve-decode-buckets", default=None,
                   dest="serve_decode_buckets",
                   help="comma-separated padded decode batch sizes")
    p.add_argument("--serve-prompt-buckets", default=None,
                   dest="serve_prompt_buckets",
                   help="comma-separated padded prefill prompt lengths")
    p.add_argument("--serve-requests", type=int, default=None,
                   dest="serve_requests",
                   help="number of synthetic requests to drain")
    p.add_argument("--serve-rate", type=float, default=None, dest="serve_rate",
                   help="open-loop Poisson arrival rate (req/s); 0 = all at "
                        "t=0 (saturation)")
    p.add_argument("--serve-drain-timeout", type=float, default=None,
                   dest="serve_drain_timeout",
                   help="on SIGTERM, seconds to let in-flight sequences "
                        "finish decoding before exiting 75")
    p.add_argument("--serve-prefix-cache", action="store_true", default=None,
                   dest="serve_prefix_cache", help="not yet ported")
    p.add_argument("--serve-prefill-chunk", type=int, default=None,
                   dest="serve_prefill_chunk", help="not yet ported")
    p.add_argument("--serve-disaggregate", action="store_true", default=None,
                   dest="serve_disaggregate", help="not yet ported")
    p.add_argument("--serve-replicas", type=int, default=None,
                   dest="serve_replicas", help="not yet ported beyond 1")
    p.add_argument("--serve-route", default=None, dest="serve_route",
                   choices=["affinity", "least_loaded"],
                   help="replica placement policy (with --serve-replicas)")
    p.add_argument("--serve-templates", type=int, default=None,
                   dest="serve_templates",
                   help="shared-prefix prompt templates in the synthetic "
                        "stream (0 = fully random prompts)")
    p.add_argument("--serve-zipf-a", type=float, default=None,
                   dest="serve_zipf_a",
                   help="Zipf exponent for template popularity")
    p.add_argument("--serve-prefix-len", default=None, dest="serve_prefix_len",
                   help="template length range, \"min:max\" tokens")
    p.add_argument("--serve-spec-decode", default=None,
                   dest="serve_spec_decode",
                   choices=["off", "ngram", "draft"],
                   help="speculative decoding (not yet ported beyond off)")
    p.add_argument("--serve-draft-len", type=int, default=None,
                   dest="serve_draft_len",
                   help="max draft tokens verified per step (with "
                        "--serve-spec-decode)")
    p.add_argument("--serve-draft-model", default=None,
                   dest="serve_draft_model",
                   help="draft model (with --serve-spec-decode draft)")
    p.add_argument("--serve-slo", action="store_true", default=None,
                   dest="serve_slo", help="not yet ported")
    p.add_argument("--serve-slo-window", type=int, default=None,
                   dest="serve_slo_window", help="with --serve-slo")
    p.add_argument("--serve-slo-ttft-ms", type=float, default=None,
                   dest="serve_slo_ttft_ms", help="with --serve-slo")
    p.add_argument("--serve-slo-itl-ms", type=float, default=None,
                   dest="serve_slo_itl_ms", help="with --serve-slo")
    p.add_argument("--serve-trace-events", type=int, default=None,
                   dest="serve_trace_events", help="with --serve-slo")
    return p


def config_from_args(args):
    from pytorch_distributed_training_example_tpu_torch.utils.config import (
        Config, from_preset)

    cfg = from_preset(args.config) if args.config else Config()
    field_names = {f.name for f in dataclasses.fields(Config)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in field_names and v is not None}
    return cfg.replace(**overrides)


def resolve_device(name: str):
    """The torch device for ``--device``; CUDA must really be there."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) but torch.cuda.is_available() is "
            "False; pass --device cpu to run the port on the CPU")
    return torch.device(name)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.serve:
        raise SystemExit(
            "the PyTorch port serves only (--serve); training comes with "
            "the next slice of the port (LM training: flash backward "
            "kernels and the trainer)")
    for field, (off, what) in NOT_YET_PORTED.items():
        if getattr(cfg, field) != off:
            raise SystemExit(f"--{field.replace('_', '-')}: {what} is not "
                             "yet ported to PyTorch")
    device = resolve_device(args.device)

    from pytorch_distributed_training_example_tpu_torch.serve import (
        run as serve_run)

    serve_run.main(cfg, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
