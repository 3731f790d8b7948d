"""Flat dataclass config + the five workload presets from BASELINE.json.

The PyTorch port's own copy of ``pytorch_distributed_training_example_tpu/
utils/config.py``: every field and default is kept identical, so one set of
CLI flags describes a run of either package. The port keeps a copy rather
than importing it because importing the JAX package imports jax. Fields that
name a subsystem the port does not have yet are carried unchanged; the
port's ``main`` rejects the ones a run would silently ignore.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Config:
    # workload
    model: str = "resnet18"
    dataset: str = "cifar10"
    num_classes: int = 10
    image_size: int = 32
    seq_len: int = 1024
    # optimization
    epochs: int = 10
    global_batch_size: int = 256
    lr: float = 0.1
    warmup_epochs: float = 1.0
    # cosine (default) | step (the reference ImageNet recipe:
    # lr * gamma^(epoch // step_epochs)) | constant
    lr_schedule: str = "cosine"
    lr_step_epochs: int = 30
    lr_gamma: float = 0.1
    weight_decay: float = 1e-4
    momentum: float = 0.9
    optimizer: str = "sgd"  # sgd | adamw
    label_smoothing: float = 0.0
    grad_clip: float = 0.0
    # attention kernel: auto | xla | flash (Pallas) | ring (CP) | ulysses
    attn_impl: str = "auto"
    # model regularization (0.0 matches torchvision factory defaults; the
    # registry forwards it to families that support it, e.g. ViT)
    dropout: float = 0.0
    # precision / memory
    precision: str = "bf16"
    remat: bool = False  # gradient checkpointing (reference configs[4])
    # checkpoint policy under remat (Llama family): nothing | dots |
    # dots_no_batch | attn_out — see models.llama.REMAT_POLICIES
    remat_policy: str = "nothing"
    grad_accum_steps: int = 1  # microbatches per optimizer step (in-step scan)
    # MoE routing/dispatch (llama_moe family; parallel/moe.py)
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_dispatch_impl: str = "gather"  # sort | gather | einsum | dropless
    moe_combine_dtype: str = "fp32"  # fp32 (exact) | bf16 (combine-BW A/B)
    moe_router_dtype: str = "fp32"  # fp32 (ST-MoE exact) | bf16 (matmul A/B)
    moe_router_impl: str = "reference"  # reference | fused (Pallas kernel)
    # dropless EP transport: replicated weights | sharded a2a | a2a+gmm overlap
    moe_ep_dispatch: str = "replicated"  # replicated | a2a | a2a_overlap
    moe_ep_overlap_chunks: int = 2  # a2a_overlap double-buffer windows
    pp_microbatches: int = 8  # GPipe microbatches (strategy "pp")
    # parallelism (mesh axis sizes; -1 absorbs remaining devices)
    strategy: str = "dp"  # dp | fsdp | fsdp_tp (model-provided tables)
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_stage: int = 1
    mesh_expert: int = 1
    mesh_context: int = 1
    mesh_model: int = 1
    # io
    data_path: str | None = None
    workers: int = 4
    native_loader: bool = True  # C++ batch engine when dataset supports it
    log_every: int = 50
    eval_every_epochs: int = 1
    checkpoint_dir: str | None = None
    # TensorBoard scalar export dir (optional; JSONL is always written
    # when checkpoint_dir is set)
    tensorboard_dir: str | None = None
    checkpoint_every_epochs: int = 1
    # 0 = epoch-boundary only. N > 0 also saves every N optimizer steps with
    # the within-epoch offset recorded, so --resume restarts mid-epoch at the
    # exact next unseen sample (the 8B-class configs cannot afford losing a
    # days-long epoch to a failure; BASELINE.json configs[4]).
    checkpoint_every_steps: int = 0
    resume: str | None = None  # path | "auto"
    # elastic resume (utils/elastic.py): when resuming under a different
    # world size, rebuild the mesh at the surviving size (degraded axes
    # allowed) and rescale the batch geometry under elastic_policy instead
    # of failing the mid-epoch geometry guard.
    elastic: bool = False
    elastic_policy: str = "keep_global_batch"  # | "scale_lr"
    evaluate: bool = False  # eval-only mode (main.py --evaluate)
    seed: int = 0
    # telemetry (utils/telemetry.py): on-device health pack in the metrics
    # dict + host span timeline / goodput accounting + anomaly guard
    telemetry: bool = False
    # 0 = health rows ride the log_every fetch only (zero extra host syncs);
    # N > 0 also fetches/checks the health pack every N steps (kind="health"
    # JSONL rows between the train rows)
    health_every: int = 0
    # on a non-finite health scalar: dump a diagnostic bundle then
    # "abort" (raise) | "continue" (log and keep training) | "rollback"
    # (restore the last committed checkpoint and continue past the poisoned
    # batch window — Switch-Transformer-style instability recovery)
    anomaly_action: str = "abort"
    # rollback restores allowed per run before escalating to abort (a model
    # that keeps diverging after N restores has a real problem, not a blip)
    rollback_budget: int = 3
    # watchdog: seconds without step progress before dumping stacks/aborting
    # (utils/watchdog.py; was hardcoded at 1800)
    watchdog_timeout: float = 1800.0
    # fleet observability (utils/fleetobs.py) — straggler warn threshold:
    # a step whose host-local wait exceeds (threshold - 1) x the median step
    # time trips the AnomalyGuard's warn-only trigger and is flagged by the
    # offline merge (benchmarks/trace_merge.py)
    straggler_threshold: float = 2.0
    # flight recorder: step records kept in the ring dumped on anomaly /
    # preemption / host-loss exits (flightrec*.jsonl)
    flightrec_steps: int = 256
    # rank-0 Prometheus endpoint (fleetobs.MetricsServer): None disables,
    # 0 binds an ephemeral port (logged), N binds :N
    metrics_port: int | None = None
    # deterministic fault injection (utils/chaos.py): comma-separated spec,
    # e.g. "sigterm@step=7,ckpt_io_error@save=2" — None disables
    chaos: str | None = None
    chaos_seed: int | None = None  # defaults to `seed` when unset
    # r21 instant restart (core/xcache.py): persist the train step's
    # compiled executable under <checkpoint_dir>/xcache keyed by a
    # topology/knob/aval fingerprint, so a supervisor relaunch at a
    # previously seen topology deserializes instead of compiling. The jax
    # persistent compilation cache is pointed at the same directory as the
    # fallback where executable serialization is unsupported.
    xcache: bool = False
    # profiling
    profile_steps: str | None = None  # "start:stop" step range
    profile_dir: str = "/tmp/pdtx_profile"
    # fault injection (SURVEY.md §5 failure detection): "rank:step" hard-kills
    # that host process before the given global step — for recovery testing.
    fault_inject: str | None = None
    # loop control (bench/smoke)
    steps_per_epoch: int | None = None  # cap steps (synthetic/bench runs)
    # serving (serve/): main.py --serve runs the continuous-batching decode
    # engine over a paged KV cache instead of training. Restores params only
    # (Checkpointer.restore_params) when --resume is set. Bucket lists are
    # comma-separated ints; max_model_len 0 means the model/cache cap.
    serve: bool = False
    serve_page_size: int = 16
    serve_num_pages: int = 128
    serve_max_model_len: int = 0
    serve_decode_buckets: str = "1,2,4,8"
    serve_prompt_buckets: str = "16,32"
    serve_requests: int = 16
    serve_rate: float = 0.0  # open-loop req/s; 0 = all at t=0 (saturation)
    # SIGTERM drain budget: in-flight sequences get this many seconds to
    # finish decoding before the session exits PREEMPTED_EXIT_CODE (the
    # fleet scheduler's preemption contract for serving jobs).
    serve_drain_timeout: float = 5.0
    # r17 serving-throughput stack (serve/prefix_cache.py, serve/router.py):
    # prefix caching, chunked prefill + prefill/decode disaggregation, and
    # multi-replica prefix-affinity routing over one process's devices.
    serve_prefix_cache: bool = False
    serve_prefill_chunk: int = 0      # tokens/window; 0 = whole prompt
    serve_disaggregate: bool = False  # prefill-role + decode-role pair
    serve_replicas: int = 1
    serve_route: str = "affinity"     # affinity | least_loaded
    # Shared-prefix synthetic workload (Zipf-popular prompt templates).
    serve_templates: int = 0
    serve_zipf_a: float = 1.2
    serve_prefix_len: str = "16:32"   # template length range, "min:max"
    # r19 speculative decoding (serve/spec_decode.py): "off" | "ngram"
    # (self-drafting prompt lookup) | "draft" (separate small draft model
    # named by serve_draft_model, params-only restored from an optional
    # "name@ckpt_dir" suffix). Greedy output stays bit-identical to the
    # unsped engine; draft_len bounds the per-step speculation window.
    serve_spec_decode: str = "off"
    serve_draft_len: int = 4
    serve_draft_model: str = ""
    # r20 serving SLO observability (serve/slo.py): per-request span
    # tracing (reqtrace.<replica>.a<A>.json, merged by trace_merge.py)
    # plus a sliding-window TTFT/ITL quantile tracker flushed to
    # slo.jsonl, which the fleet scheduler folds into serve-job
    # placement weights. Targets of 0 ms disable attainment/breach
    # accounting (quantiles still export).
    serve_slo: bool = False
    serve_slo_window: int = 256       # samples per replica/role window
    serve_slo_ttft_ms: float = 0.0    # TTFT target; 0 = no target
    serve_slo_itl_ms: float = 0.0     # per-token ITL target; 0 = no target
    serve_trace_events: int = 4096    # request-span ring capacity/replica

    def mesh_config(self) -> dict[str, int]:
        return dict(data=self.mesh_data, fsdp=self.mesh_fsdp, stage=self.mesh_stage,
                    expert=self.mesh_expert, context=self.mesh_context,
                    model=self.mesh_model)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


#: The reference's workload matrix (BASELINE.json ``configs``), one preset each.
PRESETS: dict[str, dict[str, Any]] = {
    # configs[0]: ResNet-18 / CIFAR-10 — single-process, CPU-runnable dev config
    "resnet18_cifar10": dict(
        model="resnet18", dataset="cifar10", num_classes=10, image_size=32,
        epochs=30, global_batch_size=256, lr=0.1, warmup_epochs=2.0,
        weight_decay=5e-4, precision="fp32", strategy="dp",
    ),
    # configs[1]: ResNet-50 / ImageNet-1k — data-parallel (the headline metric)
    "resnet50_imagenet": dict(
        model="resnet50", dataset="imagenet", num_classes=1000, image_size=224,
        epochs=90, global_batch_size=1024, lr=0.4, warmup_epochs=5.0,
        weight_decay=1e-4, precision="bf16", strategy="dp",
    ),
    # configs[2]: ViT-B/16 / ImageNet-1k — DDP -> pjit data-parallel
    "vit_b16_imagenet": dict(
        model="vit_b16", dataset="imagenet", num_classes=1000, image_size=224,
        epochs=90, global_batch_size=1024, lr=3e-3, warmup_epochs=10.0,
        weight_decay=0.1, optimizer="adamw", label_smoothing=0.1,
        precision="bf16", strategy="dp", grad_clip=1.0,
    ),
    # configs[3]: GPT-2 124M LM — FSDP -> GSPMD param-shard
    "gpt2_124m": dict(
        model="gpt2", dataset="lm", seq_len=1024, epochs=1,
        global_batch_size=256, lr=6e-4, warmup_epochs=0.01,
        weight_decay=0.1, optimizer="adamw", precision="bf16",
        strategy="fsdp", mesh_data=1, mesh_fsdp=-1, grad_clip=1.0,
    ),
    # configs[4]: Llama-3 8B — FSDP + gradient checkpointing
    "llama3_8b": dict(
        model="llama3_8b", dataset="lm", seq_len=8192, epochs=1,
        global_batch_size=128, lr=3e-4, warmup_epochs=0.01,
        weight_decay=0.1, optimizer="adamw", precision="bf16",
        strategy="fsdp", mesh_data=1, mesh_fsdp=-1, remat=True, grad_clip=1.0,
    ),
}


def from_preset(name: str, **overrides) -> Config:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return Config(**{**PRESETS[name], **overrides})
