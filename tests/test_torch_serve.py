"""The port's serving engine, load generator and CLI against the JAX ones.

Token identity is the contract: on ``llama_tiny`` at fp32 with bridged
weights, the port's continuous-batching engine must emit exactly the JAX
engine's greedy tokens — across page crossings and under eviction with
recompute. One JAX engine run (a pool large enough to never evict) serves
as the reference for both request sets.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_training_example_tpu.models import (
    registry as jax_registry)
from pytorch_distributed_training_example_tpu.serve import (
    engine as jax_engine, loadgen as jax_loadgen)
from pytorch_distributed_training_example_tpu_torch import bridge
from pytorch_distributed_training_example_tpu_torch import main as port_main
from pytorch_distributed_training_example_tpu_torch.models import registry
from pytorch_distributed_training_example_tpu_torch.serve import (
    engine as engine_lib, loadgen, run as serve_run)
from pytorch_distributed_training_example_tpu_torch.utils import resilience


def _crossing_requests(cls):
    """The JAX package's page-crossing setup: prompt lengths straddle the
    8-token page, 12 new tokens push each across at least one more."""
    rng = np.random.default_rng(7)
    return [cls(request_id=f"x{i}", prompt=rng.integers(1, 512, p).tolist(),
                max_new_tokens=12) for i, p in enumerate([3, 8, 9, 23])]


def _eviction_requests(cls):
    """Four 12-token prompts generating 28 tokens each: two cannot share
    11 pages of 8 tokens, so a 4-wide batch must evict."""
    rng = np.random.default_rng(11)
    return [cls(request_id=f"e{i}", prompt=rng.integers(1, 512, 12).tolist(),
                max_new_tokens=28) for i in range(4)]


@pytest.fixture(scope="module")
def models():
    module = jax_registry.create_model("llama_tiny", seq_len=128,
                                       dtype=jnp.float32,
                                       param_dtype=jnp.float32).module
    params = jax.jit(functools.partial(module.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = registry.create_model("llama_tiny", seq_len=128,
                                  dtype=torch.float32, device="cpu",
                                  seed=None)
    bridge.load_flax_params(model, jax.tree.map(np.asarray, params))
    return module, params, model


@pytest.fixture(scope="module")
def jax_tokens(models):
    module, params, _ = models
    spec = jax_engine.spec_for_module(module, num_pages=64, page_size=8)
    eng = jax_engine.ContinuousBatchingEngine(
        module, params, spec, decode_buckets=(1, 2, 4),
        prompt_buckets=(16, 32), max_model_len=64)
    for r in (_crossing_requests(jax_engine.Request)
              + _eviction_requests(jax_engine.Request)):
        eng.submit(r)
    done = eng.run()
    assert eng.stats["evictions"] == 0
    return {r.request_id: r.generated for r in done}


def _port_tokens(model, reqs, **kw):
    spec = engine_lib.spec_for_module(model, num_pages=kw.pop("num_pages"),
                                      page_size=8)
    eng = engine_lib.ContinuousBatchingEngine(model, spec, **kw)
    for r in reqs:
        eng.submit(r)
    return eng, {r.request_id: r.generated for r in eng.run()}


def test_engine_matches_jax_engine_with_page_crossings(models, jax_tokens):
    reqs = _crossing_requests(engine_lib.Request)
    eng, got = _port_tokens(models[2], reqs, num_pages=32,
                            decode_buckets=(1, 2, 4), prompt_buckets=(16, 32),
                            max_model_len=64)
    assert len(got) == 4 and eng.stats["nonfinite_logits"] == 0
    for r in reqs:
        assert got[r.request_id] == jax_tokens[r.request_id], r.request_id


def test_engine_eviction_recompute_matches_jax(models, jax_tokens):
    reqs = _eviction_requests(engine_lib.Request)
    eng, got = _port_tokens(models[2], reqs, num_pages=12,
                            decode_buckets=(1, 2, 4), prompt_buckets=(16,),
                            max_model_len=48)
    assert len(got) == 4
    assert eng.stats["evictions"] > 0  # the pressure actually materialized
    for r in reqs:
        assert got[r.request_id] == jax_tokens[r.request_id], r.request_id


def test_engine_no_steady_state_new_shapes(models):
    spec = engine_lib.spec_for_module(models[2], num_pages=64, page_size=8)
    eng = engine_lib.ContinuousBatchingEngine(
        models[2], spec, decode_buckets=(1, 2, 4), prompt_buckets=(16,),
        max_model_len=48)
    n = eng.warmup()
    assert eng.stats["compiles"] == n == 4  # 3 decode buckets + 1 prefill
    for r in loadgen.generate_requests(loadgen.LoadSpec(
            num_requests=9, prompt_len_max=15, max_new_max=10, seed=1)):
        eng.submit(r)
    eng.run()
    assert len(eng.completed) == 9
    assert eng.stats["compiles"] == n


def test_serve_loop_drains_in_flight_requests_on_preemption(models):
    """A tripped preemption flag stops admission; the active slots decode to
    completion within the drain budget and the queue is left alone."""
    spec = engine_lib.spec_for_module(models[2], num_pages=64, page_size=8)
    eng = engine_lib.ContinuousBatchingEngine(
        models[2], spec, decode_buckets=(1, 2), prompt_buckets=(16,),
        max_model_len=48)
    reqs = loadgen.generate_requests(loadgen.LoadSpec(
        num_requests=5, prompt_len_max=15, max_new_max=10, seed=2))
    driver = loadgen.OpenLoopDriver(reqs)
    driver.pump(eng, 0.0)
    eng.step()  # two requests admitted, three waiting
    resilience.trip()
    try:
        outcome = serve_run.serve_loop(driver, eng, drain_timeout_s=30.0)
    finally:
        resilience.reset()
    assert outcome["preempted"] and outcome["drained"]
    assert len(eng.completed) == 2 and len(eng.waiting) == 3


@pytest.mark.parametrize("spec", [
    dict(num_requests=16, rate=100.0, seed=5),
    dict(num_requests=12, seed=3, num_templates=3, prompt_len_max=9),
])
def test_loadgen_stream_identical_to_jax(spec):
    a = loadgen.generate_requests(loadgen.LoadSpec(**spec))
    b = jax_loadgen.generate_requests(jax_loadgen.LoadSpec(**spec))
    fields = ("request_id", "prompt", "max_new_tokens", "eos_id",
              "arrival_time")
    assert [[getattr(r, f) for f in fields] for r in a] == \
        [[getattr(r, f) for f in fields] for r in b]


def test_cli_serves_stream_on_cpu(capsys):
    try:
        assert port_main.main(["--device", "cpu", "--serve", "--model",
                               "llama_tiny"]) == 0
    finally:
        resilience.uninstall()  # the session installs SIGTERM/SIGINT handlers
    out = capsys.readouterr().out
    result = json.loads(out[out.index("{"):])
    assert result["requests_completed"] == 16  # the default --serve stream
    assert result["device"] == "cpu" and result["drained"]
    assert result["nonfinite_logits"] == 0


def test_cli_refuses_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main.main(["--serve", "--model", "llama_tiny"])


@pytest.mark.parametrize("argv,what", [
    (["--resume"], "checkpoint restore"),
    (["--checkpoint-dir", "runs"], "run records"),
    (["--serve-prefix-cache"], "prefix caching"),
    (["--serve-spec-decode", "ngram"], "speculative decoding"),
])
def test_cli_rejects_options_not_yet_ported(argv, what):
    with pytest.raises(SystemExit, match=what):
        port_main.main(["--device", "cpu", "--serve", "--model",
                        "llama_tiny", *argv])
    with pytest.raises(SystemExit, match="next slice"):
        port_main.main(["--device", "cpu", "--model", "llama_tiny"])
