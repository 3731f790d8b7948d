"""The port's Llama against the JAX package's, on ``llama_tiny`` at fp32.

The JAX model's params are carried across with ``bridge.py``, so both
packages compute the same function on the same weights. Logit tolerance is
atol 1e-4: fp32 throughout, sums in another order in two frameworks, on
logits of order one.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_training_example_tpu.models import (
    llama as jax_llama, registry as jax_registry)
from pytorch_distributed_training_example_tpu.serve import (
    kv_cache as jax_kv)
from pytorch_distributed_training_example_tpu_torch import bridge
from pytorch_distributed_training_example_tpu_torch.models import (
    llama, registry)
from pytorch_distributed_training_example_tpu_torch.serve import kv_cache

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    module = jax_registry.create_model("llama_tiny", seq_len=128,
                                       dtype=jnp.float32,
                                       param_dtype=jnp.float32).module
    params = jax.jit(functools.partial(module.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    model = registry.create_model("llama_tiny", seq_len=128,
                                  dtype=torch.float32, device="cpu",
                                  seed=None)
    bridge.load_flax_params(model, params)
    return module, params, model


def test_training_forward_matches_jax(pair):
    module, params, model = pair
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    ref = np.asarray(jax.jit(functools.partial(module.apply, train=False))(
        {"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 24, 512)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert llama.num_params(model) == jax_llama.num_params(module) == sum(
        p.numel() for p in model.parameters())


def test_prefill_and_decode_through_paged_cache_match_jax(pair):
    """Two prompts prefilled into scattered pages, then batched decode
    steps (with a filler row on the scratch page) that cross page edges,
    then a prefill window with history on a fresh page: every step's
    next-token logits against the JAX decode_ctx path."""
    module, params, model = pair
    P, ps, W = 16, 4, 8
    jspec = jax_kv.CacheSpec(num_layers=2, num_pages=P, page_size=ps,
                             num_kv_heads=2, head_dim=32)
    jcache = jax_kv.init_cache(jspec)
    spec = kv_cache.CacheSpec(num_layers=2, num_pages=P, page_size=ps,
                              num_kv_heads=2, head_dim=32)
    cache = kv_cache.init_cache(spec, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, 11).tolist(),
               rng.integers(1, 512, 6).tolist()]
    tables = np.zeros((2, W), np.int32)
    tables[0, :4] = [9, 3, 12, 5]
    tables[1, :3] = [7, 14, 2]

    @functools.partial(jax.jit, static_argnames="history")
    def jax_step(cache, tokens, positions, table, last, history):
        logits, vs = module.apply(
            {"params": params, "cache": cache}, tokens, train=False,
            decode_ctx=dict(positions=positions, page_table=table,
                            cache_spec=(P, ps), last_index=last,
                            history=history, attn_impl="xla"),
            mutable=["cache"])
        return logits, vs["cache"]

    def run(tokens, positions, table, last, history=False):
        nonlocal jcache
        ref, jcache = jax_step(jcache, tokens, positions, table, last,
                               history)
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), decode_ctx=dict(
                positions=torch.from_numpy(positions),
                page_table=torch.from_numpy(table),
                last_index=torch.from_numpy(last), cache=cache,
                history=history))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        return got.argmax(-1).numpy()

    next_tok, lens = [], []
    for b, prompt in enumerate(prompts):
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, :len(prompt)] = prompt
        positions = np.arange(16, dtype=np.int32)[None]
        next_tok.append(int(run(tokens, positions, tables[b:b + 1],
                                np.asarray([len(prompt) - 1], np.int32))[0]))
        lens.append(len(prompt))
    for _ in range(6):
        tokens = np.asarray([[next_tok[0]], [next_tok[1]], [0]], np.int32)
        positions = np.asarray([[lens[0]], [lens[1]], [0]], np.int32)
        table = np.concatenate([tables, np.zeros((1, W), np.int32)])
        out = run(tokens, positions, table, np.zeros(3, np.int32))
        next_tok = [int(out[0]), int(out[1])]
        lens = [lens[0] + 1, lens[1] + 1]
    # Three more tokens of request 1 in one window on a fresh page: they
    # attend to the 12 cached tokens before them through the page table.
    tables[1, lens[1] // ps] = 11
    window = np.asarray([[next_tok[1], 17, 29]], np.int32)
    run(window, lens[1] + np.arange(3, dtype=np.int32)[None], tables[1:2],
        np.asarray([2], np.int32), history=True)


def test_bridge_raises_on_missing_or_extra_leaf(pair):
    _, params, model = pair
    missing = copy.deepcopy(params)
    del missing["block_1"]["mlp_norm"]
    with pytest.raises(KeyError, match="left unfilled"):
        bridge.flax_to_state_dict(missing, model)
    extra = copy.deepcopy(params)
    extra["block_1"]["attn"]["rotary"] = {"kernel": np.zeros((4, 4))}
    with pytest.raises(KeyError, match="no counterpart"):
        bridge.flax_to_state_dict(extra, model)
    wrong = copy.deepcopy(params)
    wrong["embed"]["embedding"] = np.zeros((3, 128), np.float32)
    with pytest.raises(ValueError, match="shape"):
        bridge.flax_to_state_dict(wrong, model)


def test_registry_names():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        registry.create_model("resnet50")
    with pytest.raises(ValueError, match="unknown model"):
        registry.create_model("nope")
    m = registry.create_model("llama_tiny", dtype=torch.float32,
                              device="cpu", seed=3)
    assert m.max_seq_len == 1024 and m.head_dim == 32
