"""Model registry of the port: name -> constructed, initialised model.

Counterpart of ``pytorch_distributed_training_example_tpu/models/
registry.py`` for the models this slice serves: ``llama3_8b``,
``llama_400m`` and ``llama_tiny``. Every other name of the JAX registry
raises "not yet ported".
"""

from __future__ import annotations

import torch

from pytorch_distributed_training_example_tpu_torch.models import llama

_BUILDERS = {
    "llama3_8b": (llama.llama3_8b, 8192),
    "llama_400m": (llama.llama_400m, 2048),
    "llama_tiny": (llama.llama_tiny, 256),
}

#: Names the JAX registry knows that the port does not serve yet.
NOT_YET_PORTED = ("gpt2", "gpt2_tiny", "llama_moe", "llama_moe_tiny",
                  "vit_b16", "vit_tiny", "vit_l16", "resnet_micro",
                  "resnet18", "resnet34", "resnet50", "resnet101",
                  "resnet152")


def list_models() -> list[str]:
    return sorted(_BUILDERS)


def create_model(name: str, *, seq_len: int = 1024, dtype=torch.bfloat16,
                 attn_impl: str = "auto", device="cuda",
                 seed: int | None = 0, num_layers: int | None = None
                 ) -> llama.Llama:
    """Build ``name`` directly on ``device`` (the card unless the caller
    asks for the CPU) and initialise it from ``seed``
    (``seed=None`` leaves the storage uninitialised, for a caller that loads
    a state dict next). The parameters are allocated once, on the device,
    with no default init pass. ``num_layers`` cuts depth (smoke runs); the
    widths are always the preset's."""
    if name not in _BUILDERS:
        if name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"model {name!r} is not yet ported to PyTorch; have "
                f"{list_models()}")
        raise ValueError(f"unknown model {name!r}; have {list_models()}")
    builder, min_len = _BUILDERS[name]
    kw = dict(max_seq_len=max(seq_len, min_len), dtype=dtype,
              attn_impl=attn_impl, device="meta")
    if num_layers is not None:
        kw["num_layers"] = num_layers
    model = builder(**kw).to_empty(device=device)
    if seed is not None:
        model.init_weights(seed)
    return model.eval()
