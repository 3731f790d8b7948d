"""Weights carried across: a flax Llama params tree -> the port's state_dict.

The JAX package stores a Llama's parameters as a nested dict (leaves as
numpy arrays here) in flax layouts; this turns one into the ``state_dict``
of :class:`models.llama.Llama`, so both packages compute the same function
on the same weights. It inverts the layouts of the JAX package's
``models/import_hf.py`` (without importing it):

- ``embed/embedding [V, d]``            -> ``embed.weight``, as is
- ``attn/{query,key,value}/kernel [d, H, D]`` -> Linear weight ``[H*D, d]``
- ``attn/out/kernel [H, D, d]``         -> Linear weight ``[d, H*D]``
- ``gate|up|down/kernel [in, out]``     -> Linear weight ``[out, in]``
- ``*_norm/scale [d]``                  -> norm ``weight``
- ``lm_head/kernel [d, V]``             -> ``lm_head.weight [V, d]``

Any leaf that cannot be placed raises, and so does any port parameter left
unfilled.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def _place(path: tuple[str, ...], leaf: np.ndarray) -> tuple[str, np.ndarray]:
    """(state_dict key, array in the port's layout) for one flax leaf."""
    *mods, kind = path
    if kind == "embedding":
        return ".".join(mods) + ".weight", leaf
    if kind == "scale":
        return ".".join(mods) + ".weight", leaf
    if kind != "kernel":
        raise KeyError(f"cannot place leaf {'/'.join(path)}")
    name = mods[-1]
    if name in ("query", "key", "value"):       # [d, H, D] -> [H*D, d]
        d = leaf.shape[0]
        out = leaf.reshape(d, -1).T
    elif name == "out" and leaf.ndim == 3:      # [H, D, d] -> [d, H*D]
        out = leaf.reshape(-1, leaf.shape[-1]).T
    elif leaf.ndim == 2:                        # Dense [in, out] -> [out, in]
        out = leaf.T
    else:
        raise KeyError(f"cannot place leaf {'/'.join(path)} of shape "
                       f"{leaf.shape}")
    return ".".join(mods) + ".weight", out


def flax_to_state_dict(params, model: torch.nn.Module) -> dict:
    """The ``state_dict`` for ``model`` built from flax ``params`` (a nested
    dict of numpy arrays), in the model's parameter dtype."""
    expected = model.state_dict()
    out = {}
    for path, leaf in _flatten(params):
        key, arr = _place(path, np.asarray(leaf))
        if key not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart "
                           f"{key!r} in the port's model")
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{'/'.join(path)} -> {key}: shape "
                             f"{tuple(arr.shape)} != port's "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32)).to(
            expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters left unfilled by the flax tree: "
                       f"{missing}")
    return out


def load_flax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy flax ``params`` into ``model`` (on whatever device it lives)."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model
