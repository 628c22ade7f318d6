"""Flax `variables` -> PyTorch `state_dict` for `MetroModel`, and a JAX
`TrainState` -> the port's train state.

The flax tree `{"params": ..., "batch_stats": ..., "quant": ...}` maps by
name: a module path `backbone/stage1_block1/conv1` becomes
`backbone.stage1_block1.conv1`. Leaves: conv `kernel` HWIO -> `weight` OIHW;
conv and BN `bias` and BN `scale` as they are (params); BN `mean`/`var` as
they are (batch_stats); each int8 conv's `amax` a scalar buffer (quant, the
calibrated input scales of `models/quantize.py`).
Arrays are read through numpy, so jax is not imported here.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_flax(variables) -> dict:
    """Convert a flax MetroModel `variables` tree to float32 CPU tensors."""
    out = {}
    for collection in ("params", "batch_stats", "quant"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.array(leaf, np.float32)  # a writable copy
            *module, name = path
            if name == "kernel":
                arr, name = arr.transpose(3, 2, 0, 1), "weight"  # HWIO -> OIHW
            elif collection == "quant":
                arr = arr.reshape(())  # a calibrated amax may carry a unit axis
            # (ascontiguousarray makes a 0-d array 1-d)
            out[".".join((*module, name))] = torch.from_numpy(
                np.ascontiguousarray(arr)).reshape(arr.shape)
    return out


def load_flax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted flax weights into `model` (every name must match)."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _param_tensors(tree) -> dict:
    """A params-shaped tree (params, or Adam's mu / nu) -> {torch name: tensor}."""
    return state_dict_from_flax({"params": tree})


def _adam_state(opt_state):
    """The optax `ScaleByAdamState` (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_flax(state) -> dict:
    """A JAX `TrainState` (step, params, batch_stats, opt_state of
    `optax.chain(clip_by_global_norm, adam)`), its leaves readable as numpy
    -> `train.state.TrainState.state_dict()`'s layout: {"step": int,
    "model": state dict, "adam": {param name: {"step", "exp_avg",
    "exp_avg_sq"}}}. Adam's mu and nu map to exp_avg and exp_avg_sq, its
    update count to each parameter's step."""
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu) in the JAX optimizer state")
    count = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu, nu = _param_tensors(adam.mu), _param_tensors(adam.nu)
    model = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
    return {"step": int(np.asarray(state.step)), "model": model,
            "adam": {name: {"step": count.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                     for name in mu}}
