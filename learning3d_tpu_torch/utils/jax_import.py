"""Carry weights across from the JAX package.

``load_nnx_state(model, flat)`` takes the flattened nnx state of the JAX
twin as numpy arrays, keyed by the dotted ``nnx.to_flat_state`` paths
(``{"feature_model.convs.0.kernel": ndarray, ...}``), and copies it into
the port's module of the same structure. The flattening itself happens on
the JAX side (the tests do it); this module never imports JAX.

Mapping (the port keeps torch's orientation for Linear):
    Linear    kernel (in, out)  -> weight (out, in), transposed
              bias              -> bias
    BatchNorm scale / bias      -> weight / bias
              mean / var        -> running_mean / running_var
Entries under ``rngs`` (dropout keys and counters) are skipped.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def nnx_to_torch(flat) -> dict[str, np.ndarray]:
    """Rename and re-orient a flat nnx state into torch state_dict keys."""
    out = {}
    for key, value in flat.items():
        parts = key.split(".")
        if "rngs" in parts:
            continue
        value = np.asarray(value)
        leaf = parts[-1]
        if leaf == "kernel":
            if value.ndim != 2:
                raise ValueError(f"{key}: expected a 2-D Linear kernel, got {value.shape}")
            parts[-1], value = "weight", value.T
        else:
            parts[-1] = _RENAME.get(leaf, leaf)
        out[".".join(parts)] = value
    return out


def load_nnx_state(model: torch.nn.Module, flat) -> torch.nn.Module:
    """Copy a flat nnx state into ``model`` in place. Raises KeyError on a
    tensor missing from either side and ValueError on a shape mismatch."""
    src = nnx_to_torch(flat)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    unexpected = sorted(set(src) - set(dst))
    if missing or unexpected:
        raise KeyError(f"missing from the nnx state: {missing}; not in the model: {unexpected}")
    for key, target in dst.items():
        if tuple(src[key].shape) != tuple(target.shape):
            raise ValueError(f"{key}: nnx shape {src[key].shape} vs model {tuple(target.shape)}")
    with torch.no_grad():
        for key, target in dst.items():
            target.copy_(torch.from_numpy(np.array(src[key], copy=True)).to(target.dtype))
    return model
