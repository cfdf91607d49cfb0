"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: weights move as numpy arrays under nnx's dotted paths, inputs are
made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx


def nnx_flat(module):
    """The JAX side of the weight transfer: dotted nnx paths -> numpy."""
    return {
        ".".join(map(str, path)): np.asarray(v.get_value())
        for path, v in nnx.to_flat_state(nnx.state(module))
        if "rngs" not in path
    }


def randomize_bn(module, rng):
    """Non-trivial BatchNorm running statistics and affine, with some
    negative scales (so the min branch of a fused BN-ReLU-max pool is taken
    too)."""
    for path, v in nnx.to_flat_state(nnx.state(module)):
        shape = v.get_value().shape
        if path[-1] == "mean":
            v.set_value(jnp.asarray(rng.normal(0.0, 0.3, shape), jnp.float32))
        elif path[-1] == "var":
            v.set_value(jnp.asarray(rng.uniform(0.5, 2.0, shape), jnp.float32))
        elif path[-1] == "scale":
            sign = rng.choice([-1.0, 1.0], shape, p=[0.2, 0.8])
            v.set_value(jnp.asarray(sign * rng.uniform(0.5, 1.5, shape), jnp.float32))


def cloud(b, n, seed=1):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def lattice_cloud(b, n, seed=1):
    """Points of an integer lattice scaled by 0.25 (exact in f32) in a
    random order, so that exact distance ties decide which neighbors are
    kept."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.stack([0.25 * grid[rng.permutation(len(grid))[:n]] for _ in range(b)]).astype(np.float32)


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def as_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]
