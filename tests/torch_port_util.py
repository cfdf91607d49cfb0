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


def quant_pointnet_arrays(qm):
    """The arrays of a JAX QuantPointNetClassifier pytree, as numpy, in the
    layout ``learning3d_tpu_torch.utils.jax_import.load_quant_pointnet``
    takes."""
    def layer(q):
        return {"w_q": np.asarray(q.w_q), "s_w": np.asarray(q.s_w), "b": np.asarray(q.b), "s_x": np.asarray(q.s_x)}

    return {"w1": np.asarray(qm.w1), "b1": np.asarray(qm.b1), "enc": [layer(q) for q in qm.enc],
            "head": [layer(q) for q in qm.head], "w_out": np.asarray(qm.w_out), "b_out": np.asarray(qm.b_out)}


def quant_block_scales(block):
    """The Python-float scales of a JAX QuantMHA or QuantFF (they live
    outside its nnx state)."""
    from learning3d_tpu_torch.quant import FF_SCALES, MHA_SCALES

    names = MHA_SCALES if hasattr(block, "s_in_q") else FF_SCALES
    return {n: getattr(block, n) for n in names}


def quant_dcp_scales(jclone):
    """{dotted block path: its scales} for every int8 block of a JAX
    quantize_dcp clone with fused_layers=False."""
    out = {}
    for side in ("enc_layers", "dec_layers"):
        for i, layer in enumerate(getattr(jclone.pointer, side)):
            for attr in ("self_attn", "cross_attn", "ff"):
                if hasattr(layer, attr):
                    out[f"pointer.{side}.{i}.{attr}"] = quant_block_scales(getattr(layer, attr))
    return out


def assert_tie_flip_profile(got, want, steps=3e-2):
    """The int8 tie-flip profile: all but < 1% of the elements within f32
    rounding (1e-5 of max|want|), none further than ``steps`` of max|want|
    (a few int8 quant steps)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert (diff > 1e-5 * scale).mean() < 0.01, (diff > 1e-5 * scale).mean()
    assert diff.max() <= steps * scale, diff.max() / scale
