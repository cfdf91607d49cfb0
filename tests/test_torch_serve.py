"""The port's ``serve.TemplateRegistrar`` against the JAX package's, on the
CPU at a small size: DCP(DGCNN(64, k=5)) in f32 with numpy-seeded weights
carried across, 3 sources at batch 2 (a full chunk and a padded tail).

Tolerance: f32 on both sides, the unfused encoder, the pointer and the SVD
head summing in other orders: 1e-4 of each key's largest value (2e-3 for the
rotation-derived keys, whose 3x3 SVD amplifies the features' rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.models import DCP as JDCP
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.serve import InferenceEngine as JInferenceEngine
from learning3d_tpu.serve import TemplateRegistrar as JTemplateRegistrar
from learning3d_tpu_torch import quant as tquant
from learning3d_tpu_torch.models import DCP, DGCNN
from learning3d_tpu_torch.serve import InferenceEngine, TemplateRegistrar
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import cloud, nnx_flat, randomize_bn, rel_err

EMB, K, NPTS = 64, 5, 64
KEYS = ("est_R", "est_t", "est_R_", "est_t_", "est_T", "r", "transformed_source")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jm = JDCP(JDGCNN(emb_dims=EMB, k=K, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1))
    randomize_bn(jm, np.random.default_rng(0))
    jm.eval()
    tm = load_nnx_state(DCP(DGCNN(emb_dims=EMB, k=K, device="cpu"), device="cpu"), nnx_flat(jm)).eval()
    return jm, tm


def test_template_registrar_matches_jax(models):
    jm, tm = models
    template, sources = cloud(1, NPTS, seed=100)[0], cloud(3, NPTS, seed=101)
    want = JTemplateRegistrar(jm, template, batch_size=2)(sources)
    got = TemplateRegistrar(tm, template, batch_size=2, device="cpu")(sources)
    assert set(got) == set(KEYS)
    for key in KEYS:
        assert got[key].shape == np.asarray(want[key]).shape, key
        assert rel_err(got[key], want[key]) <= (1e-4 if key in ("r",) else 2e-3), key


def test_template_registrar_equals_the_full_forward(models):
    """Caching the template's features changes nothing: each key equals
    InferenceEngine's forward on the template repeated beside each source."""
    _, tm = models
    template, sources = cloud(1, NPTS, seed=102)[0], cloud(3, NPTS, seed=103)
    got = TemplateRegistrar(tm, template[None], batch_size=2, device="cpu")(sources)
    want = InferenceEngine(tm, batch_size=2, device="cpu")(np.repeat(template[None], 3, axis=0), sources)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


def test_template_registrar_serves_the_int8_clone(models):
    """The int8 clone (fused_layers=True; off K11's gate at this width, so
    the blocks compose) through TemplateRegistrar: each key equals
    register_encoded on the same padded chunks."""
    _, tm = models
    calib = torch.from_numpy(cloud(2, NPTS, seed=104)), torch.from_numpy(cloud(2, NPTS, seed=105))
    q = tquant.quantize_dcp(tm, *calib, int8_pv=False, fused_layers=True)
    template, sources = cloud(1, NPTS, seed=106), cloud(3, NPTS, seed=107)
    got = TemplateRegistrar(q, template, batch_size=2, device="cpu")(sources)
    t = torch.from_numpy(template)
    padded = torch.from_numpy(np.concatenate([sources, np.zeros_like(sources[:1])]))
    with torch.inference_mode():
        temb = q.encode(t)
        chunks = [q.register_encoded(t.expand(2, -1, -1), temb.expand(2, -1, -1), padded[i:i + 2]) for i in (0, 2)]
    for key in KEYS:
        np.testing.assert_array_equal(got[key], torch.cat([c[key] for c in chunks])[:3].float().numpy())


def test_template_must_be_one_cloud(models):
    _, tm = models
    with pytest.raises(ValueError, match="one"):
        TemplateRegistrar(tm, cloud(2, NPTS), device="cpu")


# -- outputs of any nesting (tuples, lists, dicts), against the JAX engine --

class JTupleOut(nnx.Module):
    """The reproduction of the engine fault: a tuple of two arrays."""

    def __call__(self, t, s):
        return t[..., 0] * 2, s.sum(-1)


class TTupleOut(torch.nn.Module):
    def forward(self, t, s):
        return t[..., 0] * 2, s.sum(-1)


class JNestedOut(nnx.Module):
    def __call__(self, t, s):
        return {"pair": (t.mean(1), [s[:, :2], None]), "sum": t.sum((1, 2))}

    def encode(self, t):
        return t * 3

    def register_encoded(self, template, temb, source):
        return ((source - template).sum(-1), {"emb": temb[:, :2], "src": [source.max(1)]})


class TNestedOut(torch.nn.Module):
    def forward(self, t, s):
        return {"pair": (t.mean(1), [s[:, :2], None]), "sum": t.sum((1, 2))}

    def encode(self, t):
        return t * 3

    def register_encoded(self, template, temb, source):
        return ((source - template).sum(-1), {"emb": temb[:, :2], "src": [source.amax(1)]})


def assert_same_tree(got, want):
    """The same containers (type for type) and leaves equal to f32 rounding
    (both sides sum a few f32 values, in another order)."""
    assert type(got) is type(want), (type(got), type(want))
    if want is None:
        return
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            assert_same_tree(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["tuple", "nested"])
def test_engine_maps_over_nested_outputs(case):
    """n=6 at batch_size=4 (a full chunk and a padded tail): the port's
    engine returns the JAX engine's containers with the same arrays; the
    tuple case raised AttributeError before the repair."""
    jm, tm = (JTupleOut(), TTupleOut()) if case == "tuple" else (JNestedOut(), TNestedOut())
    t, s = cloud(6, 8, seed=110), cloud(6, 8, seed=111)
    want = JInferenceEngine(jm, batch_size=4)(t, s)
    got = InferenceEngine(tm, batch_size=4, device="cpu")(t, s)
    assert_same_tree(got, jax.tree.map(np.asarray, want))
    one = InferenceEngine(tm, batch_size=8, device="cpu")(t, s)  # one padded chunk
    assert_same_tree(one, got)
    if case == "nested":
        np.testing.assert_allclose(InferenceEngine(tm, batch_size=4, output_key="sum", device="cpu")(t, s),
                                   np.asarray(want["sum"]), rtol=1e-6, atol=1e-6)


def test_template_registrar_maps_over_nested_outputs():
    """TemplateRegistrar on a model whose register_encoded returns a tuple
    holding a dict and a list: 6 sources at batch_size=4, against the JAX
    TemplateRegistrar."""
    template, sources = cloud(1, 8, seed=112)[0], cloud(6, 8, seed=113)
    want = JTemplateRegistrar(JNestedOut(), template, batch_size=4)(sources)
    got = TemplateRegistrar(TNestedOut(), template, batch_size=4, device="cpu")(sources)
    assert_same_tree(got, jax.tree.map(np.asarray, want))
