"""The port on the trained iPCRNet, PRNet and PCN releases, on the CPU: each
restored through the JAX ``Trainer.load`` (a tmp directory whose ``best``
links to the release, so nothing is written under ``releases/``), copied
with ``load_nnx_state`` and held to the JAX package's jitted forward on a
few synthetic test-split pairs.

- ``r4b_ipcrnet`` and ``r5b_ipcrnet``: iPCRNet(PointNet(1024)) (no
  BatchNorm, as ``examples/train.py`` builds it without --use_bn) in f32,
  its 8 refinement steps, at B=4, N=256.
- ``r4_prnet``: PRNet() (PRDGCNN(512, k=20), the transformer pointer, 3
  iterations) at a 192-point template and a 144-point partial source with
  96 keypoints: the keypoint and subsample counts are no weights, and below
  256 points both packages' attention computes in f32 on the CPU (at 256
  and more the port's takes K6's plain version, bf16 operands, as the JAX
  package's TPU kernel does).
- ``r4_pcn`` and ``r5_pcn_detailed``: PCN(1024, num_coarse=1024), the coarse
  output and, detailed, the 16,384 fine points, at B=4, N=256.

The tests skip only when the release is absent.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu import models as jmodels
from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu_torch.examples.train import build_model
from learning3d_tpu_torch.models import PRNet
from learning3d_tpu_torch.train.metrics import registration_errors
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from test_torch_trained import release_files, restore
from torch_port_util import max_rel, nnx_flat

B, N = 4, 256
ARGS = SimpleNamespace(emb_dims=1024, nearest_neighbors=20, seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def pairs(algorithm, n=N, b=B):
    """b test-split (template, source, igt) pairs of ``algorithm``'s
    transform distribution at n points."""
    data = jdata.RegistrationData(algorithm, jdata.SyntheticModelNet40(train=False, num_points=n, size=b))
    return tuple(np.stack([data[i][j] for i in range(b)]) for j in range(3))


def gaps(got, want, keys):
    return {key: max_rel(got[key], want[key]) for key in keys}


def jax_call(module, *args):
    return jax.tree.map(np.asarray, nnx.jit(lambda m, *a: m(*a))(module, *(jnp.asarray(a) for a in args)))


# iPCRNet's est_T and transformed_source after its 8 steps, each to IPC_TOL
# of its largest value (measured on these pairs: r4b 2.4e-6, r5b 9.8e-7;
# each step feeds the next, no selection in the loop)
IPC_TOL = 2e-5


@pytest.mark.parametrize("name", ["r4b_ipcrnet", "r5b_ipcrnet"])
def test_trained_ipcrnet_matches_jax(tmp_path, name):
    before = release_files(name)
    jm = restore(tmp_path, name, "ipcrnet", jmodels.iPCRNet(jmodels.PointNet(emb_dims=1024, use_bn=False,
                                                                               rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0)))
    jm.eval()
    t, s, igt = pairs("iPCRNet")
    want = jax_call(jm, t, s)
    tm = load_nnx_state(build_model("ipcrnet", ARGS, None, "cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s))
    measured = gaps(got, want, ("est_T", "transformed_source"))
    assert max(measured.values()) <= IPC_TOL, measured
    err = registration_errors(got["est_T"], torch.from_numpy(igt))
    assert torch.isfinite(err["rot_deg"]).all()
    assert release_files(name) == before


# PRNet's est_T (and its parts) and the transformed source after
# 3 iterations, each to PRNET_TOL of its largest value (measured 5.9e-6, est_R)
PRNET_TOL = 5e-5
PRNET_NT, PRNET_NS, PRNET_KP = 192, 144, 96


def test_trained_prnet_matches_jax(tmp_path):
    before = release_files("r4_prnet")
    jm = restore(tmp_path, "r4_prnet", "prnet", jmodels.PRNet(num_keypoints=PRNET_KP,
                                                               num_subsampled_points=PRNET_NS, rngs=nnx.Rngs(0)))
    jm.eval()
    t, s, igt = pairs("PRNet", n=PRNET_NT, b=2)
    rng = np.random.default_rng(0)
    src = np.stack([jdata.farthest_subsample_points(x, PRNET_NS, rng=rng)[0] for x in s]).astype(np.float32)
    want = jax_call(jm, src, t)  # PRNet's argument order: source, template
    tm = load_nnx_state(PRNet(num_keypoints=PRNET_KP, num_subsampled_points=PRNET_NS, device="cpu"),
                        nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(t))
    measured = gaps(got, want, ("est_T", "est_R", "est_t", "transformed_source"))
    assert max(measured.values()) <= PRNET_TOL, measured
    assert release_files("r4_prnet") == before


# PCN's coarse (and, detailed, fine) points to PCN_TOL of their largest
# value (measured 3.7e-7 coarse, 4.8e-7 fine)
PCN_TOL = 1e-5


@pytest.mark.parametrize("name,detailed", [("r4_pcn", False), ("r5_pcn_detailed", True)])
def test_trained_pcn_matches_jax(tmp_path, name, detailed):
    before = release_files(name)
    jm = restore(tmp_path, name, "pcn", jmodels.PCN(emb_dims=1024, detailed_output=detailed, rngs=nnx.Rngs(0)))
    jm.eval()
    x = np.stack([jdata.SyntheticModelNet40(train=False, num_points=N, size=B)[i][0] for i in range(B)])
    x = x.astype(np.float32)
    want = jax_call(jm, x)
    tm = load_nnx_state(build_model("pcn", SimpleNamespace(**vars(ARGS), pcn_detailed=detailed), None, "cpu"),
                        nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    measured = gaps(got, want, ("coarse_output", "fine_output") if detailed else ("coarse_output",))
    assert max(measured.values()) <= PCN_TOL, measured
    assert release_files(name) == before
