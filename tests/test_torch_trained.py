"""The port on trained weights, on the CPU: the checkpoints of
``releases/`` restored through the JAX ``Trainer.load`` (as
``releases/README.md`` shows), flattened with ``nnx.to_flat_state`` and
copied with ``load_nnx_state``, then held to the JAX package on a few
synthetic pairs at the trained width (emb 1024) and N <= 256.

- ``r4_pnlk``: PointNetLK's est_T, est_T_series and r.
- ``r4b_masknet``: MaskNet's mask and its picks, whose trained sigmoid
  saturates to exactly 1.0 on many points (the tie order).
- ``r4b_curvenet`` and ``r5b_curvenet_hard``: CurveNet's logits at B=1,
  N=1024 (its architecture's npoints), the argmax equal; one JAX CurveNet
  is built for both and its forward jitted.
- ``r5b_dgcnn_hard``: Classifier(DGCNN(1024))'s logits at N=256.

The restoring Trainer writes its run.log and tb/ into a fresh directory
under pytest's tmp_path whose ``best`` entry links to the release, so
nothing is written under ``releases/``. The tests skip only when the
release is absent.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu import models as jmodels
from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.train import TrainConfig as JTrainConfig
from learning3d_tpu.train import Trainer as JTrainer
from learning3d_tpu_torch.models import DGCNN, Classifier, CurveNet, MaskNet, PointNet, PointNetLK
from learning3d_tpu_torch.models.masknet import top_indices
from learning3d_tpu_torch.train.metrics import registration_errors
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import nnx_flat

RELEASES = Path(__file__).resolve().parents[1] / "releases"
EMB, N, NS, B = 1024, 256, 192, 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def restore(tmp_path, name, task, model):
    """``model`` with the release's ``best`` weights, through the JAX
    Trainer pointed at tmp_path/name (a real directory whose ``best`` links
    to the release)."""
    if not (RELEASES / name / "best").is_dir():
        pytest.skip(f"releases/{name} is absent")
    (tmp_path / name).mkdir()
    os.symlink(RELEASES / name / "best", tmp_path / name / "best")
    JTrainer(JTrainConfig(exp_name=name, task=task, ckpt_dir=str(tmp_path)), model,
             loss_fn=lambda *a: (0.0, {})).load("best")
    return model


def pairs():
    """B test-split template/source pairs of PointNetLK's twist
    distribution at N points."""
    data = jdata.RegistrationData("PointNetLK", jdata.SyntheticModelNet40(train=False, num_points=N, size=B))
    items = [data[i] for i in range(B)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# Measured on these pairs: est_T 2.4e-7 of max, est_T_series 1.8e-6; r is
# the residual at convergence (~1e-6 against O(1) features), so it is held
# absolutely, to 1e-5 of the template feature's largest entry
PNLK_TOL, PNLK_R_TOL = 1e-5, 1e-5


def test_trained_pointnetlk_matches_jax(tmp_path):
    jm = restore(tmp_path, "r4_pnlk", "pointnetlk",
                 jmodels.PointNetLK(jmodels.PointNet(emb_dims=EMB, use_bn=True, rngs=nnx.Rngs(0))))
    jm.eval()
    t, s, igt = pairs()
    want = jax.tree.map(np.asarray, nnx.jit(lambda m, a, b: m(a, b))(jm, jnp.asarray(t), jnp.asarray(s)))
    tm = load_nnx_state(PointNetLK(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), device="cpu"),
                        nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(t), torch.from_numpy(s))
        f0 = tm._embed(torch.from_numpy(t))
    for key in ("est_T", "est_R", "est_t", "est_T_series", "transformed_source"):
        assert rel(got[key], want[key]) <= PNLK_TOL, key
    assert np.abs(got["r"].numpy() - want["r"]).max() <= PNLK_R_TOL * f0.abs().max().item()
    # the trained model registers these pairs (the release's eval: 0.73
    # degrees on average)
    err = registration_errors(got["est_T"], torch.from_numpy(igt))
    assert err["rot_deg"].max().item() < 1.0 and err["trans"].max().item() < 1e-2
    assert not (RELEASES / "r4_pnlk" / "run.log").exists()


# Measured on these pairs: the masks 7.2e-7 apart at most, with 0 to 96
# scores of a row exactly 1.0 on both sides
MASK_TOL = 1e-5


def test_trained_masknet_matches_jax(tmp_path):
    """The mask to MASK_TOL; the same scores exactly 1.0; the picks (the
    top NS of the 256 template points) JAX's, index for index, wherever
    JAX's sorted score at that place lies more than 2 MASK_TOL from its
    neighbours (two scores closer than the two sides' rounding may swap),
    and the saturated ties always, in lax.top_k's order. On JAX's own
    scores the port's selection is lax.top_k's exactly."""
    jm = restore(tmp_path, "r4b_masknet", "masknet",
                 jmodels.MaskNet(jmodels.PointNet(emb_dims=EMB, use_bn=True, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1)))
    jm.eval()
    t, s, _ = pairs()
    rng = np.random.default_rng(0)
    src = np.stack([jdata.farthest_subsample_points(x, NS, rng=rng)[0] for x in s]).astype(np.float32)
    want_t, want_m = jax.tree.map(np.asarray,
                                  nnx.jit(lambda m, a, b: m(a, b))(jm, jnp.asarray(t), jnp.asarray(src)))
    tm = load_nnx_state(MaskNet(PointNet(emb_dims=EMB, use_bn=True, device="cpu"), device="cpu"),
                        nnx_flat(jm)).eval()
    with torch.no_grad():
        got_t, got_m = tm(torch.from_numpy(t), torch.from_numpy(src))
    assert np.abs(got_m.numpy() - want_m).max() <= MASK_TOL
    ones = (want_m == 1.0).sum(-1)
    assert ones.max() > 1
    np.testing.assert_array_equal((got_m.numpy() == 1.0).sum(-1), ones)
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(want_m), NS)[1])
    np.testing.assert_array_equal(top_indices(torch.from_numpy(want_m), NS).numpy(), want_idx)
    got_idx = top_indices(got_m, NS).numpy()
    np.testing.assert_array_equal(got_t.numpy(), np.take_along_axis(t, got_idx[..., None], 1))
    sorted_m = np.take_along_axis(want_m, np.asarray(jax.lax.top_k(jnp.asarray(want_m), N)[1]), 1)
    gap = np.minimum(np.abs(np.diff(sorted_m, prepend=np.inf)), np.abs(np.diff(sorted_m, append=-np.inf)))[:, :NS]
    firm = (gap > 2 * MASK_TOL) | (np.arange(NS)[None] < ones[:, None])
    assert firm.mean() > 0.5  # measured 0.755: the unsaturated scores near 1 crowd within 2e-5
    np.testing.assert_array_equal(got_idx[firm], want_idx[firm])
    assert not (RELEASES / "r4b_masknet" / "run.log").exists()


@pytest.fixture(scope="module")
def jax_curvenet():
    """One JAX CurveNet (k 20, the default curves) that each CurveNet
    release is restored into."""
    return jmodels.CurveNet(rngs=nnx.Rngs(0))


def classification_clouds(n, b, hard):
    """b test-split SyntheticModelNet40 clouds of n points (the hard set
    for the r5b releases, as trained) and their labels."""
    data = jdata.SyntheticModelNet40(train=False, num_points=n, size=b, hard=hard)
    return (np.stack([data[i][0] for i in range(b)]).astype(np.float32),
            np.array([data[i][1] for i in range(b)]).reshape(b))


def release_files(name):
    """(path, size, mtime) of every file of a release (these releases hold
    a run.log of their own): the restore writes none of them."""
    return sorted((str(p), p.stat().st_size, p.stat().st_mtime_ns) for p in (RELEASES / name).rglob("*") if p.is_file())


# CurveNet's trained logits at B=1, N=1024 (eval mode; its walk's picks
# agree or the logits would part), to CURVE_TOL of max; the argmax equal
CURVE_TOL = 1e-4


@pytest.mark.parametrize("name,hard", [("r4b_curvenet", False), ("r5b_curvenet_hard", True)])
def test_trained_curvenet_matches_jax(tmp_path, jax_curvenet, name, hard):
    before = release_files(name)
    jm = restore(tmp_path, name, "classification", jax_curvenet)
    jm.eval()
    x, _ = classification_clouds(1024, 1, hard)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x)))
    tm = load_nnx_state(CurveNet(device="cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel(got, want) <= CURVE_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert release_files(name) == before


# Classifier(DGCNN(1024))'s trained logits at N=256 in f32 eval mode, to
# DGCNN_TOL of max; the argmax equal
DGCNN_TOL = 1e-5


def test_trained_dgcnn_classifier_matches_jax(tmp_path):
    before = release_files("r5b_dgcnn_hard")
    jm = restore(tmp_path, "r5b_dgcnn_hard", "classification",
                 jmodels.Classifier(jmodels.DGCNN(emb_dims=EMB, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1)))
    jm.eval()
    x, _ = classification_clouds(N, B, True)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x)))
    tm = load_nnx_state(Classifier(DGCNN(emb_dims=EMB, device="cpu"), device="cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel(got, want) <= DGCNN_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert release_files("r5b_dgcnn_hard") == before
