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
- ``r3c_deepgmr``: DeepGMR(use_rri=True, nearest_neighbors=20)'s est_T
  (and the rest of its outputs) on jittered DeepGMR pairs at N=256.
- ``r4b_pointnet_cls`` and ``r5b_pointnet_hard``: the same classifier's f32
  logits on clouds of the set each was trained on; ``r5c_pointnet_hard``
  (its manifest eval UNVERIFIED) for weight parity only.
- ``r4_pointnet_cls``: Classifier(PointNet(1024))'s logits in f32 and
  int8 (the port's ``quantize_pointnet_classifier`` against JAX's); the
  port checkpoint committed under ``learning3d_tpu_torch/trained`` equal to
  the release, tensor for tensor, and its ``reference_predictions.npz``
  equal to JAX's predictions on the first clouds of the eval set.
- ``r3c_dcp``: DCP(DGCNN(512))'s result dict in f32 at N=128 (below the
  attention kernel's gate, where both packages compute in f32 on the CPU),
  and its int8 pointer at N=256, where K11's plain version runs: the JAX
  clone's state carried over, held to the layers' tie-flip profile; the
  port's own ``quantize_dcp`` within the int8 slice's tolerances.

The eval set of the trained classifier's card check (SyntheticModelNet40,
test split, 2048 clouds of 1024 points, batches of 32 in order) is checked
item for item against the JAX package's, and its labels against the stored
predictions', without the releases.

The restoring Trainer writes its run.log and tb/ into a fresh directory
under pytest's tmp_path whose ``best`` entry links to the release, so
nothing is written under ``releases/``. The tests skip only when the
release is absent.
"""

import json
import os
from pathlib import Path
from types import SimpleNamespace

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
from learning3d_tpu_torch import quant as tquant
from learning3d_tpu_torch.examples.train import build_model
from learning3d_tpu_torch.models import DGCNN, Classifier, CurveNet, DeepGMR, MaskNet, PointNet, PointNetLK
from learning3d_tpu_torch.models.masknet import top_indices
from learning3d_tpu_torch.train.metrics import registration_errors
from learning3d_tpu_torch.train import TrainConfig, Trainer
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, load_quant_dcp, nnx_to_torch
from torch_port_util import assert_tie_flip_profile, nnx_flat, quant_dcp_scales, rel_err

ROOT = Path(__file__).resolve().parents[1]
RELEASES = ROOT / "releases"
TRAINED = ROOT / "learning3d_tpu_torch" / "trained"
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


# Measured on these pairs: with the same RRI features on both sides (JAX's,
# appended to the clouds) the poses lie 6.3e-6 of max apart; with each side
# computing its own in the forward, the features' rounding (angles 1.4e-5
# apart, arccos and atan2 of the two libraries) is carried by the trained
# weights to 2.7e-3 of est_T's max
GMR_TOL, GMR_RRI_TOL = 5e-5, 1e-2


def test_trained_deepgmr_matches_jax(tmp_path):
    """The trained DeepGMR on 4 test-split DeepGMR pairs of 256 points with
    the source jittered (a clean source is its template moved, which the
    rotation-invariant features register exactly whatever the weights): the
    poses to GMR_TOL given the same features, to GMR_RRI_TOL from the raw
    clouds. On the clean pairs (the release's evaluation) it registers to
    its reported accuracy."""
    from learning3d_tpu.ops import geometry as jgeo

    jm = restore(tmp_path, "r3c_deepgmr", "deepgmr", jmodels.DeepGMR(use_rri=True, nearest_neighbors=20,
                                                                      rngs=nnx.Rngs(0)))
    jm.eval()
    data = jdata.RegistrationData("DeepGMR", jdata.SyntheticModelNet40(train=False, num_points=N, size=B),
                                  noise=True)
    t, s, igt = (np.stack([data[i][j] for i in range(B)]) for j in range(3))
    rri = jax.jit(jgeo.get_rri, static_argnums=1)
    feats = [np.concatenate([a, np.asarray(rri(jnp.asarray(a - a.mean(1, keepdims=True)), 20))], -1) for a in (t, s)]
    tm = load_nnx_state(DeepGMR(use_rri=True, nearest_neighbors=20, device="cpu"), nnx_flat(jm)).eval()
    call = nnx.jit(lambda m, a, b: m(a, b))
    for (a, b), tol in (((t, s), GMR_RRI_TOL), (feats, GMR_TOL)):
        want = jax.tree.map(np.asarray, call(jm, jnp.asarray(a), jnp.asarray(b)))
        with torch.no_grad():
            got = tm(torch.from_numpy(a), torch.from_numpy(b))
        for key in ("est_T", "est_R", "est_t", "est_T_inverse", "transformed_source"):
            assert rel(got[key], want[key]) <= tol, key
    clean = jdata.RegistrationData("DeepGMR", jdata.SyntheticModelNet40(train=False, num_points=N, size=B))
    t, s, igt = (np.stack([clean[i][j] for i in range(B)]) for j in range(3))
    with torch.no_grad():
        err = registration_errors(tm(torch.from_numpy(t), torch.from_numpy(s))["est_T"], torch.from_numpy(igt))
    assert err["rot_deg"].max().item() < 0.5 and err["trans"].max().item() < 1e-2
    assert not (RELEASES / "r3c_deepgmr" / "run.log").exists()


# r4_pointnet_cls in f32 on 4 test clouds of 256 points: measured 5.6e-7 of
# max; int8 with both sides calibrated on these clouds: 2.2e-8 (the same
# scales, the same integers), held to the int8 tie-flip profile
CLS_TOL = 1e-5
CLS_ARGS = SimpleNamespace(emb_dims=EMB, nearest_neighbors=20, seed=0)


def jax_script_model(name):
    import importlib
    import sys

    sys.path.insert(0, str(ROOT))
    return importlib.import_module("examples.train").build_model(name, CLS_ARGS, nnx.Rngs(0))


def test_trained_pointnet_classifier_matches_jax(tmp_path):
    before = release_files("r4_pointnet_cls")
    jm = restore(tmp_path, "r4_pointnet_cls", "classification", jax_script_model("pointnet"))
    jm.eval()
    x, _ = classification_clouds(N, B, False)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x)))
    tm = load_nnx_state(build_model("pointnet", CLS_ARGS, None, "cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel(got, want) <= CLS_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    from learning3d_tpu import quant as jquant

    want_q = np.asarray(jax.jit(lambda q, a: q(a))(jquant.quantize_pointnet_classifier(jm, jnp.asarray(x)),
                                                    jnp.asarray(x)))
    qm = tquant.quantize_pointnet_classifier(tm, torch.from_numpy(x))
    with torch.no_grad():
        for fwd in (qm, tquant.make_fused_quant_forward(qm)):  # the plain chain and K2's plain version
            assert_tie_flip_profile(fwd(torch.from_numpy(x)).numpy(), want_q)
    assert release_files("r4_pointnet_cls") == before


# The other PointNet classifier releases, Classifier(PointNet(1024)) as the
# scripts build it, each on 4 test clouds of 256 points of the set it was
# trained on (its manifest's dataset_version): the f32 logits to CLS_TOL of
# max (measured 3.5e-7 and 3.0e-7), the argmax equal
PN_RELEASES = {
    "r4b_pointnet_cls": dict(param_jitter=0.08),  # synthetic-v2+jitter0.08+size6144
    "r5b_pointnet_hard": dict(param_jitter=0.08, hard=True, detail_amp=0.04, noise=0.025),  # h2+amp0.04+noise0.025
}


@pytest.mark.parametrize("name", sorted(PN_RELEASES))
def test_trained_pointnet_classifiers_match_jax(tmp_path, name):
    before = release_files(name)
    jm = restore(tmp_path, name, "classification", jax_script_model("pointnet"))
    jm.eval()
    data = jdata.SyntheticModelNet40(train=False, num_points=N, size=B, **PN_RELEASES[name])
    x = np.stack([data[i][0] for i in range(B)]).astype(np.float32)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x)))
    tm = load_nnx_state(build_model("pointnet", CLS_ARGS, None, "cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel(got, want) <= CLS_TOL, rel(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert release_files(name) == before


def test_unverified_release_carries_its_weights(tmp_path):
    """r5c_pointnet_hard, whose manifest eval is UNVERIFIED (no eval line to
    reproduce), is held for weight parity only: the port model built from
    the release holds every tensor of it, and its state dict is the
    release's."""
    before = release_files("r5c_pointnet_hard")
    jm = restore(tmp_path, "r5c_pointnet_hard", "classification", jax_script_model("pointnet"))
    assert json.loads((RELEASES / "manifest.json").read_text())["r5c_pointnet_hard"]["eval"] == "UNVERIFIED"
    want = nnx_to_torch(nnx_flat(jm))
    state = load_nnx_state(build_model("pointnet", CLS_ARGS, None, "cpu"), nnx_flat(jm)).state_dict()
    assert set(state) == set(want)
    for key, value in state.items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    assert release_files("r5c_pointnet_hard") == before


def test_committed_port_checkpoint_is_the_release(tmp_path):
    """learning3d_tpu_torch/trained/r4_pointnet_cls/best (written by
    tools/convert_release_torch.py): every tensor equal to the release's,
    the release's meta.json fields, under 4 MB, and loaded by the port's
    own Trainer (torch.load with weights_only, no JAX)."""
    best = TRAINED / "r4_pointnet_cls" / "best"
    assert sum(p.stat().st_size for p in best.iterdir()) < 4 * 2**20
    jm = restore(tmp_path, "r4_pointnet_cls", "classification", jax_script_model("pointnet"))
    want = nnx_to_torch(nnx_flat(jm))
    state = torch.load(best / "model.pt", map_location="cpu", weights_only=True)
    assert set(state) == set(want)
    for key, value in state.items():
        assert value.dtype == torch.float32, key
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    meta = json.loads((best / "meta.json").read_text())
    release_meta = json.loads((RELEASES / "r4_pointnet_cls" / "best" / "meta.json").read_text())
    assert meta == {k: release_meta[k] for k in ("epoch", "best_loss", "dataset_version")}
    assert meta["dataset_version"] == "synthetic-v2"
    (tmp_path / "port" / "r4_pointnet_cls").mkdir(parents=True)
    os.symlink(best, tmp_path / "port" / "r4_pointnet_cls" / "best")
    model = build_model("pointnet", CLS_ARGS, None, "cpu")
    trainer = Trainer(TrainConfig(exp_name="r4_pointnet_cls", ckpt_dir=str(tmp_path / "port")), model, device="cpu")
    trainer.load("best")
    assert trainer.epoch == release_meta["epoch"]
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    assert not (tmp_path / "port" / "r4_pointnet_cls" / "run.log").exists()


def eval_batches(n_batches):
    """The first batches of the release's eval set in both packages, as the
    evaluate scripts iterate it."""
    from learning3d_tpu.data.device_pipeline import batch_iterator as jbatches
    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40, batch_iterator

    jit = jbatches(jdata.ClassificationData(jdata.SyntheticModelNet40(train=False, num_points=EMB, size=2048)), 32,
                   shuffle=False, seed=0)
    tit = batch_iterator(ClassificationData(SyntheticModelNet40(train=False, num_points=EMB, size=2048)), 32,
                         shuffle=False, seed=0)
    return [next(jit) for _ in range(n_batches)], [next(tit) for _ in range(n_batches)]


def test_eval_set_is_the_same_in_both_packages():
    """Every cloud and label of the trained classifier's 2048-cloud eval set,
    in batch order, equal in both packages; the labels those of
    reference_predictions.npz (no release needed)."""
    jb, tb = eval_batches(64)
    for (jx, jy), (tx, ty) in zip(jb, tb):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    ref = np.load(TRAINED / "r4_pointnet_cls" / "best" / "reference_predictions.npz")
    np.testing.assert_array_equal(ref["labels"], np.concatenate([np.asarray(y).reshape(-1) for _, y in tb]))
    assert {k: ref[k].shape for k in ref.files} == {k: (2048,) for k in ("labels", "pred", "margin", "pred_int8")}


# The stored predictions against JAX on the first 4 clouds: the same f32
# argmax and margin (to 1e-5, the f32 logits' rounding), and the int8 argmax
# of JAX's quantization calibrated on the first batch's 32 clouds
FIRST = 4


def test_reference_predictions_are_jax_predictions(tmp_path):
    jm = restore(tmp_path, "r4_pointnet_cls", "classification", jax_script_model("pointnet"))
    jm.eval()
    x = eval_batches(1)[0][0][0]
    logits = np.asarray(nnx.jit(lambda m, a: m(a))(jm, jnp.asarray(x[:FIRST])))
    from learning3d_tpu import quant as jquant

    qm = jquant.quantize_pointnet_classifier(jm, jnp.asarray(x))
    pred_q = np.asarray(jax.jit(lambda q, a: q(a))(qm, jnp.asarray(x[:FIRST]))).argmax(-1)
    ref = np.load(TRAINED / "r4_pointnet_cls" / "best" / "reference_predictions.npz")
    np.testing.assert_array_equal(ref["pred"][:FIRST], logits.argmax(-1))
    top = np.sort(logits, -1)
    np.testing.assert_allclose(ref["margin"][:FIRST], top[:, -1] - top[:, -2], atol=1e-5)
    np.testing.assert_array_equal(ref["pred_int8"][:FIRST], pred_q)


# r3c_dcp in f32 at N=128 on 4 DCP pairs: measured 8.1e-6 of max (est_R);
# at N >= 256 the port's attention takes K6's plain version (bf16 operands,
# as the JAX package's TPU kernel) where JAX's CPU path stays f32, so f32
# parity is held below that gate
DCP_TOL, DCP_N, DCP_INT8_N = 5e-5, 128, 256
DCP_KEYS = ("est_R", "est_t", "est_R_", "est_t_", "est_T", "r", "transformed_source")
# the int8 slice's tolerances (tests/test_torch_quant_dcp.py) for the port's
# own quantization of the pointer (``quantize_dcp``'s int8 part for an f32
# encoder), whose scales come from its own calibration pass
DCP_INT8_TOL = 3e-2
# K11's tie-flip profile (tests/test_torch_transformer_int8.py), layer by
# layer on the same inputs: under 1% of a layer's outputs more than 2e-4
# apart, none 0.08 (measured on the trained layers: 0 to 0.38%, at most
# 0.065). Through the whole pointer a flipped int8 value spreads to its
# whole batch item (15% of the second pair's outputs), so the profile is
# held where the JAX package holds it, a layer at a time
LAYER_ATOL, LAYER_MAX, LAYER_FRAC = 2e-4, 0.08, 0.01


def test_trained_dcp_matches_jax(tmp_path, monkeypatch):
    """f32 est_T (and the whole dict) at N=128; the int8 pointer at N=256
    with JAX's fused-layer gate opened as its accelerator opens it (the
    layer kernels' calls routed to their ``*_reference`` functions): each
    layer of the port's K11 plain version on the JAX clone's carried state
    within the tie-flip profile, the port's own clone's pointer within
    DCP_INT8_TOL."""
    import learning3d_tpu.kernels.transformer_int8 as jk11
    from learning3d_tpu import quant as jquant

    jd = restore(tmp_path, "r3c_dcp", "dcp", jax_script_model("dcp"))
    jd.eval()
    td = load_nnx_state(build_model("dcp", CLS_ARGS, None, "cpu"), nnx_flat(jd)).eval()
    data = jdata.RegistrationData("DCP", jdata.SyntheticModelNet40(train=False, num_points=DCP_N, size=B))
    t, s = (np.stack([data[i][j] for i in range(B)]) for j in range(2))
    want = jax.tree.map(np.asarray, nnx.jit(lambda m, a, b: m(a, b))(jd, jnp.asarray(t), jnp.asarray(s)))
    with torch.no_grad():
        got = td(torch.from_numpy(t), torch.from_numpy(s))
    for key in DCP_KEYS:
        assert rel(got[key], want[key]) <= DCP_TOL, key

    monkeypatch.setattr(jquant, "_fused_ok", lambda x, h: jk11.fused_layer_ok(x.shape[1], x.shape[2], h))
    monkeypatch.setattr(jk11, "encoder_layer_int8",
                        lambda x, w, sc, *, interpret=False, **kw: jk11.encoder_layer_int8_reference(x, w, sc, **kw))
    monkeypatch.setattr(jk11, "decoder_layer_int8", lambda x, m, w, sc, *, interpret=False, **kw:
                        jk11.decoder_layer_int8_reference(x, m, w, sc, **kw))
    data = jdata.RegistrationData("DCP", jdata.SyntheticModelNet40(train=False, num_points=DCP_INT8_N, size=2))
    t, s = (np.stack([data[i][j] for i in range(2)]).astype(np.float32) for j in range(2))
    # the pointer alone: the f32 encoder takes no int8 path in either package
    jq = jquant.quantize_dcp_pointer(jd, jnp.asarray(t), jnp.asarray(s), fused_layers=False)
    jf = jquant.quantize_dcp_pointer(jd, jnp.asarray(t), jnp.asarray(s), fused_layers=True)
    emb_t, emb_s = (np.asarray(jd.emb_nn(jnp.asarray(a))) for a in (t, s))
    carried = load_quant_dcp(td, nnx_flat(jq), quant_dcp_scales(jq))
    tquant._fuse_layers(carried.pointer, int8_pv=False)
    calls = []
    for name in ("encoder_layer_int8_reference", "decoder_layer_int8_reference"):
        fn = getattr(tquant, name)
        monkeypatch.setattr(tquant, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n[:3]) or _fn(*a, **kw))
    for side, inputs in (("enc", (emb_s,)), ("enc", (emb_t,)), ("dec", (emb_t, emb_s)), ("dec", (emb_s, emb_t))):
        layers = "enc_layers" if side == "enc" else "dec_layers"
        want = np.asarray(getattr(jf.pointer, layers)[0](*(jnp.asarray(a) for a in inputs)))
        with torch.inference_mode():
            got = getattr(carried.pointer, layers)[0](*(torch.from_numpy(a) for a in inputs)).float().numpy()
        d = np.abs(got - want)
        assert d.max() < LAYER_MAX and (d > LAYER_ATOL).mean() < LAYER_FRAC, (side, d.max(), (d > LAYER_ATOL).mean())
    assert calls == ["enc", "enc", "dec", "dec"]  # K11a's and K11b's plain versions
    own = tquant.quantize_dcp_pointer(td, torch.from_numpy(t), torch.from_numpy(s))
    want = [np.asarray(a) for a in jf.pointer(jnp.asarray(emb_s), jnp.asarray(emb_t))]
    with torch.inference_mode():
        mine = own.pointer(torch.from_numpy(emb_s), torch.from_numpy(emb_t))
    for m, w in zip(mine, want):
        assert rel_err(m, w) <= DCP_INT8_TOL
