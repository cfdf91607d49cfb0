"""The trained RPMNet and FlowNet3D releases on the CPU, and the port
checkpoints of both that the card reads (``learning3d_tpu_torch/trained``,
written by ``tools/convert_release_torch.py --predictions``).

- ``r4b_rpmnet``: RPMNet() (PPFNet emb 96, r 0.3, 64 neighbours; 5
  Sinkhorn and 2 RPM iterations) on 2 test-split RegistrationData("RPMNet")
  pairs of N=256 points with normals. Trained weights make its f32 forward
  ill-conditioned in both packages: beta ~ 100 and alpha ~ 27 put the
  log-affinities near 2,700, so the rounding of alpha alone moves them
  against the slack's zero (``PERF.md`` §6). So the port's f64 forward is
  held to JAX's x64 forward, and the port's f32 within twice JAX's own f32
  gap to its x64 (``torch_port_util.hold_to_jax``'s rule).
- ``r4_flownet``: FlowNet3D() on 2 SyntheticSceneflow pairs of N=1024 (the
  release's training and evaluation size), eval mode, f32.
- The committed checkpoints: every tensor equal to the release's, the
  release's meta.json fields, their size, loaded by the port's own Trainer;
  ``reference_predictions.npz`` equal to JAX's results (RPMNet's 16 pairs,
  the flow's first two); the 16 stored pairs of each eval set rebuilt by the port's
  data classes item for item equal to JAX's, and their ground truth the
  stored one (no release needed).

The restoring Trainer writes into a tmp directory whose ``best`` links to
the release; the release's files are compared before and after. The tests
skip only when the release is absent.
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu import models as jmodels
from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.train.metrics import registration_errors as jregistration_errors
from learning3d_tpu_torch.data import dataloaders as tdata
from learning3d_tpu_torch.examples.train import build_model
from learning3d_tpu_torch.train import TrainConfig, Trainer
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from test_torch_trained import RELEASES, TRAINED, release_files, restore
from torch_port_util import max_rel, nnx_flat

ARGS = SimpleNamespace(emb_dims=1024, nearest_neighbors=20, seed=0)
PAIRS = 16  # the stored pairs: the first batch of 16 of each eval set (the converter's PAIRS)
RPM_SIZE, FLOW_N, FLOW_SIZE = 2048, 1024, 256  # the eval sets (chip_smoke.py's TRAINED_RPM_SIZE, TRAINED_FLOW_*)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_model(name):
    return {"r4b_rpmnet": lambda: jmodels.RPMNet(rngs=nnx.Rngs(0)),
            "r4_flownet": lambda: jmodels.FlowNet3D(rngs=nnx.Rngs(0))}[name]()


TASKS = {"r4b_rpmnet": ("rpmnet", "rpmnet"), "r4_flownet": ("flownet", "flow")}


def eval_items(package, name, count):
    """The first ``count`` items of the release's eval set, built by the
    JAX package's data module or the port's (numpy both)."""
    data = jdata if package == "jax" else tdata
    if name == "r4b_rpmnet":
        ds = data.RegistrationData("RPMNet", data.SyntheticModelNet40(train=False, num_points=1024, size=RPM_SIZE,
                                                                       use_normals=True))
    else:
        ds = data.SyntheticSceneflow(npoints=FLOW_N, size=FLOW_SIZE)
    items = [ds[i] for i in range(count)]
    return [np.stack([it[j] for it in items]) for j in range(len(items[0]))]


def call(module, *args):
    return jax.tree.map(np.asarray, nnx.jit(lambda m, *a: m(*a))(module, *(jnp.asarray(a) for a in args)))


# RPMNet at N=256 on 2 pairs, est_T, transformed_source and r: the port's
# f64 against JAX's x64 to RPM_F64_TOL of max (measured 4.0e-7, r; est_T 6.0e-8: both
# sides solve the 3x3 Kabsch in f32, as the JAX package casts the
# covariance). The f32 forwards are rounding draws at this conditioning:
# JAX's f32 lay 1.5e-3 from its x64 (est_T), the port's 4.6e-3, and on the
# 16 stored pairs of N=1024 the two f32 paths lay up to 2.0e-2 apart. The
# port's f32 is held within twice JAX's own f32 gap plus RPM_F32_TOL, half
# that spread; a wrong term moves est_T by its own order (the bf16-rounded
# Sinkhorn output of chip_smoke.py's control: 0.035 to 1.6)
RPM_F64_TOL, RPM_F32_TOL = 1e-5, 1e-2
RPM_N, RPM_B = 256, 2
RPM_KEYS = ("est_T", "transformed_source", "r")


def test_trained_rpmnet_matches_jax(tmp_path):
    before = release_files("r4b_rpmnet")
    jm = restore(tmp_path, "r4b_rpmnet", "rpmnet", jax_model("r4b_rpmnet"))
    jm.eval()
    data = jdata.RegistrationData("RPMNet", jdata.SyntheticModelNet40(train=False, num_points=RPM_N, size=RPM_B,
                                                                       use_normals=True))
    t, s = (np.stack([data[i][j] for i in range(RPM_B)]) for j in range(2))
    want32 = call(jm, t, s)
    with jax.enable_x64(True):
        want64 = call(jm, t.astype(np.float64), s.astype(np.float64))
    tm = load_nnx_state(build_model("rpmnet", ARGS, None, "cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got32 = tm(torch.from_numpy(t), torch.from_numpy(s))
        got64 = copy.deepcopy(tm).double()(torch.from_numpy(t).double(), torch.from_numpy(s).double())
    f64 = {k: max_rel(got64[k], want64[k]) for k in RPM_KEYS}
    assert max(f64.values()) <= RPM_F64_TOL, f64
    for key in RPM_KEYS:
        jax_gap = max_rel(want32[key], want64[key])
        assert max_rel(got32[key], want64[key]) <= 2 * jax_gap + RPM_F32_TOL, (key, jax_gap)
    assert release_files("r4b_rpmnet") == before


# FlowNet3D at N=1024 (sa1 samples 1024 points) on 2 pairs in eval mode: the
# flow to FLOW_TOL of max (measured 1.1e-5; on the 16 stored pairs 1.2e-5)
FLOW_TOL = 1e-4


def test_trained_flownet_matches_jax(tmp_path):
    before = release_files("r4_flownet")
    jm = restore(tmp_path, "r4_flownet", "flow", jax_model("r4_flownet"))
    jm.eval()
    pos1, pos2, c1, c2, flow, _ = eval_items("jax", "r4_flownet", 2)
    want = call(jm, pos1, pos2, c1, c2)
    tm = load_nnx_state(build_model("flownet", ARGS, None, "cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (pos1, pos2, c1, c2)))
    assert max_rel(got, want) <= FLOW_TOL, max_rel(got, want)
    # the trained model estimates the flow (JAX's EPE on the 16 stored pairs: 0.064)
    assert np.linalg.norm(got.numpy() - flow, axis=-1).mean() < 0.2
    assert release_files("r4_flownet") == before


@pytest.mark.parametrize("name,limit_mib", [("r4b_rpmnet", 4), ("r4_flownet", 6)])
def test_committed_port_checkpoint_is_the_release(tmp_path, name, limit_mib):
    """learning3d_tpu_torch/trained/<name>/best: every tensor equal to the
    release's, the release's meta.json fields, under its size limit, and
    loaded by the port's own Trainer (torch.load with weights_only, no
    JAX)."""
    best = TRAINED / name / "best"
    assert sum(p.stat().st_size for p in best.iterdir()) < limit_mib * 2**20
    model_name, task = TASKS[name]
    jm = restore(tmp_path, name, task, jax_model(name))
    want = nnx_to_torch(nnx_flat(jm))
    state = torch.load(best / "model.pt", map_location="cpu", weights_only=True)
    assert set(state) == set(want)
    for key, value in state.items():
        assert value.dtype == torch.float32, key
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    meta = json.loads((best / "meta.json").read_text())
    release_meta = json.loads((RELEASES / name / "best" / "meta.json").read_text())
    assert meta == {k: release_meta[k] for k in ("epoch", "best_loss", "dataset_version")}
    (tmp_path / "port" / name).mkdir(parents=True)
    os.symlink(best, tmp_path / "port" / name / "best")
    model = build_model(model_name, ARGS, None, "cpu")
    trainer = Trainer(TrainConfig(exp_name=name, task=task, ckpt_dir=str(tmp_path / "port")), model, device="cpu")
    trainer.load("best")
    assert trainer.epoch == release_meta["epoch"]
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    assert not (tmp_path / "port" / name / "run.log").exists()


# JAX's results computed again against the stored batch of 16, to NPZ_TOL of
# max: the flow on the first two pairs (measured 0); RPMNet's est_T and
# transformed_source on all 16 (measured 0), since at another batch size
# XLA's CPU sums RPMNet's items in another order and the trained forward
# carries that rounding into est_T; the stored metrics JAX's
# registration_errors of the stored est_T, and the flow's its formulas
FIRST = {"r4b_rpmnet": PAIRS, "r4_flownet": 2}
NPZ_TOL = 1e-5


@pytest.mark.parametrize("name", ["r4b_rpmnet", "r4_flownet"])
def test_reference_predictions_are_jax_results(tmp_path, name):
    ref = np.load(TRAINED / name / "best" / "reference_predictions.npz")
    jm = restore(tmp_path, name, TASKS[name][1], jax_model(name))
    jm.eval()
    arrays = eval_items("jax", name, FIRST[name])
    if name == "r4b_rpmnet":
        assert set(ref.files) == {"est_T", "transformed_source", "igt", "rot_deg", "trans"}
        out = call(jm, arrays[0], arrays[1])
        for key in ("est_T", "transformed_source"):
            assert max_rel(ref[key], out[key]) <= NPZ_TOL, key
        err = jax.tree.map(np.asarray, jregistration_errors(jnp.asarray(ref["est_T"]), jnp.asarray(ref["igt"])))
        for key in ("rot_deg", "trans"):
            np.testing.assert_allclose(ref[key], err[key], rtol=1e-6, atol=1e-6)
    else:
        assert set(ref.files) == {"flow", "flow_gt", "epe", "acc3d_strict", "acc3d_relax"}
        out = call(jm, *arrays[:4])
        assert max_rel(ref["flow"][:FIRST[name]], out) <= NPZ_TOL
        err = np.linalg.norm(ref["flow"] - ref["flow_gt"], axis=-1)
        rel = err / (np.linalg.norm(ref["flow_gt"], axis=-1) + 1e-12)
        np.testing.assert_allclose(ref["epe"], err.mean(-1), rtol=1e-6)
        np.testing.assert_array_equal(ref["acc3d_strict"], ((err < 0.05) | (rel < 0.05)).mean(-1).astype(np.float32))
        np.testing.assert_array_equal(ref["acc3d_relax"], ((err < 0.10) | (rel < 0.10)).mean(-1).astype(np.float32))
    assert all(ref[k].shape[0] == PAIRS for k in ref.files)
    assert (TRAINED / name / "best" / "reference_predictions.npz").stat().st_size < 2**20


@pytest.mark.parametrize("name", ["r4b_rpmnet", "r4_flownet"])
def test_eval_pairs_are_the_same_in_both_packages(name):
    """The 16 stored pairs as the card rebuilds them (the port's data
    classes; RPMNet's normals by PCA on the host) equal to the JAX package's,
    array for array, and their ground truth the stored one (no release
    needed)."""
    want, got = eval_items("jax", name, PAIRS), eval_items("torch", name, PAIRS)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ref = np.load(TRAINED / name / "best" / "reference_predictions.npz")
    np.testing.assert_array_equal(ref["igt"] if name == "r4b_rpmnet" else ref["flow_gt"],
                                  got[2] if name == "r4b_rpmnet" else got[4])
