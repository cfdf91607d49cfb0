"""The port's entry points (learning3d_tpu_torch.examples.train and
.evaluate) and what they need (train.metrics' registration summary,
data.dataloaders' ModelNet40Data and create_random_transform) against the
JAX package, on the CPU at a small size.

No test reaches the network: the data directories of both packages point
into pytest's tmp_path, and urllib's download is replaced by one that
raises. ModelNet40 is read from h5 files the tests write.
"""

import io
import re
import subprocess
import sys
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.train import metrics as jmetrics
from learning3d_tpu_torch.data import dataloaders as tdata
from learning3d_tpu_torch.examples import evaluate as tevaluate
from learning3d_tpu_torch.examples import train as ttrain
from learning3d_tpu_torch.train import metrics as tmetrics
from learning3d_tpu_torch.utils.jax_import import load_nnx_state
from torch_port_util import nnx_flat, randomize_bn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    """One thread; both packages' data directory an empty one under
    tmp_path; any download attempt raises at once."""
    torch.set_num_threads(1)
    empty = tmp_path / "no_data"
    monkeypatch.setattr(jdata, "_DATA_DIR", empty)
    monkeypatch.setattr(tdata, "_DATA_DIR", empty)

    def refuse(*args, **kwargs):
        raise OSError("network access is not allowed in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def random_poses(rng, b):
    """(b, 4, 4) rigid transforms: rotations from normalized quaternions,
    translations in [-1, 1]."""
    from scipy.spatial.transform import Rotation

    T = np.zeros((b, 4, 4))
    T[:, :3, :3] = Rotation.from_quat(rng.normal(size=(b, 4))).as_matrix()
    T[:, :3, 3] = rng.uniform(-1, 1, (b, 3))
    T[:, 3, 3] = 1.0
    return T.astype(np.float32)


# summarize_registration is the same float64 numpy arithmetic in both
# packages: equal to 1e-12 of each value (the bound leaves room for a
# library's summation order, none is expected)
SUMMARY_TOL = 1e-12


@pytest.mark.parametrize("with_template", [True, False])
def test_summarize_registration_matches_jax(with_template):
    rng = np.random.default_rng(0)
    est, igt = random_poses(rng, 12), random_poses(rng, 12)
    template = rng.normal(size=(12, 150, 3)).astype(np.float32) if with_template else None
    want = jmetrics.summarize_registration(est, igt, template)
    got = tmetrics.summarize_registration(est, igt, template)
    assert list(got) == list(want)
    assert ("point_RMSE" in got) == with_template
    for k in want:
        assert isinstance(got[k], float)
        assert abs(got[k] - want[k]) <= SUMMARY_TOL * max(abs(want[k]), 1.0), k


def test_format_registration_summary_matches_jax():
    """The same line, key order and six decimals, with mask_* scores last
    in sorted order, and another stage name."""
    rng = np.random.default_rng(1)
    est, igt = random_poses(rng, 6), random_poses(rng, 6)
    summary = jmetrics.summarize_registration(est, igt, rng.normal(size=(6, 20, 3)))
    summary.update(mask_f1=0.5, mask_accuracy=0.25)
    for stage in ("test", "train"):
        line = tmetrics.format_registration_summary(summary, stage)
        assert line == jmetrics.format_registration_summary(summary, stage)
        assert line.startswith(f"Stage: {stage}, Rot_MSE: ") and line.endswith("mask_f1: 0.500000")


def test_point_rmse_matches_jax():
    """Per item, f32 within 1e-6 of the value."""
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(3, 5, 40, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jmetrics.point_rmse(jnp.asarray(a), jnp.asarray(b)))
    got = tmetrics.point_rmse(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("max_rot,max_trans", [(45.0, 1.0), (180.0, 0.2)])
def test_create_random_transform_matches_jax(max_rot, max_trans):
    """The same draws from the same generator: the translation equal, the
    float32 quaternion within 1e-6 (the two libraries' sin and cos)."""
    for seed in range(3):
        want = jdata.create_random_transform(np.random.default_rng(seed), max_rot, max_trans)
        got = tdata.create_random_transform(np.random.default_rng(seed), max_rot, max_trans)
        assert got.shape == (1, 7) and got.dtype == np.float32
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-6)


def write_modelnet40(root, n_pts=32):
    """A small ModelNet40 archive under root: two train files and one test
    file with points, labels (n, 1) and normals."""
    h5py = pytest.importorskip("h5py")
    d = root / "modelnet40_ply_hdf5_2048"
    d.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name, n in (("ply_data_train1.h5", 7), ("ply_data_train0.h5", 9), ("ply_data_test0.h5", 11)):
        with h5py.File(d / name, "w") as h:
            h["data"] = rng.normal(size=(n, n_pts, 3)).astype(np.float32)
            h["label"] = rng.integers(0, 40, (n, 1)).astype(np.uint8)
            h["normal"] = rng.normal(size=(n, n_pts, 3)).astype(np.float32)
    return root


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("unseen", [False, True])
@pytest.mark.parametrize("use_normals", [False, True])
def test_modelnet40_data_matches_jax(tmp_path, train, unseen, use_normals):
    """Every item equal in both packages, with and without the random
    permutation of the points (the same generator)."""
    root = write_modelnet40(tmp_path)
    for randomize in (False, True):
        kw = dict(train=train, num_points=20, root_dir=str(root), unseen=unseen, use_normals=use_normals,
                  randomize_data=randomize)
        want = jdata.ModelNet40Data(**kw, rng=np.random.default_rng(4))
        got = tdata.ModelNet40Data(**kw, rng=np.random.default_rng(4))
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            (gp, gl), (wp, wl) = got[i], want[i]
            assert gp.shape == (20, 6 if use_normals else 3) and gp.dtype == np.float32
            np.testing.assert_array_equal(gp, wp)
            assert gl == wl
            assert got.get_shape(gl) == want.get_shape(wl)


def test_modelnet40_data_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no ModelNet40 h5 files"):
        tdata.ModelNet40Data(root_dir=str(tmp_path), download=False)


def test_download_modelnet40_keeps_an_existing_copy_and_reports_a_failure(tmp_path):
    root = write_modelnet40(tmp_path / "have")
    assert tdata.download_modelnet40(root) == root / "modelnet40_ply_hdf5_2048"
    with pytest.raises(RuntimeError, match="could not download ModelNet40"):
        tdata.download_modelnet40(tmp_path / "none")


def args_for(task, **kw):
    base = dict(task=task, num_points=32, noise=False, dataset_size=8, param_jitter=0.0, hard_cls=False,
                detail_amp=0.04, cls_noise=None)
    return SimpleNamespace(**{**base, **kw})


def test_build_dataset_reads_modelnet40_or_falls_back(tmp_path, monkeypatch, capsys):
    """The [data] line and SyntheticModelNet40 where the archive is absent
    (no download is attempted); ModelNet40Data where it is there; the
    task's wrapper around either."""
    ds = ttrain.build_dataset(args_for("classification"), train=False)
    assert "[data] ModelNet40 unavailable" in capsys.readouterr().out
    assert isinstance(ds.data_class, tdata.SyntheticModelNet40) and len(ds) == 8
    monkeypatch.setattr(tdata, "_DATA_DIR", write_modelnet40(tmp_path / "data"))
    ds = ttrain.build_dataset(args_for("ipcrnet"), train=True)
    assert isinstance(ds.data_class, tdata.ModelNet40Data) and len(ds) == 16
    assert [a.shape for a in ds[0][:3]] == [(32, 3), (32, 3), (4, 4)]


def run_cli(module, argv):
    """module.main(argv) with its printed lines."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = module.main(argv)
    return result, out.getvalue().splitlines()


SMALL = ["--device", "cpu", "--num_points", "32", "--dataset_size", "8", "--batch_size", "4", "--epochs", "1"]


def test_train_cli_classification_on_cpu(tmp_path):
    """pointnet/classification for one epoch (two steps of 4): the epoch's
    line with finite losses, run.log, best and latest checkpoints."""
    trainer, lines = run_cli(ttrain, ["--model", "pointnet", "--emb_dims", "64", "--augment", "--label_smoothing",
                                      "0.2", "--cosine", "--ckpt_dir", str(tmp_path)] + SMALL)
    epoch = [ln for ln in lines if ln.startswith("epoch 0: train_loss=")]
    assert len(epoch) == 1
    values = [float(v) for v in re.findall(r"=(-?[0-9.]+)", epoch[0].split("(")[0])]
    assert values and all(np.isfinite(values))
    run = tmp_path / "exp_pointnet"
    assert "epoch 0: train_loss=" in (run / "run.log").read_text()
    for name in ("best", "latest"):
        assert {p.name for p in (run / name).iterdir()} == {"model.pt", "opt.pt", "meta.json"}
    assert trainer.cfg.label_smoothing == 0.2 and trainer.cfg.cosine_decay and trainer.cfg.augment


def test_train_then_evaluate_registration_cli_on_cpu(tmp_path):
    """ipcrnet/ipcrnet for one epoch, then the evaluate CLI on its best
    checkpoint with --multistart 4 and --num_iters 2: the test line, the
    summary line in the JAX format with finite values."""
    run_cli(ttrain, ["--model", "ipcrnet", "--task", "ipcrnet", "--ckpt_dir", str(tmp_path)] + SMALL)
    assert (tmp_path / "exp_ipcrnet" / "best" / "model.pt").is_file()
    result, lines = run_cli(tevaluate, ["--model", "ipcrnet", "--task", "ipcrnet", "--ckpt", "exp_ipcrnet",
                                        "--ckpt_dir", str(tmp_path), "--multistart", "4", "--num_iters", "2"]
                            + SMALL[:-2])
    assert lines[-2].startswith("test_loss=") and lines[-1].startswith("Stage: test, Rot_MSE: ")
    values = [float(v) for v in re.findall(r": (-?[0-9.]+)", lines[-1])]
    assert len(values) == 11 and all(np.isfinite(values))
    assert lines[-1] == tmetrics.format_registration_summary(result["summary"])


def test_export_feature_then_transfer_ptnet(tmp_path):
    """--export_feature writes the best checkpoint's encoder; --transfer_ptnet
    starts PointNetLK's encoder from it (no epoch run, so it stays equal)."""
    run_cli(ttrain, ["--model", "pointnet", "--export_feature", "--exp_name", "cls", "--ckpt_dir", str(tmp_path)]
            + SMALL)
    exported = torch.load(tmp_path / "cls" / "feature_model" / "model.pt", weights_only=True)
    best = torch.load(tmp_path / "cls" / "best" / "model.pt", weights_only=True)
    assert exported and all(torch.equal(v, best[f"feature_model.{k}"]) for k, v in exported.items())
    trainer, lines = run_cli(ttrain, ["--model", "pointnetlk", "--task", "pointnetlk", "--transfer_ptnet", "cls",
                                      "--ckpt_dir", str(tmp_path)] + SMALL[:-1] + ["0"])
    assert any(ln.startswith("[transfer] feature_model initialized from") for ln in lines)
    state = trainer.model.feature_model.state_dict()
    assert set(state) == set(exported)
    assert all(torch.equal(state[k], v) for k, v in exported.items())


def jax_script(name):
    import importlib

    return importlib.import_module(f"examples.{name}")


def ipcrnet_pair(iterations):
    """A JAX iPCRNet at the script's width (emb 1024, no BatchNorm) and its
    port twin on the same weights, with ``iterations`` refinement steps."""
    args = SimpleNamespace(emb_dims=1024, nearest_neighbors=20, seed=0)
    jm = jax_script("train").build_model("ipcrnet", args, nnx.Rngs(0))
    tm = load_nnx_state(ttrain.build_model("ipcrnet", args, torch.Generator().manual_seed(0), "cpu"), nnx_flat(jm))
    jm.default_iterations = tm.default_iterations = iterations
    return jm, tm


# evaluate_registration against JAX's on the same weights and pairs: est_T
# in f32 on both sides (the libraries' sum orders differ by f32 rounding),
# so each summary value within 1e-4 of itself (or absolutely, of 1e-4, where
# it is near 0; measured: 3.3e-6 at most); the keys in JAX's order
REG_TOL = 1e-4


@pytest.mark.parametrize("multistart,iterations", [(0, 8), (4, 2)])
def test_evaluate_registration_matches_jax(multistart, iterations):
    jm, tm = ipcrnet_pair(iterations)
    data = {pkg: mod.RegistrationData("iPCRNet", mod.SyntheticModelNet40(train=False, num_points=64, size=8))
            for pkg, mod in (("jax", jdata), ("torch", tdata))}
    args = SimpleNamespace(batch_size=4, multistart=multistart)
    want = jax_script("evaluate").evaluate_registration(jm, data["jax"], args)
    got = tevaluate.evaluate_registration(tm, data["torch"], args)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= REG_TOL * max(abs(want[k]), 1.0), (k, got[k], want[k])


def test_evaluate_registration_with_a_masknet_matches_jax():
    """The --masknet_ckpt chain: the masked template registered, the mask
    scores in the summary; the same keys and values as JAX's."""
    from learning3d_tpu import models as jmodels
    from learning3d_tpu_torch.models import DCP, DGCNN, MaskNet, PointNet

    jmask = jmodels.MaskNet(jmodels.PointNet(emb_dims=64, use_bn=True, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1))
    randomize_bn(jmask, np.random.default_rng(5))
    jdcp = jmodels.DCP(jmodels.DGCNN(emb_dims=64, k=5, rngs=nnx.Rngs(2)), rngs=nnx.Rngs(3))
    tmask = load_nnx_state(MaskNet(PointNet(emb_dims=64, use_bn=True, device="cpu"), device="cpu"), nnx_flat(jmask))
    tdcp = load_nnx_state(DCP(DGCNN(emb_dims=64, k=5, device="cpu"), device="cpu"), nnx_flat(jdcp))
    data = {pkg: mod.RegistrationData("PointNetLK", mod.SyntheticModelNet40(train=False, num_points=64, size=4),
                                      partial_source=True, additional_params={"use_masknet": True})
            for pkg, mod in (("jax", jdata), ("torch", tdata))}
    args = SimpleNamespace(batch_size=2, multistart=0)
    want = jax_script("evaluate").evaluate_registration(jdcp, data["jax"], args, mask_model=jmask)
    got = tevaluate.evaluate_registration(tdcp, data["torch"], args, mask_model=tmask)
    assert list(got) == list(want) and "mask_f1" in got
    for k in want:
        assert abs(got[k] - want[k]) <= REG_TOL * max(abs(want[k]), 1.0), (k, got[k], want[k])


def test_evaluate_classification_quantized_matches_jax(capsys):
    """The PTQ recipe on the same weights and clouds: the port's f32 and
    int8 argmaxes equal JAX's f32 and int8 ones, so the printed line is
    JAX's, character for character."""
    from learning3d_tpu import models as jmodels
    from learning3d_tpu_torch.models import Classifier, PointNet

    jm = jmodels.Classifier(jmodels.PointNet(emb_dims=128, use_bn=True, rngs=nnx.Rngs(0)), 40, rngs=nnx.Rngs(1))
    randomize_bn(jm, np.random.default_rng(6))
    tm = load_nnx_state(Classifier(PointNet(emb_dims=128, use_bn=True, device="cpu"), 40, device="cpu"),
                        nnx_flat(jm))
    data = {pkg: mod.ClassificationData(mod.SyntheticModelNet40(train=False, num_points=128, size=12))
            for pkg, mod in (("jax", jdata), ("torch", tdata))}
    args = SimpleNamespace(batch_size=4)
    jax_script("evaluate").evaluate_classification_quantized(jm, data["jax"], args)
    want = capsys.readouterr().out.strip()
    got = tevaluate.evaluate_classification_quantized(tm, data["torch"], args)
    assert capsys.readouterr().out.strip() == want
    assert got["n"] == 12 and set(got["pred"]) <= set(range(40))
    np.testing.assert_array_equal(got["labels"], [data["jax"][i][1] for i in range(12)])


def test_evaluate_dcp_quantized_cli_on_cpu():
    """--quantize --task dcp on DCP's initial weights: the test line and three
    summaries (f32, int8-ptq, int8-pv) in the JAX format, finite; the int8
    layers run their plain versions here."""
    result, lines = run_cli(tevaluate, ["--model", "dcp", "--task", "dcp", "--quantize"] + SMALL[:-2])
    assert lines[-4].startswith("test_loss=")
    assert lines[-3].startswith("Stage: test, Rot_MSE: ")
    assert lines[-2].startswith("int8-ptq Stage: test, Rot_MSE: ")
    assert lines[-1].startswith("int8-pv Stage: test, Rot_MSE: ")
    for key in ("summary", "int8-ptq", "int8-pv"):
        assert all(np.isfinite(v) for v in result[key].values()), key


@pytest.mark.parametrize("module", [ttrain, tevaluate])
def test_default_device_is_the_card(module):
    """Without --device the entry points ask for CUDA, which raises where
    there is no card: nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--model", "pointnet", "--emb_dims", "64", "--num_points", "32", "--dataset_size", "8"])


def test_train_module_runs_as_a_script(tmp_path):
    """``python -m learning3d_tpu_torch.examples.train --device cpu ...``
    writes a checkpoint and run.log."""
    proc = subprocess.run([sys.executable, "-m", "learning3d_tpu_torch.examples.train", "--model", "pointnet",
                           "--emb_dims", "64", "--ckpt_dir", str(tmp_path)] + SMALL,
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "epoch 0: train_loss=" in (tmp_path / "exp_pointnet" / "run.log").read_text()
    assert (tmp_path / "exp_pointnet" / "best" / "model.pt").is_file()
