"""The port's part segmentation against the JAX package's, on the CPU:
``SyntheticPartSegmentation`` and ``SegmentationData`` bit for bit, the
Segmentation head on PointNet(global_feat=False) in eval and train mode
(running statistics included), the ``segmentation`` task's loss, accuracy
and gradients, and one Trainer step. Weights cross as numpy through
``load_nnx_state``; a narrow encoder (emb 64), B = 2, N = 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import PointNet as JPointNet
from learning3d_tpu.models import Segmentation as JSegmentation
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.data import SegmentationData, SyntheticPartSegmentation
from learning3d_tpu_torch.models import PointNet, Segmentation
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import nnx_flat, randomize_bn

EMB, N, B, CLASSES = 64, 128, 2, 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kw", [{}, {"train": False, "num_points": 100, "num_parts": 6, "seed": 3}],
                         ids=["default", "test_split"])
def test_synthetic_part_segmentation_matches_jax_bit_for_bit(kw):
    got, want = SyntheticPartSegmentation(**kw), jdata.SyntheticPartSegmentation(**kw)
    assert len(got) == len(want)
    for idx in (0, 1, 7, 511):
        (gp, gl), (wp, wl) = got[idx], want[idx]
        assert gp.dtype == wp.dtype == np.float32 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
    data = SegmentationData()
    assert len(data) == 512
    np.testing.assert_array_equal(data[5][0], jdata.SegmentationData()[5][0])
    small = SegmentationData(SyntheticPartSegmentation(size=3))
    assert len(small) == 3 and small[2][1].shape == (1024,)


def jax_segmentation(seed):
    jm = JSegmentation(JPointNet(emb_dims=EMB, use_bn=True, global_feat=False, rngs=nnx.Rngs(seed)),
                       num_classes=CLASSES, rngs=nnx.Rngs(seed + 1))
    randomize_bn(jm, np.random.default_rng(seed + 2))
    return jm


def port_segmentation(flat):
    model = Segmentation(PointNet(emb_dims=EMB, use_bn=True, global_feat=False, device="cpu"), num_classes=CLASSES,
                         device="cpu")
    return load_nnx_state(model, flat)


def seg_batch(seed, b=B):
    data = jdata.SyntheticPartSegmentation(num_points=N, size=b, seed=seed)
    pts, labels = zip(*(data[i] for i in range(b)))
    return np.stack(pts), np.stack(labels)


def test_load_nnx_state_carries_segmentation():
    jm = jax_segmentation(0)
    flat = nnx_flat(jm)
    tm = port_segmentation(flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    assert {k.split(".")[0] for k in flat} == {"feature_model", "conv1", "conv2", "conv3", "conv4", "bn1", "bn2",
                                               "bn3"}
    np.testing.assert_array_equal(tm.conv1.weight.detach().numpy(), flat["conv1.kernel"].T)


# f32, the same math in another sum order: logits to 1e-5 of max; the
# train-mode running statistics to 1e-5
FWD_TOL = 1e-5


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_segmentation_matches_jax(mode):
    jm = jax_segmentation(1)
    getattr(jm, mode)()
    flat = nnx_flat(jm)
    x, _ = seg_batch(2)
    want = jm(jnp.asarray(x))
    tm = getattr(port_segmentation(flat), mode)()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (B, N, CLASSES)
    assert rel(got, want) <= FWD_TOL
    after = nnx_to_torch(nnx_flat(jm))
    for name, buf in tm.named_buffers():
        assert rel(buf, after[name]) <= FWD_TOL, name


@pytest.fixture(scope="module")
def jax_task():
    jm = jax_segmentation(3)
    jm.train()
    batch = seg_batch(4)

    @nnx.jit
    def task(m, bt):
        return nnx.value_and_grad(lambda m: jtasks.segmentation(m, bt, None), has_aux=True)(m)

    flat = nnx_flat(jm)
    (loss, aux), grads = task(jm, tuple(map(jnp.asarray, batch)))
    return {"flat": flat, "batch": batch, "loss": float(loss), "accuracy": float(aux["accuracy"]),
            "grads": nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value())
                                   for p, v in nnx.to_flat_state(grads)})}


# the loss to 1e-5, the accuracy exactly, each gradient to 1e-3 of its
# norm. Some gradients cancel to rounding and are held to 1e-3 of their
# layer's weight gradient instead: the biases in front of a train-mode
# BatchNorm, and the last encoder BatchNorm's bias, which shifts the pooled
# feature tiled over every point alike in front of bn1 (0 in f64, 1.6e-7
# against its weight's 0.09 in f32)
TASK_TOL = {"loss": 1e-5, "grad": 1e-3}
CANCELLING = {**{f"feature_model.convs.{i}.bias": f"feature_model.convs.{i}.weight" for i in range(5)},
              **{f"conv{i}.bias": f"conv{i}.weight" for i in (1, 2, 3)},
              "feature_model.bns.4.bias": "feature_model.bns.4.weight"}


def check_grads(grads, want):
    assert set(grads) == set(want)
    errs = {n: float(np.linalg.norm(g - want[n]) / max(np.linalg.norm(want[CANCELLING.get(n, n)]), 1e-30))
            for n, g in grads.items()}
    assert max(errs.values()) <= TASK_TOL["grad"], sorted(errs.items(), key=lambda kv: -kv[1])[:4]


def test_segmentation_task_matches_jax(jax_task):
    """The per-point NLL and accuracy, and every gradient."""
    model = port_segmentation(jax_task["flat"]).train()
    x, y = jax_task["batch"]
    loss, aux = tasks.segmentation(model, (torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    assert abs(loss.item() - jax_task["loss"]) <= TASK_TOL["loss"] * abs(jax_task["loss"])
    assert aux["accuracy"].item() == pytest.approx(jax_task["accuracy"], abs=1e-7)
    check_grads({n: p.grad.numpy() for n, p in model.named_parameters()}, jax_task["grads"])
    assert tasks.TASKS["segmentation"] is tasks.segmentation


def test_segmentation_loss_is_the_per_point_nll():
    """Against a direct evaluation: -mean over the points of the
    log-softmax at each label."""
    logits = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[0, 1, 2, 3, 0], [3, 3, 2, 1, 0]], dtype=torch.int32)
    loss, aux = tasks.segmentation(lambda x: logits, (None, labels))
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 4), labels.reshape(-1).long())
    torch.testing.assert_close(loss, want)
    assert aux["accuracy"].item() == (logits.argmax(-1) == labels).float().mean().item()


def test_trainer_step_updates_every_tensor(jax_task, tmp_path):
    """One Trainer.train_step of the segmentation task: the task is picked
    by name, the loss is the task's, every weight and running statistic
    changes."""
    model = port_segmentation(jax_task["flat"])
    tr = Trainer(TrainConfig(batch_size=B, task="segmentation", lr=1e-3, ckpt_dir=str(tmp_path)), model,
                 device="cpu")
    assert tr.loss_fn is tasks.segmentation
    tr._ensure_optimizer(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, aux = tr.train_step(tuple(map(torch.from_numpy, jax_task["batch"])))
    assert abs(float(loss) - jax_task["loss"]) <= TASK_TOL["loss"] * abs(jax_task["loss"])
    for k, v in model.state_dict().items():
        if k.endswith("weight") or "running" in k:
            assert not torch.equal(v, before[k]), k
    tr.close()
