"""The port's PCN completion slice against the JAX package, on the CPU: PCN
coarse and detailed (the folding decoder with conv5 split by linearity),
``tasks.pcn``'s loss, aux and gradients, the EMD loss on the coarse output,
and one Trainer step against the JAX ``Trainer._train_step``. Weights cross
as numpy through ``load_nnx_state``; inputs are made with numpy from seeds.
The Chamfer terms run K12's plain version (exact differences), the JAX
package's CPU path its matmul expansion: the tests check first that both
chose the same nearest neighbours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from learning3d_tpu import losses as jlosses
from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.kernels import chamfer as jchamfer
from learning3d_tpu.models import PCN as JPCN
from learning3d_tpu.train import TrainConfig as JTrainConfig
from learning3d_tpu.train import Trainer as JTrainer
from learning3d_tpu.train import tasks as jtasks
from learning3d_tpu_torch.kernels import chamfer as tchamfer
from learning3d_tpu_torch.losses import emd_loss_mean
from learning3d_tpu_torch.models import PCN
from learning3d_tpu_torch.train import TrainConfig, Trainer, tasks
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import check_adam_first_step, keep_grads, nnx_flat

EMB, COARSE, N, B, LR = 64, 32, 96, 2, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def norm_rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def jax_pcn(detailed, seed=0):
    return JPCN(emb_dims=EMB, num_coarse=COARSE, detailed_output=detailed, rngs=nnx.Rngs(seed))


def port_pcn(flat, detailed):
    return load_nnx_state(PCN(emb_dims=EMB, num_coarse=COARSE, detailed_output=detailed, device="cpu"), flat)


def points(seed, b=B, n=N):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("detailed", [False, True])
def test_pcn_matches_jax(detailed):
    """The coarse and (with the folding decoder) fine outputs in f32: the
    same math, f32 sums in another order, 1e-5 of the largest value; the
    fine points in the JAX package's order (grid "ij", coarse point
    repeated g^2 times)."""
    jm = jax_pcn(detailed)
    tm = port_pcn(nnx_flat(jm), detailed)
    x = points(1)
    want = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want)
    assert got["coarse_output"].shape == (B, COARSE, 3)
    for key in got:
        assert rel(got[key], want[key]) <= 1e-5, key
    if detailed:
        assert got["fine_output"].shape == (B, 16 * COARSE, 3) and tm.num_fine == 16 * COARSE
    with torch.no_grad():
        bcn = PCN(emb_dims=EMB, num_coarse=COARSE, detailed_output=detailed, input_shape="bcn", device="cpu")
        bcn.load_state_dict(tm.state_dict())
        assert torch.equal(bcn(torch.from_numpy(x).transpose(1, 2))["coarse_output"], got["coarse_output"])
    with pytest.raises(RuntimeError, match="3-channel"):
        tm(torch.zeros(1, 8, 4))


def test_fine_decoder_split_is_conv5_on_the_concat():
    """conv5 split by linearity equals conv5 on concat(grid, center, global)
    built in full, to f32 rounding (1e-5)."""
    tm = PCN(emb_dims=EMB, num_coarse=COARSE, detailed_output=True, generator=torch.Generator().manual_seed(2),
             device="cpu")
    x = torch.from_numpy(points(3))
    with torch.no_grad():
        v = tm._encode(x)
        coarse = tm._decode(v)
        got = tm._fine(coarse, v)
        g = tm.grid_size
        lin = torch.linspace(-0.05, 0.05, g)
        grid = torch.stack(torch.meshgrid(lin, lin, indexing="ij"), -1).reshape(-1, 2)
        F = tm.num_fine
        center = coarse.repeat_interleave(g * g, dim=1)
        full = torch.cat([grid.repeat(COARSE, 1).expand(B, F, 2), center, v[:, None].expand(B, F, EMB)], -1)
        h = torch.relu(tm.conv6(torch.relu(tm.conv5(full))))
        want = tm.conv7(h) + center
    assert rel(got, want.numpy()) <= 1e-5


def pcn_batch():
    data = jdata.ClassificationData(jdata.SyntheticModelNet40(num_points=N, size=B))
    items = [data[i] for i in range(B)]
    return tuple(np.stack([it[j] for it in items]) for j in range(2))


def same_neighbours(x, y):
    """Both packages pick the same nearest neighbours, both directions."""
    _, ji1, _, ji2 = map(np.asarray, jchamfer.nn_distance(jnp.asarray(x), jnp.asarray(y)))
    _, ti1, _, ti2 = tchamfer.nn_distance(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(ti1.numpy(), ji1)
    np.testing.assert_array_equal(ti2.numpy(), ji2)


# f32 on both sides with the same nearest neighbours: the loss to 1e-5,
# every gradient to 1e-3 of its norm (f32 sums in another order through
# the encoder's max-pools and the scatter-adds)
TASK_TOL = {"loss": 1e-5, "grad": 1e-3}


@pytest.mark.parametrize("detailed", [False, True])
def test_pcn_task_matches_jax(detailed):
    """tasks.pcn: Chamfer(points, coarse), plus Chamfer(points, fine) with
    the folding decoder, the per-stage aux, and every gradient against eager
    ``nnx.value_and_grad`` of the JAX task."""
    batch = pcn_batch()
    jm = jax_pcn(detailed, seed=4)
    flat = nnx_flat(jm)
    out = jm(jnp.asarray(batch[0]))
    for key in out:
        same_neighbours(batch[0], np.array(out[key]))
    (loss, aux), grads = nnx.value_and_grad(lambda m: jtasks.pcn(m, tuple(map(jnp.asarray, batch)), None),
                                            has_aux=True)(jm)
    tm = port_pcn(flat, detailed)
    tloss, taux = tasks.pcn(tm, tuple(torch.from_numpy(a) for a in batch))
    tloss.backward()
    assert set(taux) == set(aux) == ({"chamfer_coarse", "chamfer_fine"} if detailed else {"chamfer_coarse"})
    assert abs(tloss.item() - float(loss)) <= TASK_TOL["loss"] * abs(float(loss))
    for key in aux:
        assert abs(taux[key].item() - float(aux[key])) <= TASK_TOL["loss"] * abs(float(aux[key]))
    want = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(grads)})
    errs = {n: norm_rel(p.grad.numpy(), want[n]) for n, p in tm.named_parameters()}
    assert all(e <= TASK_TOL["grad"] for e in errs.values()), errs
    assert tasks.TASKS["pcn"] is tasks.pcn
    # the task takes a bare (points,) batch too
    assert torch.equal(tasks.pcn(tm, (torch.from_numpy(batch[0]),))[0], tloss)


def test_emd_loss_on_the_coarse_output_matches_jax():
    """emd_loss_mean(points, coarse_output) through PCN, forward and
    backward, against ``jax.value_and_grad`` of the JAX loss: the loss to
    rtol 1e-4 (K13's plain version against the JAX package's XLA path) and
    every parameter gradient to 1e-3 of its norm (the EMD gradients agree
    to ~1e-6 of their mean at this size; the JAX package's bound for one
    point's gradient is 5% of the mean, see tests/test_torch_emd.py)."""
    x = points(5)
    jm = jax_pcn(False, seed=6)
    flat = nnx_flat(jm)
    loss, grads = nnx.value_and_grad(
        lambda m: jlosses.emd_loss_mean(jnp.asarray(x), m(jnp.asarray(x))["coarse_output"]))(jm)
    tm = port_pcn(flat, False)
    tloss = emd_loss_mean(torch.from_numpy(x), tm(torch.from_numpy(x))["coarse_output"])
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
    want = nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.to_flat_state(grads)})
    errs = {n: norm_rel(p.grad.numpy(), want[n]) for n, p in tm.named_parameters()}
    assert all(e <= 1e-3 for e in errs.values()), errs


@pytest.mark.parametrize("detailed", [False, True])
def test_trainer_step_matches_jax(detailed, tmp_path):
    """One ``Trainer.train_step`` of the pcn task (Adam 1e-3) against the
    JAX ``Trainer._train_step`` on the same weights and (points, labels)
    batch: the loss, the aux, the gradients applied and the parameters
    after (``check_adam_first_step``)."""
    batch = pcn_batch()
    jm = jax_pcn(detailed, seed=8)
    before = nnx_flat(jm)
    tr = JTrainer(JTrainConfig(batch_size=B, task="pcn", lr=LR, ckpt_dir=str(tmp_path / "j")), jm)
    tr._tx = optax.chain(keep_grads(), optax.adam(LR))
    tr.optimizer = nnx.Optimizer(tr.model, tr._tx, wrt=nnx.Param)
    jloss, jaux = tr._train_step(tr.model, tr.optimizer, batch, jax.random.PRNGKey(0))
    applied = nnx_to_torch({".".join(map(str, p[2:])): np.asarray(v.get_value())
                            for p, v in nnx.to_flat_state(nnx.state(tr.optimizer)) if p[:2] == ("opt_state", 0)})
    after = nnx_to_torch(nnx_flat(jm))

    model = port_pcn(before, detailed)
    ttr = Trainer(TrainConfig(batch_size=B, task="pcn", lr=LR, ckpt_dir=str(tmp_path / "t")), model, device="cpu")
    assert ttr.loss_fn is tasks.pcn and ttr.augment_fn is None
    ttr._ensure_optimizer(1)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, aux = ttr.train_step(tuple(torch.from_numpy(a) for a in batch))
    assert abs(float(loss) - float(jloss)) <= TASK_TOL["loss"] * abs(float(jloss))
    for key in jaux:
        assert abs(float(aux[key]) - float(jaux[key])) <= TASK_TOL["loss"] * abs(float(jaux[key]))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    errs = {n: norm_rel(g, applied[n]) for n, g in grads.items()}
    assert all(e <= TASK_TOL["grad"] for e in errs.values()), errs
    check_adam_first_step(model, start, grads, applied, after, LR)
    ttr.close()


def test_load_nnx_state_carries_pcn():
    """Every PCN parameter crosses, conv5's (emb + 5, 512) kernel as one
    weight whose first 5 input columns are the grid's and the center's."""
    jm = jax_pcn(True, seed=9)
    flat = nnx_flat(jm)
    tm = port_pcn(flat, True)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    np.testing.assert_array_equal(tm.conv5.weight.detach().numpy(), flat["conv5.kernel"].T)
    assert tm.conv5.weight.shape == (512, EMB + 5)
