#!/usr/bin/env python
"""How the trained releases condition the port's checks, on the CPU, where
JAX is (run from the repository's root):

    JAX_PLATFORMS=cpu python tools/trained_cpu_gaps.py [grads] [rpmnet] [flownet] [classifier]

Each part prints one JSON line.

- ``grads``: the gradients of one train-mode task step of the trained PRNet
  (``r4_prnet``: a 192-point template, a 144-point partial source, 96
  keypoints, B=2), FlowNet3D (``r4_flownet``: N=1024, B=1) and RPMNet
  (``r4b_rpmnet``: N=256, B=2), in the port (f32, f64) and in the JAX
  package (eager f32, jitted f32, eager x64, every JAX variable cast to
  f64), each tensor's error over the norm of the x64 one: the largest and
  the median of JAX's eager f32, its jitted f32 and the port's f32 against
  JAX's x64, and of the port's f64; tensors whose x64 gradient is below
  1e-4 of the largest (an exact 0 in rounding) apart.
  Random weights made these gradients ill-conditioned (``PERF.md`` §7).
- ``rpmnet``: the trained RPMNet on the 16 stored pairs of its eval set (the
  converter's ``reference_predictions.npz``), with the Sinkhorn's output
  replaced as the card's checks see it: K17's correctly rounded result (the
  plain version in f64, rounded once; its backward the plain version's, as
  K17's), the plain output moved up one ulp, that f64 result with noise of
  1e-12 before the rounding, and bf16 (chip_smoke.py's control): est_T at
  one and two iterations against the plain path (max |d| / max |p|, the
  worst pair), and one Adam-configuration task step at one and two
  iterations (chip_smoke.py's ``step_differences``, the weight network's
  gradients apart: ``apart_gap``); and est_T with the card's selection arithmetic
  (``ball_group_reference``'s exact differences for the grouping) against
  JAX's stored est_T, the worst pair and each pair (max |d| over the pair /
  max |JAX's| over all 16); the weight network's beta and alpha on these pairs
  (their range).
- ``flownet``: the trained FlowNet3D's flow on its 16 stored pairs with the
  card's selection arithmetic (the plain versions of K15 and K8 in place of
  the CPU path's matmul expansion) against JAX's stored flow.
- ``classifier``: phase 16's step on the trained ``r4_pointnet_cls`` (its
  B=256 batch, bf16 and f32) on the plain versions against the same step
  with K3's sums exact (chip_smoke.py's ``plain_f64_sums``) and with the
  control ``k3_misplaced``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import convert_release_torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
TRAINED = ROOT / "learning3d_tpu_torch" / "trained"
ARGS = SimpleNamespace(emb_dims=1024, nearest_neighbors=20, seed=0)


def restore(name, task, jmodel):
    """The JAX model with the release's weights (the converter's restore)."""
    return convert_release_torch.restore(name, task, jmodel, ROOT / "releases")[0]


nnx_flat = convert_release_torch.nnx_flat


def summary(errors) -> dict:
    values = np.array(list(errors.values()))
    worst = max(errors, key=errors.get)
    return {"max": float(values.max()), "median": float(np.median(values)), "worst": worst}


def grad_gaps(name, jtask, ttask, jmodel, tmodel, batch) -> dict:
    """Per-tensor gradient errors over the x64 gradient's norm."""
    import jax
    import jax.numpy as jnp
    import torch
    from flax import nnx

    from learning3d_tpu_torch.utils.jax_import import nnx_to_torch

    def jax_grads(m, b, jit):
        def fn(mm, bb):
            return nnx.value_and_grad(lambda m2: jtask(m2, bb, None), has_aux=True)(mm)

        _, g = (nnx.jit(fn) if jit else fn)(m, b)
        return nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                             for p, v in nnx.to_flat_state(g)})

    runs = {}
    for label, jit in (("jax_eager_f32", False), ("jax_jit_f32", True)):
        m = nnx.clone(jmodel)
        m.train()
        runs[label] = jax_grads(m, tuple(jnp.asarray(a) for a in batch), jit)
    with jax.enable_x64(True):
        m = nnx.clone(jmodel)
        m.train()
        graphdef, state = nnx.split(m)  # every variable in f64, the BN statistics too
        m = nnx.merge(graphdef, jax.tree.map(lambda v: v.astype(jnp.float64) if v.dtype == jnp.float32 else v, state))
        want = jax_grads(m, tuple(jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f" else a) for a in batch),
                         False)
    for label, dtype in (("port_f32", torch.float32), ("port_f64", torch.float64)):
        model = copy.deepcopy(tmodel).to(dtype).train()
        loss, _ = ttask(model, tuple(torch.from_numpy(a).to(dtype) if a.dtype.kind == "f" else torch.from_numpy(a)
                                     for a in batch))
        loss.backward()
        runs[label] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
                       for n, p in model.named_parameters()}  # no loss term reaches some (the Trainer's zeros)
    # tensors whose exact gradient is 0 (biases in front of a train-mode
    # BatchNorm, the key projections' biases) carry rounding noise alone:
    # they are counted apart, with their error over the largest gradient norm
    norms = {n: np.linalg.norm(g) for n, g in want.items()}
    floor = 1e-4 * max(norms.values())
    out = {"tensors": len(norms), "near_zero": int(sum(v <= floor for v in norms.values()))}
    for label, grads in runs.items():
        errors = {n: float(np.linalg.norm(g - want[n]) / norms[n]) for n, g in grads.items() if norms[n] > floor}
        noise = max(float(np.linalg.norm(g - want[n])) for n, g in grads.items() if norms[n] <= floor) \
            if out["near_zero"] else 0.0
        out[f"{label}_vs_jax_x64"] = {**summary(errors), "near_zero_over_largest": noise / max(norms.values())}
    return {"model": name, **out}


def part_grads() -> None:
    import torch
    from flax import nnx

    from learning3d_tpu import models as jmodels
    from learning3d_tpu.data import dataloaders as jdata
    from learning3d_tpu.train import tasks as jtasks
    from learning3d_tpu_torch.examples.train import build_model
    from learning3d_tpu_torch.models import PRNet
    from learning3d_tpu_torch.train import tasks
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    torch.set_num_threads(8)
    jm = restore("r4_prnet", "prnet", jmodels.PRNet(num_keypoints=96, num_subsampled_points=144, rngs=nnx.Rngs(0)))
    tm = load_nnx_state(PRNet(num_keypoints=96, num_subsampled_points=144, device="cpu"), nnx_flat(jm))
    data = jdata.RegistrationData("PRNet", jdata.SyntheticModelNet40(train=False, num_points=192, size=2))
    t, s, igt = (np.stack([data[i][j] for i in range(2)]) for j in range(3))
    rng = np.random.default_rng(0)
    s = np.stack([jdata.farthest_subsample_points(x, 144, rng=rng)[0] for x in s]).astype(np.float32)
    print(json.dumps(grad_gaps("r4_prnet", jtasks.prnet, tasks.prnet, jm, tm, (t, s, igt))), flush=True)

    jm = restore("r4_flownet", "flow", jmodels.FlowNet3D(rngs=nnx.Rngs(0)))
    tm = load_nnx_state(build_model("flownet", ARGS, None, "cpu"), nnx_flat(jm))
    item = jdata.SyntheticSceneflow(npoints=1024, size=256)[0]
    batch = tuple(np.asarray(a)[None] for a in item)
    print(json.dumps(grad_gaps("r4_flownet", jtasks.flownet, tasks.flownet, jm, tm, batch)), flush=True)

    jm = restore("r4b_rpmnet", "rpmnet", jmodels.RPMNet(rngs=nnx.Rngs(0)))
    tm = load_nnx_state(build_model("rpmnet", ARGS, None, "cpu"), nnx_flat(jm))
    data = jdata.RegistrationData("RPMNet", jdata.SyntheticModelNet40(train=False, num_points=256, size=2,
                                                                       use_normals=True))
    batch = tuple(np.stack([data[i][j] for i in range(2)]) for j in range(3))
    print(json.dumps(grad_gaps("r4b_rpmnet", jtasks.rpmnet, tasks.rpmnet, jm, tm, batch)), flush=True)


def sinkhorn_variants():
    """name -> a replacement of ``sinkhorn.sinkhorn_log_pallas`` on CPU
    tensors (see the module docstring)."""
    import torch

    from learning3d_tpu_torch.kernels import sinkhorn

    ref = sinkhorn.sinkhorn_slack_reference

    def rounded(noise):
        g = torch.Generator().manual_seed(1)

        class F64(torch.autograd.Function):
            @staticmethod
            def forward(ctx, la, n):
                ctx.save_for_backward(la)
                ctx.n = n
                out = ref(la.detach().double(), n)
                if noise:
                    out = out + noise * (torch.rand(out.shape, generator=g, dtype=torch.float64) - 0.5)
                return out.float()

            @staticmethod
            def backward(ctx, grad):
                (la,) = ctx.saved_tensors
                with torch.enable_grad():
                    x = la.detach().float().requires_grad_(True)
                    (gx,) = torch.autograd.grad(ref(x, ctx.n), x, grad)
                return gx, None

        return lambda la, n_iters=5: F64.apply(la, n_iters)

    def up(la, n_iters=5):
        out = ref(la, n_iters)
        return out + (torch.nextafter(out.detach(), torch.full_like(out, float("inf"))) - out.detach())

    return {"k17_correctly_rounded": rounded(0.0), "one_ulp_up": up, "f64_noise_1e-12": rounded(1e-12),
            "bf16_control": lambda la, n_iters=5: ref(la, n_iters).to(torch.bfloat16).float()}


def card_grouping(radius, nsample, xyz, new_xyz, itself):
    """PPFNet's CPU grouping with K16's plain version's arithmetic (exact
    coordinate differences): the indices, read off a gathered index channel."""
    import torch

    from learning3d_tpu_torch.kernels import sampling

    b, n, _ = xyz.shape
    vals = torch.arange(n, dtype=torch.float32).expand(b, n)[..., None].contiguous()
    return sampling.ball_group_reference(radius, nsample, xyz.detach(), new_xyz.detach(), itself, vals)[..., 0].long()


def part_rpmnet() -> None:
    import chip_smoke as cs
    import torch

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40
    from learning3d_tpu_torch.examples.train import build_model
    from learning3d_tpu_torch.kernels import sinkhorn
    from learning3d_tpu_torch.ops import grouping
    from learning3d_tpu_torch.train import TrainConfig, Trainer

    torch.set_num_threads(8)
    ref = dict(np.load(TRAINED / "r4b_rpmnet" / "best" / "reference_predictions.npz"))
    state = torch.load(TRAINED / "r4b_rpmnet" / "best" / "model.pt", weights_only=True)
    data = RegistrationData("RPMNet", SyntheticModelNet40(train=False, num_points=1024, size=2048, use_normals=True))
    batch = tuple(torch.from_numpy(np.stack([data[i][j] for i in range(16)])) for j in range(3))

    def model(iterations):
        m = build_model("rpmnet", ARGS, None, "cpu")
        m.load_state_dict(state)
        m.default_iterations = iterations
        return m

    def run(iterations):
        m = model(iterations)
        with torch.no_grad():
            est = m.eval()(batch[0], batch[1])["est_T"]
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = TrainConfig(exp_name="gaps", task="rpmnet", batch_size=16, num_points=1024, optimizer="adam",
                              lr=1e-3, epochs=1, ckpt_dir=ckpt)
            loss, _ = Trainer(cfg, m.train(), device="cpu").forward_backward(batch)
        return est, (loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}, dict(m.named_buffers()))

    plain = sinkhorn.sinkhorn_log_pallas
    out = {}
    for iterations in (1, 2):
        base_est, base_step = run(iterations)
        for label, fn in sinkhorn_variants().items():
            sinkhorn.sinkhorn_log_pallas = fn
            try:
                est, step = run(iterations)
            finally:
                sinkhorn.sinkhorn_log_pallas = plain
            worst, _ = cs.step_differences(cs.without_apart(step), cs.without_apart(base_step), cs.RPM_STEP_TOL,
                                           (), cs.RPM_NOISE_TOL)
            out[f"iters_{iterations}_{label}"] = {
                "est_T": float((est - base_est).abs().max() / base_est.abs().max()),
                "step": {**{k: worst[k] for k in ("loss", "grad", "grad_tensor")}, **cs.apart_gap(step, base_step)}}
    m = model(2)
    scale = np.abs(ref["est_T"]).max()
    saved = grouping.query_ball_point_excluding_self
    with torch.no_grad():
        cpu = m.eval()(batch[0], batch[1])["est_T"].numpy()
        grouping.query_ball_point_excluding_self = card_grouping
        try:
            card = m(batch[0], batch[1])["est_T"].numpy()
        finally:
            grouping.query_ball_point_excluding_self = saved
    with torch.no_grad():
        beta, alpha = m.weights_net(batch[1][..., :3], batch[0][..., :3])
    out["beta"], out["alpha"] = [float(beta.min()), float(beta.max())], [float(alpha.min()), float(alpha.max())]
    for key, est in (("vs_jax_cpu_path", cpu), ("vs_jax_card_selection", card)):
        per_pair = np.abs(est - ref["est_T"]).reshape(16, -1).max(-1) / scale
        out[key], out[f"{key}_per_pair"] = float(per_pair.max()), per_pair.tolist()
    print(json.dumps({"model": "r4b_rpmnet", "pairs": 16, **out}), flush=True)


def part_flownet() -> None:
    import torch

    from learning3d_tpu_torch.data import SyntheticSceneflow
    from learning3d_tpu_torch.examples.train import build_model
    from learning3d_tpu_torch.kernels import knn, sampling
    from learning3d_tpu_torch.models import flownet3d

    torch.set_num_threads(8)
    ref = dict(np.load(TRAINED / "r4_flownet" / "best" / "reference_predictions.npz"))
    m = build_model("flownet", ARGS, None, "cpu")
    m.load_state_dict(torch.load(TRAINED / "r4_flownet" / "best" / "model.pt", weights_only=True))
    ds = SyntheticSceneflow(npoints=1024, size=256)
    inputs = [torch.from_numpy(np.stack([ds[i][j] for i in range(16)])) for j in range(4)]

    def ball(radius, nsample, xyz, new_xyz, get_cnt=False):
        return sampling.ball_query_reference(radius, nsample, xyz.detach(), new_xyz.detach(), dtype=torch.int64)

    def nearest(k, pos1, pos2, approx=False):
        sq, idx = knn.knn_reference(pos2.detach(), pos1.detach(), k)
        return torch.sqrt(torch.clamp(sq, min=0.0)), idx.long()

    saved = flownet3d.query_ball_point, flownet3d.knn_point
    with torch.no_grad():
        cpu = m.eval()(*inputs).numpy()
        flownet3d.query_ball_point, flownet3d.knn_point = ball, nearest
        try:
            card = m(*inputs).numpy()
        finally:
            flownet3d.query_ball_point, flownet3d.knn_point = saved
    scale = np.abs(ref["flow"]).max()
    gaps = {"vs_jax_cpu_path": float(np.abs(cpu - ref["flow"]).max() / scale),
            "vs_jax_card_selection": float(np.abs(card - ref["flow"]).max() / scale)}
    print(json.dumps({"model": "r4_flownet", "pairs": 16, **gaps}), flush=True)


def part_classifier() -> None:
    import chip_smoke as cs
    import torch

    from learning3d_tpu_torch.data import batch_iterator
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import Trainer

    torch.set_num_threads(8)
    state = torch.load(TRAINED / "r4_pointnet_cls" / "best" / "model.pt", weights_only=True)
    batch = [torch.from_numpy(np.asarray(a)) for a in next(batch_iterator(cs.train_data(), cs.B, seed=cs.SEED))]
    out = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        def build():
            model = Classifier(PointNet(emb_dims=cs.EMB, use_bn=True, dtype=dtype, device="cpu"), cs.CLASSES,
                               dtype=dtype, device="cpu", dropout_generator=torch.Generator().manual_seed(cs.SEED))
            model.load_state_dict(state)
            return model

        with tempfile.TemporaryDirectory() as ckpt:
            cfg = cs.train_config(ckpt)
            sync = torch.cuda.synchronize
            torch.cuda.synchronize = lambda *a: None  # step_runs synchronizes the card; here there is none
            try:
                runs = cs.step_runs(lambda: Trainer(cfg, build(), device="cpu"), batch,
                                    (contextlib.nullcontext, cs.plain_f64_sums, cs.k3_misplaced))
            finally:
                torch.cuda.synchronize = sync
        for label, run in (("f64_sums", runs[1]), ("control", runs[2])):
            worst, _ = cs.step_differences(run, runs[0], cs.STEP_TOL[kind], cs.ZERO_GRADIENT_BIASES, cs.NOISE_TOL)
            out[f"{kind}_{label}"] = {k: worst[k] for k in ("loss", "grad", "grad_tensor", "zero_gradient_bias")}
    print(json.dumps({"model": "r4_pointnet_cls", "B": cs.B, **out}), flush=True)


def main(argv) -> None:
    parts = {"grads": part_grads, "rpmnet": part_rpmnet, "flownet": part_flownet, "classifier": part_classifier}
    for name in argv or list(parts):
        parts[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
