"""The port's CurveNet against the JAX package's, on the CPU: the
straight-through one-hot and its gradient; the walk, LPFA, the curve
aggregation and grouping, the masked max pool, the attention gate and the
feature propagation, and CIC blocks (with curves, with a masked max pool)
at N <= 256; the whole model at B=1, N=1024, k=8 in eval mode, on K8's
sharing (one kNN at the input's resolution); the gradients of a CIC block
with curves. The walk's picks are held equal wherever the top two logits
lie apart, each such check with a control that must fail it. Weights cross
as numpy through ``load_nnx_state``; inputs are made with numpy from seeds.
The JAX CurveNet is built once for the file and its forward jitted.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from learning3d_tpu.data import dataloaders as jdata
from learning3d_tpu.models import curvenet as jcn
from learning3d_tpu.utils import curvenet_blocks as jcb
from learning3d_tpu_torch.models import CurveNet
from learning3d_tpu_torch.models.masknet import top_indices
from learning3d_tpu_torch.ops import geometry as tgeo
from learning3d_tpu_torch.utils import curvenet_blocks as tcb
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, nnx_to_torch
from torch_port_util import hold_to_jax, max_rel, nnx_flat, randomize_bn

B = 2
# eval mode: the same math in other sum orders, 1e-5 of max. Train mode:
# the port's f64 to JAX's f64 (F64_TOL), its f32 no further from JAX's f64
# than twice JAX's own f32 plus TRAIN_F32_TOL (the train-mode BatchNorms'
# fast variance loses digits where a channel barely varies, in both
# packages)
TOL, F64_TOL, TRAIN_F32_TOL = 1e-5, 1e-5, 1e-4
# a pick is firm where the step's two largest logits lie more than PICK_GAP
# apart: 20x over the two packages' f32 rounding of a logit (BatchNorm'd,
# about 1; ~1e-6 apart). Random weights leave 3.4% of the whole model's
# 2,000 picks (B=1, N=1024) under 1e-4 apart and 0.55% under PICK_GAP (the
# smallest gap 1.6e-6); its logits agree all the same
PICK_GAP = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def hold(port, module, mode, *args):
    return hold_to_jax(port, module, mode, *args, tol=TOL, f64_tol=F64_TOL, train_f32_tol=TRAIN_F32_TOL)


def cloud(seed, b=B, n=256):
    """Clouds of SyntheticModelNet40 (the training data's distribution)."""
    data = jdata.SyntheticModelNet40(num_points=n, size=b, seed=seed)
    return np.stack([data[i][0] for i in range(b)]).astype(np.float32)


def feats(seed, n=256, c=16, b=B):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


def port_block(cls, jb, *args, **kw):
    return load_nnx_state(cls(*args, device="cpu", **kw), nnx_flat(jb))


@contextlib.contextmanager
def recorded_gaps():
    """The gap between the two largest logits of each step of every port
    walk run inside (B, n) arrays, in order."""
    gaps = []
    inner = tcb.st_gumbel_softmax

    def record(logits, dim=-1, temperature=1.0):
        top2 = torch.topk(logits.detach(), 2, dim=dim).values
        gaps.append((top2[..., 0] - top2[..., 1]).numpy())
        return inner(logits, dim=dim, temperature=temperature)

    tcb.st_gumbel_softmax = record
    try:
        yield gaps
    finally:
        tcb.st_gumbel_softmax = inner


@contextlib.contextmanager
def no_crossover():
    """The control: a walk without its crossover suppression."""
    inner = tcb.Walk.__dict__["_crossover"]  # the staticmethod itself
    tcb.Walk._crossover = staticmethod(lambda cur, nbr: torch.ones(nbr.shape[:-1], dtype=nbr.dtype))
    try:
        yield
    finally:
        tcb.Walk._crossover = inner


def curve_picks(curves, x):
    """The point each curve step stands on: its feature is that point's row
    of x times (1 - y) + y (one rounding from 1), so the nearest row."""
    d = ((np.asarray(curves, np.float64)[:, :, :, None, :] - np.asarray(x, np.float64)[:, None, None]) ** 2).sum(-1)
    return d.argmin(-1)  # (B, n, L)


def check_picks(got_picks, want_picks, gaps, min_firm=0.9):
    """The picks of every curve equal JAX's up to its first step whose pick
    is not firm (after a flip the curves part); at least ``min_firm`` of the
    curves firm throughout. An exact tie (gap 0: neighbours of equal
    features, such as the rows a saturated attention zeroes) is firm: each
    package computes equal logits there and takes the first. -> the share
    of firm curves."""
    gaps = np.stack(gaps, -1)
    firm = np.cumprod((gaps > PICK_GAP) | (gaps == 0.0), axis=-1).astype(bool)  # (B, n, L)
    assert firm[..., -1].mean() >= min_firm, firm[..., -1].mean()
    np.testing.assert_array_equal(got_picks[firm], want_picks[firm])
    return float(firm[..., -1].mean())


def test_st_gumbel_softmax_and_its_gradient_match_jax():
    """Forward: the one-hot (to one rounding of 1) at the first maximum of
    the softmax, ties included; backward: the softmax's gradient."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 6)).astype(np.float32)
    logits[0, 0, 2] = logits[0, 0, 4] = 5.0  # a tie: the first index wins in both
    w = rng.normal(size=logits.shape).astype(np.float32)
    for axis in (-1, 1):
        want, want_g = jax.value_and_grad(lambda x: jnp.sum(jcb.st_gumbel_softmax(x, axis=axis) * w))(
            jnp.asarray(logits))
        x = t(logits).requires_grad_()
        out = tcb.st_gumbel_softmax(x, dim=axis)
        (out * t(w)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy().argmax(axis), np.asarray(
            jcb.st_gumbel_softmax(jnp.asarray(logits), axis=axis)).argmax(axis))
        assert abs((out * t(w)).sum().item() - float(want)) <= 1e-5 * abs(float(want))
        assert max_rel(x.grad, want_g) <= 1e-5
    assert tcb.st_gumbel_softmax(t(logits))[0, 0].argmax().item() == 2


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_walk_picks_and_curves_match_jax(mode):
    """The walk over 128 points (k 8, 12 curves of 5 steps): the picks equal
    JAX's wherever firm, the curves to TOL in eval mode; the control (no
    crossover suppression) moves firm picks."""
    n, c, k = 128, 16, 8
    xyz = cloud(2, n=n)
    x = feats(3, n=n, c=c)
    adj = np.asarray(jax.vmap(lambda p: jnp.argsort(jnp.sum((p[:, None] - p[None]) ** 2, -1), axis=-1)[:, 1:k + 1])(
        jnp.asarray(xyz)))
    start = np.stack([np.random.default_rng(4 + i).choice(n, 12, replace=False) for i in range(B)])
    jw = jcb.Walk(c, k, 12, 5, rngs=nnx.Rngs(5))
    randomize_bn(jw, np.random.default_rng(6))
    getattr(jw, mode)()
    tw = port_block(tcb.Walk, jw, c, k, 12, 5)
    with recorded_gaps() as gaps:
        got, want = hold(tw, jw, mode, xyz, x, adj, start)
    gaps = gaps[-5:]  # the f32 run's five steps (train mode runs f64 first)
    assert got.shape == (B, 12, 5, c)
    check_picks(curve_picks(got, x), curve_picks(want, x), gaps)
    with no_crossover(), torch.no_grad(), recorded_gaps() as gaps_c:
        control = getattr(tw, mode)()(t(xyz), t(x), t(adj), t(start))
    with pytest.raises(AssertionError):
        check_picks(curve_picks(control, x), curve_picks(want, x), gaps_c)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("initial", [True, False])
def test_lpfa_matches_jax(initial, mode):
    n, c, k = 200, 16, 8
    xyz, x = cloud(7, n=n), feats(8, n=n, c=c)
    cin = 9 if initial else c
    jb = jcb.LPFA(cin, 24, k, mlp_num=2, initial=initial, rngs=nnx.Rngs(9))
    randomize_bn(jb, np.random.default_rng(10))
    getattr(jb, mode)()
    tb = port_block(tcb.LPFA, jb, cin, 24, k, mlp_num=2, initial=initial)
    got, _ = hold(tb, jb, mode, xyz if initial else x, xyz)  # idx None: its own kNN
    assert got.shape == (B, n, 24)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_masked_max_pool_matches_jax(mode):
    """FPS from point 0, the ball query and the max: bit for bit."""
    xyz, x = cloud(11), feats(12, c=32)
    for npoint, radius in ((64, 0.2), (128, 0.1)):
        want_xyz, want = jcb.MaskedMaxPool(npoint, radius, 8)(jnp.asarray(xyz), jnp.asarray(x))
        got_xyz, got = getattr(tcb.MaskedMaxPool(npoint, radius, 8), mode)()(t(xyz), t(x))
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_curve_aggregation_matches_jax(mode):
    jb = jcb.CurveAggregation(16, rngs=nnx.Rngs(13))
    randomize_bn(jb, np.random.default_rng(14))
    getattr(jb, mode)()
    tb = port_block(tcb.CurveAggregation, jb, 16)
    curves = np.random.default_rng(15).normal(size=(B, 10, 5, 16)).astype(np.float32)
    got, _ = hold(tb, jb, mode, feats(16), curves)
    assert got.shape == (B, 256, 16)


@pytest.mark.parametrize("saturated", [False, True])
def test_curve_grouping_matches_jax(saturated):
    """The start points in lax.top_k's order, also where the attention's
    sigmoid saturates to 1.0 on many points (ties), and the walk from
    them."""
    n, c, k = 256, 16, 8
    xyz, x = cloud(17), feats(18, c=c)
    idx = tgeo.knn(t(xyz), k + 1)[..., 1:].numpy()
    jb = jcb.CurveGrouping(c, k, 10, 4, rngs=nnx.Rngs(19))
    randomize_bn(jb, np.random.default_rng(20))
    if saturated:
        jb.att.kernel.set_value(jb.att.kernel.get_value() * 60.0)
    jb.eval()
    tb = port_block(tcb.CurveGrouping, jb, c, k, 10, 4).eval()
    att = np.asarray(jax.nn.sigmoid(jnp.asarray(x) @ jb.att.kernel.get_value()))  # (B, N, 1)
    assert ((att[..., 0] == 1.0).sum(-1) > 10).all() == saturated  # more tied scores than curves
    with recorded_gaps() as gaps:
        got, want = hold(tb, jb, "eval", x, xyz, idx)
    assert got.shape == (B, 10, 4, c)
    # saturated, the attention zeroes about half of the rows too, and the
    # rows it nearly zeroes tie within PICK_GAP: fewer curves are firm (0.65)
    check_picks(curve_picks(got, x * att), curve_picks(want, x * att), gaps, 0.5 if saturated else 0.9)
    np.testing.assert_array_equal(top_indices(t(att[..., 0]), 10).numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(att[..., 0]), 10)[1]))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("s", [1, 32])
def test_feature_propagation_with_attention_matches_jax(s, mode):
    """Three-NN interpolation (or the broadcast of one point) with the
    attention gate on the skip features."""
    jb = jcb.PointNetFeaturePropagation(16 + 8, [32, 16], att=[8, 16, 8], rngs=nnx.Rngs(21))
    randomize_bn(jb, np.random.default_rng(22))
    getattr(jb, mode)()
    tb = port_block(tcb.PointNetFeaturePropagation, jb, 16 + 8, [32, 16], att=[8, 16, 8])
    xyz1, xyz2 = cloud(23, n=128), cloud(24, n=s) if s > 1 else np.zeros((B, 1, 3), np.float32)
    got, _ = hold(tb, jb, mode, xyz1, xyz2, feats(25, n=128, c=16), feats(26, n=s, c=8))
    assert got.shape == (B, 128, 16)


def jax_cic(seed, npoint, radius, cin, cout, conf):
    jb = jcb.CIC(npoint, radius, 8, cin, cout, bottleneck_ratio=2, mlp_num=1, curve_config=conf,
                 rngs=nnx.Rngs(seed))
    randomize_bn(jb, np.random.default_rng(seed + 1))
    return jb


def port_cic(jb, npoint, radius, cin, cout, conf):
    return port_block(tcb.CIC, jb, npoint, radius, 8, cin, cout, bottleneck_ratio=2, mlp_num=1, curve_config=conf)


CIC_CASES = {"curves": (256, 0.1, 16, 32, [12, 4]), "pool": (64, 0.2, 32, 32, None)}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(CIC_CASES))
def test_cic_matches_jax(case, mode):
    """A CIC block with curves at its resolution (its own kNN), and one that
    max-pools 256 points to 64 first; its output to TOL (so every pick
    agrees), 90% of its picks firm; the control moves it past TOL."""
    npoint, radius, cin, cout, conf = CIC_CASES[case]
    jb = jax_cic(27, npoint, radius, cin, cout, conf)
    getattr(jb, mode)()
    tb = port_cic(jb, npoint, radius, cin, cout, conf)
    xyz, x = cloud(28), feats(29, c=cin)
    with recorded_gaps() as gaps:
        (got_xyz, got, got_idx), (want_xyz, want, want_idx) = hold(tb, jb, mode, xyz, x)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    assert got.shape == (B, npoint, cout) and got_idx.shape == (B, npoint, 9)
    if conf is None:
        assert not gaps
        return
    assert np.mean([(g > PICK_GAP).mean() for g in gaps]) >= 0.9
    with no_crossover(), torch.no_grad():
        control = getattr(tb, mode)()(t(xyz), t(x))[1]
    assert max_rel(control, want) > TOL


def test_cic_reuses_the_knn_it_is_given():
    """With ``idx`` given (the blocks of one resolution share one kNN) the
    block runs no kNN of its own."""
    npoint, radius, cin, cout, conf = CIC_CASES["curves"]
    tb = port_cic(jax_cic(27, npoint, radius, cin, cout, conf), npoint, radius, cin, cout, conf).eval()
    xyz, x = t(cloud(28)), t(feats(29, c=cin))
    idx = tgeo.knn(xyz, 9)
    calls = []
    knn = tcb.knn
    tcb.knn = lambda *a, **kw: calls.append(a) or knn(*a, **kw)
    try:
        with torch.no_grad():
            _, out_given, idx_out = tb(xyz, x, idx=idx)
            _, out_own, _ = tb(xyz, x)
    finally:
        tcb.knn = knn
    assert idx_out is idx and len(calls) == 1
    assert torch.equal(out_given, out_own)


# gradients of a CIC block with curves in train mode (loss sum(out * w)):
# the port's f64 gradients to JAX's jitted f64 ones to GRAD_TOL of each
# tensor's norm; its f32 gradients, as one vector, no further from JAX's f64
# than twice JAX's own f32 plus F32_SLACK. The biases in front of a
# train-mode BatchNorm cancel (held against their layer's weight gradient)
GRAD_TOL, F32_SLACK = 1e-6, 1e-3


def cic_grads_jax(jb, xyz, x, w, x64):
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        grad = nnx.jit(lambda m, p, f: nnx.grad(lambda m: jnp.sum(m(p, f)[1] * w.astype(dt)))(m))
        g = grad(nnx.clone(jb), jnp.asarray(xyz.astype(dt)), jnp.asarray(x.astype(dt)))
        return nnx_to_torch({".".join(map(str, p)): np.asarray(v.get_value(), np.float64)
                             for p, v in nnx.to_flat_state(g)})


def cic_grads_port(tb, xyz, x, w, dtype):
    tb = tb.to(dtype).train()
    (tb(t(xyz).to(dtype), t(x).to(dtype))[1] * t(w).to(dtype)).sum().backward()
    return {n: p.grad.double().numpy() for n, p in tb.named_parameters()}


def grad_gaps(grads, want):
    def ref(n):
        return n.rsplit(".", 1)[0] + ".weight" if n.endswith("lin.bias") else n

    assert set(grads) == set(want)
    return {n: float(np.linalg.norm(g - want[n]) / max(np.linalg.norm(want[ref(n)]), 1e-30))
            for n, g in grads.items()}


def whole_gap(grads, want):
    names = sorted(want)
    a, b = (np.concatenate([g[n].ravel() for n in names]) for g in (grads, want))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_cic_gradients_match_jax():
    npoint, radius, cin, cout, conf = CIC_CASES["curves"]
    jb = jax_cic(30, npoint, radius, cin, cout, conf)
    jb.train()
    xyz, x = cloud(31), feats(32, c=cin)
    w = np.random.default_rng(33).normal(size=(B, npoint, cout)).astype(np.float32)
    g64 = cic_grads_jax(jb, xyz, x, w, True)
    g32 = cic_grads_jax(jb, xyz, x, w, False)
    p64 = cic_grads_port(port_cic(jb, npoint, radius, cin, cout, conf), xyz, x, w, torch.float64)
    gaps = grad_gaps(p64, g64)
    assert max(gaps.values()) <= GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])
    assert {n.split(".")[0] for n, g in p64.items() if np.abs(g).max() > 0} >= {"curvegrouping", "curveaggregation"}
    p32 = cic_grads_port(port_cic(jb, npoint, radius, cin, cout, conf), xyz, x, w, torch.float32)
    assert whole_gap(p32, g64) <= 2 * whole_gap(g32, g64) + F32_SLACK
    with no_crossover():
        control = cic_grads_port(port_cic(jb, npoint, radius, cin, cout, conf), xyz, x, w, torch.float64)
    assert max(grad_gaps(control, g64).values()) > GRAD_TOL


@pytest.fixture(scope="module")
def jax_curvenet():
    """JAX's CurveNet (k 8, the default curves), built once for the file."""
    jm = jcn.CurveNet(k=8, rngs=nnx.Rngs(40))
    randomize_bn(jm, np.random.default_rng(41))
    return jm


def test_load_nnx_state_carries_curvenet(jax_curvenet):
    flat = nnx_flat(jax_curvenet)
    tm = load_nnx_state(CurveNet(k=8, device="cpu"), flat)
    assert set(tm.state_dict()) == set(nnx_to_torch(flat))
    np.testing.assert_array_equal(tm.cic12.curvegrouping.walk.agent_bn.running_var.numpy(),
                                  flat["cic12.curvegrouping.walk.agent_bn.var"])
    assert tm.cic31.shortcut is not None and tm.cic32.shortcut is None and not tm.cic41.use_curve
    with pytest.raises(ValueError):
        CurveNet(setting="short", device="cpu")


def test_curvenet_matches_jax(jax_curvenet):
    """The whole model in eval mode at B=1, N=1024 (the architecture's
    npoints): the logits to TOL (so every pick of its four curve blocks
    agrees), 90% of those picks firm; one kNN at 1024 points (K8's on the card), one at 256 and one at
    64; the input in bcn order the same."""
    jm = nnx.clone(jax_curvenet)
    jm.eval()
    x = cloud(42, b=1, n=1024)
    tm = load_nnx_state(CurveNet(k=8, device="cpu"), nnx_flat(jm)).eval()
    calls = []
    knn = tcb.knn
    from learning3d_tpu_torch.models import curvenet as tcn
    top = tcn.knn
    tcb.knn = lambda p, k: calls.append(p.shape[1]) or knn(p, k)
    tcn.knn = lambda p, k: calls.append(p.shape[1]) or top(p, k)
    try:
        with recorded_gaps() as gaps:
            got, want = hold(tm, jm, "eval", x)
    finally:
        tcb.knn, tcn.knn = knn, top
    assert got.shape == (1, 40)
    assert sorted(calls) == [64, 256, 1024]
    assert len(gaps) == 20 and np.mean([(g > PICK_GAP).mean() for g in gaps]) >= 0.9
    assert int(np.argmax(want)) == int(got.argmax())
    bcn = load_nnx_state(CurveNet(k=8, input_shape="bcn", device="cpu"), nnx_flat(jm)).eval()
    with torch.no_grad():
        assert torch.equal(bcn(t(x).transpose(1, 2)), got)
        with no_crossover():
            assert max_rel(tm(t(x)), want) > TOL  # the control
