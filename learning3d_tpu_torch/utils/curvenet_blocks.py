"""CurveNet's building blocks, counterpart of
``learning3d_tpu/utils/curvenet_blocks.py``: the guided curve walk with
crossover suppression and momentum, local point-feature aggregation (LPFA),
the curve-intervention residual block (CIC) with curve grouping and
aggregation, the masked max pool, and the attention U-Net feature
propagation. Channel-last (B, N, C), the JAX package's parameter names.

The picks follow the JAX package's: ``torch.argmax`` takes the first of
equal maxima as ``jnp.argmax`` does, and the curves' start points are a
stable descending sort (``models.masknet.top_indices``), the order
``lax.top_k`` gives among tied scores (saturated sigmoids tie), not
``torch.topk``, which promises none. The "gumbel" softmax is the
reference's deterministic straight-through one-hot (no noise is drawn).

On the card ``MaskedMaxPool`` samples on K14 and queries balls on K15, and
the kNN a CIC block builds (``ops.geometry.knn``) runs on K8 where the cloud
has >= 512 points; the selections are made on detached operands. The
crossover suppression carries no gradient, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops.geometry import (_smallest, farthest_point_sample, index_points, knn, query_ball_point,
                                               square_distance)
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear


def st_gumbel_softmax(logits, dim=-1, temperature=1.0):
    """The straight-through one-hot: forward (hard - y) + y, the one-hot of
    the argmax of y = softmax(logits / temperature) (the first of equal
    maxima), backward the gradient of y."""
    y = torch.softmax(logits / temperature, dim=dim)
    hard = F.one_hot(torch.argmax(y, dim=dim), y.shape[dim]).to(y.dtype).movedim(-1, dim)
    return (hard - y).detach() + y


class _ConvBNLRelu(nn.Module):
    """leaky_relu(bn(x @ W [+ b]), slope) over the last axis, or bn(...)
    alone with ``act=False``."""

    def __init__(self, i, o, act=True, bias=False, slope=0.2, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.lin = Linear(i, o, use_bias=bias, dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(o, dtype=dtype, device=device)
        self.act = act
        self.slope = slope

    def forward(self, x):
        x = self.bn(self.lin(x))
        return F.leaky_relu(x, self.slope) if self.act else x


class Walk(nn.Module):
    """The guided walk: xyz (B, N, 3), x (B, N, C), adj (B, N, k), start
    (B, n_curves) -> curves (B, n_curves, curve_length, C). Each step scores
    the current point's k neighbours (agent_lin and a train-mode
    BatchNorm(1)), damps neighbours that turn back (the crossover
    suppression, from the second step), and moves to the best, blending the
    previous descriptor with momentum (momentum_lin, BatchNorm(2))."""

    def __init__(self, in_channel, k, curve_num, curve_length, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.curve_num = curve_num
        self.curve_length = curve_length
        self.k = k
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.agent_lin = Linear(in_channel * 2, 1, use_bias=False, **kw)
        self.agent_bn = BatchNorm(1, dtype=dtype, device=device)
        self.momentum_lin = Linear(in_channel * 2, 2, use_bias=False, **kw)
        self.momentum_bn = BatchNorm(2, dtype=dtype, device=device)

    @staticmethod
    def _crossover(cur_dir, nbr_dir):
        """clip(1 + cos(cur_dir, nbr_dir), 0, 1) (B, n, k), without a
        gradient."""
        cur_dir, nbr_dir = cur_dir.detach(), nbr_dir.detach()  # (B, n, C), (B, n, k, C)
        dot = torch.einsum("bnc,bnkc->bnk", cur_dir, nbr_dir)
        n1 = torch.linalg.vector_norm(cur_dir, dim=-1)[..., None]
        n2 = torch.linalg.vector_norm(nbr_dir, dim=-1)
        ans = dot / torch.clamp(n1 * n2, min=1e-8)
        return torch.clamp(1.0 + ans, 0.0, 1.0)

    def forward(self, xyz, x, adj, start):
        cur = start  # (B, n)
        pre_feature = index_points(x, cur)  # (B, n, C)
        cur_feature = pre_feature
        curves = []
        for step in range(self.curve_length):
            if step > 0:
                cat_vec = torch.cat([cur_feature, pre_feature], dim=-1)
                att = torch.softmax(self.momentum_bn(self.momentum_lin(cat_vec)), dim=-1)  # (B, n, 2)
                pre_feature = cur_feature * att[..., 0:1] + pre_feature * att[..., 1:2]
            pick_idx = index_points(adj, cur)  # (B, n, k)
            pick_values = index_points(x, pick_idx)  # (B, n, k, C)
            logits_in = torch.cat([pick_values, pre_feature[:, :, None, :].expand(pick_values.shape)], dim=-1)
            logits = self.agent_bn(self.agent_lin(logits_in))[..., 0]  # (B, n, k)
            if step > 0:
                logits = logits * self._crossover(cur_feature - pre_feature,
                                                  pick_values - cur_feature[:, :, None, :])
            onehot = st_gumbel_softmax(logits, dim=-1)  # (B, n, k)
            new_feature = torch.einsum("bnk,bnkc->bnc", onehot, pick_values)
            choice = torch.argmax(onehot, dim=-1)  # (B, n)
            cur = torch.gather(pick_idx, -1, choice[..., None])[..., 0]
            cur_feature = new_feature
            curves.append(cur_feature)
        return torch.stack(curves, dim=2)


class AttentionBlock(nn.Module):
    """The attention U-Net gate: (psi, 1 - psi) with psi =
    sigmoid(bn(psi_lin(leaky_relu(bn(wg g) + bn(wx x), 0.2))))."""

    def __init__(self, F_g, F_l, F_int, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.wg_lin = Linear(F_g, F_int, **kw)
        self.wg_bn = BatchNorm(F_int, dtype=dtype, device=device)
        self.wx_lin = Linear(F_l, F_int, **kw)
        self.wx_bn = BatchNorm(F_int, dtype=dtype, device=device)
        self.psi_lin = Linear(F_int, 1, **kw)
        self.psi_bn = BatchNorm(1, dtype=dtype, device=device)

    def forward(self, g, x):
        psi = F.leaky_relu(self.wg_bn(self.wg_lin(g)) + self.wx_bn(self.wx_lin(x)), 0.2)
        psi = torch.sigmoid(self.psi_bn(self.psi_lin(psi)))
        return psi, 1.0 - psi


class LPFA(nn.Module):
    """Local point-feature aggregation over each point's k neighbours (their
    coordinates, offsets and, unless ``initial``, feature differences
    lifted by xyz2feat), a shared MLP, then the max (``initial``) or the
    mean over the neighbours."""

    def __init__(self, in_channel, out_channel, k, mlp_num=2, initial=False, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.k = k
        self.initial = initial
        if not initial:
            self.xyz2feat_lin = Linear(9, in_channel, use_bias=False, **kw)
            self.xyz2feat_bn = BatchNorm(in_channel, dtype=dtype, device=device)
        blocks = []
        ci = 9 if initial else in_channel
        for _ in range(mlp_num):
            blocks.append(_ConvBNLRelu(ci, out_channel, **kw))
            ci = out_channel
        self.mlp = nn.ModuleList(blocks)

    def _group(self, x, xyz, idx):
        if idx is None:
            idx = knn(xyz, self.k)
        nbr_xyz = index_points(xyz, idx)  # (B, N, k, 3)
        center = xyz[:, :, None, :].expand(nbr_xyz.shape)
        geo = torch.cat([center, nbr_xyz, nbr_xyz - center], dim=-1)  # (B, N, k, 9)
        if self.initial:
            return geo
        feat = index_points(x, idx) - x[:, :, None, :]  # (B, N, k, C)
        return F.leaky_relu(feat + self.xyz2feat_bn(self.xyz2feat_lin(geo)), 0.2)

    def forward(self, x, xyz, idx=None):
        h = self._group(x, xyz, idx)
        for blk in self.mlp:
            h = blk(h)
        return torch.amax(h, dim=2) if self.initial else torch.mean(h, dim=2)


class PointNetFeaturePropagation(nn.Module):
    """Three-NN inverse-distance interpolation of points2 (B, S, D) onto
    xyz1 (B, N, 3), with the skip features points1 gated by the attention
    block (``att``) and concatenated in front, then a shared MLP. The three
    nearest by the matmul expansion (``square_distance``) and a stable sort,
    as ``lax.top_k`` orders ties."""

    def __init__(self, in_channel, mlp, att=None, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        dims = [in_channel, *mlp]
        self.blocks = nn.ModuleList(_ConvBNLRelu(i, o, **kw) for i, o in zip(dims[:-1], dims[1:]))
        self.att = AttentionBlock(att[0], att[1], att[2], **kw) if att else None

    def forward(self, xyz1, xyz2, points1, points2):
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(B, N, points2.shape[-1])
        else:
            d3, idx = _smallest(square_distance(xyz1, xyz2), 3)
            recip = 1.0 / (torch.clamp(d3, min=0.0) + 1e-8)
            weight = recip / torch.sum(recip, dim=-1, keepdim=True)
            interpolated = torch.sum(index_points(points2, idx) * weight[..., None], dim=2)
        if self.att is not None and points1 is not None:
            psix, _ = self.att(interpolated, points1)
            points1 = points1 * psix
        h = interpolated if points1 is None else torch.cat([points1, interpolated], dim=-1)
        for blk in self.blocks:
            h = blk(h)
        return h


class CurveAggregation(nn.Module):
    """Inter- and intra-curve attention: x (B, N, C), curves (B, c_n, c_l,
    C) -> leaky_relu(x + bn(convd([f_inter, f_intra])), 0.2)."""

    def __init__(self, in_channel, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        mid = in_channel // 2

        def mk(i, o):
            return Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device)

        self.conva, self.convb, self.convc = mk(in_channel, mid), mk(in_channel, mid), mk(in_channel, mid)
        self.convn, self.convl = mk(mid, mid), mk(mid, mid)
        self.convd_lin = mk(mid * 2, in_channel)
        self.convd_bn = BatchNorm(in_channel, dtype=dtype, device=device)
        self.line_conv_att = mk(in_channel, 1)

    def forward(self, x, curves):
        att = self.line_conv_att(curves)[..., 0]  # (B, c_n, c_l)
        inter = torch.einsum("bnlc,bnl->bnc", curves, torch.softmax(att, dim=-1))  # (B, c_n, C)
        intra = torch.einsum("bnlc,bnl->blc", curves, torch.softmax(att, dim=-2))  # (B, c_l, C)
        inter_m = self.conva(inter)
        intra_m = self.convb(intra)
        x_logits = self.convc(x)  # (B, N, mid)
        x_inter = torch.softmax(torch.einsum("bnm,bcm->bnc", x_logits, inter_m), dim=-1)
        x_intra = torch.softmax(torch.einsum("bnm,blm->bnl", x_logits, intra_m), dim=-1)
        f_inter = torch.einsum("bnc,bcm->bnm", x_inter, self.convn(inter_m))
        f_intra = torch.einsum("bnl,blm->bnm", x_intra, self.convl(intra_m))
        x = x + self.convd_bn(self.convd_lin(torch.cat([f_inter, f_intra], dim=-1)))
        return F.leaky_relu(x, 0.2)


class CurveGrouping(nn.Module):
    """The curves' start points, the ``curve_num`` highest attention scores
    sigmoid(att(x)) in ``lax.top_k``'s order, and the walk from them over
    the features x scaled by those scores."""

    def __init__(self, in_channel, k, curve_num, curve_length, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.curve_num = curve_num
        self.att = Linear(in_channel, 1, use_bias=False, dtype=dtype, generator=generator, device=device)
        self.walk = Walk(in_channel, k, curve_num, curve_length, dtype=dtype, generator=generator, device=device)

    def forward(self, x, xyz, idx):
        from learning3d_tpu_torch.models.masknet import top_indices  # here: models imports this module

        x_att = torch.sigmoid(self.att(x))  # (B, N, 1)
        x = x * x_att
        start = top_indices(x_att[..., 0].detach(), self.curve_num)  # (B, curve_num)
        return self.walk(xyz, x, idx, start)


class MaskedMaxPool(nn.Module):
    """FPS (from point 0) of ``npoint`` centers, a ball query of ``k``
    members within ``radius``, and the max of the members' features:
    (new_xyz (B, npoint, 3), (B, npoint, C))."""

    def __init__(self, npoint, radius, k):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.k = k

    def forward(self, xyz, features):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        idx = query_ball_point(self.radius, self.k, xyz, new_xyz)
        return new_xyz, torch.amax(index_points(features, idx), dim=2)


class CIC(nn.Module):
    """The curve-intervention residual block: a masked max pool where the
    cloud is not at ``npoint`` yet, a bottleneck conv, curve grouping and
    aggregation (with ``curve_config`` = [curve_num, curve_length]), LPFA,
    a conv back to ``output_channels`` and the shortcut."""

    def __init__(self, npoint, radius, k, in_channels, output_channels, bottleneck_ratio=2, mlp_num=2,
                 curve_config=None, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.in_channels = in_channels
        self.output_channels = output_channels
        self.npoint = npoint
        self.k = k
        planes = in_channels // bottleneck_ratio
        self.use_curve = curve_config is not None
        if self.use_curve:
            self.curveaggregation = CurveAggregation(planes, **kw)
            self.curvegrouping = CurveGrouping(planes, k, curve_config[0], curve_config[1], **kw)
        self.conv1 = _ConvBNLRelu(in_channels, planes, **kw)
        self.conv2 = _ConvBNLRelu(planes, output_channels, act=False, **kw)
        self.shortcut = _ConvBNLRelu(in_channels, output_channels, act=False, **kw) \
            if in_channels != output_channels else None
        self.maxpool = MaskedMaxPool(npoint, radius, k)
        self.lpfa = LPFA(planes, planes, k, mlp_num=mlp_num, initial=False, **kw)

    def forward(self, xyz, x, idx=None):
        """xyz (B, N, 3), x (B, N, C) -> (new_xyz, new_x, idx). ``idx`` is
        the (B, N, k + 1) self-inclusive kNN of xyz: blocks at one
        resolution pass it on, so that one kNN serves them all (a new
        resolution builds its own)."""
        if xyz.shape[1] != self.npoint:
            xyz, x = self.maxpool(xyz, x)
            idx = None
        shortcut = x
        x = self.conv1(x)
        if idx is None:
            idx = knn(xyz, self.k + 1)  # self first
        if self.use_curve:
            x = self.curveaggregation(x, self.curvegrouping(x, xyz, idx[..., 1:]))
        x = self.conv2(self.lpfa(x, xyz, idx=idx[..., : self.k]))
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut)
        return xyz, F.leaky_relu(x + shortcut, 0.2), idx
