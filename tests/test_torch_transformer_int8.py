"""K11a/K11b (the fused int8 pointer layers) of the PyTorch port against the
JAX package, on the CPU at a small size (d=256, 2 heads, ff 512, N=256).

The JAX layer is built with fixed rngs and quantized by the JAX package's
own ``quantize_transformer_layer``; its weight dict and scales
(``QuantEncoderLayerFused._weights()``, ``.scales``) cross as numpy arrays.
The port's plain versions are held against JAX's ``*_reference`` and, one
case each, against the JAX kernel in Pallas interpret mode.

Tolerance: the tie-flip profile of the JAX package's own kernel test
(``tests/test_transformer_int8.py``): max |diff| < 0.08 and fewer than 1% of
the elements above 2e-4. The two sides sum in other orders (LayerNorm
statistics, the softmax's l, a bf16 P.V product), which moves an f32 value
by an ulp and can flip round(x / s) at a .5 tie; integer products are exact
on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

import learning3d_tpu.kernels.transformer_int8 as jk11
import learning3d_tpu.models.dgcnn as jdgcnn_mod
from learning3d_tpu import quant as jquant
from learning3d_tpu.models import DCP as JDCP
from learning3d_tpu.models import DGCNN as JDGCNN
from learning3d_tpu.utils import transformer as jtr
from learning3d_tpu_torch import quant as tquant
from learning3d_tpu_torch.kernels import transformer_int8 as tk11
from learning3d_tpu_torch.models import DCP, DGCNN
from learning3d_tpu_torch.utils import transformer as ttr
from learning3d_tpu_torch.utils.jax_import import load_nnx_state, load_quant_dcp
from torch_port_util import cloud, nnx_flat, quant_dcp_scales, randomize_bn, rel_err

D, H, FF, NPTS = 256, 2, 512, 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def assert_tieflip_close(got, want, atol=2e-4, max_abs=0.08, frac=0.01):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < max_abs, d.max()
    assert (d > atol).mean() < frac, (d > atol).mean()


def jax_fused_layer(kind, int8_pv, batch=2, seed=0):
    """A JAX layer quantized by the JAX package, its fused wrapper, and the
    f32 inputs."""
    rng = np.random.default_rng(seed + 1)
    x = jnp.asarray(rng.standard_normal((batch, NPTS, D)), jnp.float32)
    mem = jnp.asarray(rng.standard_normal((batch, NPTS, D)), jnp.float32)
    if kind == "encoder":
        layer = jtr._EncoderLayer(D, H, FF, rngs=nnx.Rngs(seed))
        float_layer = nnx.merge(*nnx.split(layer))
        layer = jquant.quantize_transformer_layer(layer, lambda lyr: lyr(x), int8_pv)
        return jquant.QuantEncoderLayerFused(layer, int8_pv=int8_pv), float_layer, x, None
    layer = jtr._DecoderLayer(D, H, FF, rngs=nnx.Rngs(seed))
    float_layer = nnx.merge(*nnx.split(layer))
    layer = jquant.quantize_transformer_layer(layer, lambda lyr: lyr(x, mem), int8_pv)
    return jquant.QuantDecoderLayerFused(layer, int8_pv=int8_pv), float_layer, x, mem


def torch_weights(jwrapper):
    return {k: torch.from_numpy(np.array(v)) for k, v in jwrapper._weights().items()}


def torch_scales(jwrapper):
    import dataclasses

    return tk11.LayerScales(**dataclasses.asdict(jwrapper.scales))


def port_reference(kind, x, mem, w, sc, int8_pv):
    x = torch.from_numpy(np.array(x))
    if kind == "encoder":
        return tk11.encoder_layer_int8_reference(x, w, sc, n_heads=H, int8_pv=int8_pv)
    return tk11.decoder_layer_int8_reference(x, torch.from_numpy(np.array(mem)), w, sc, n_heads=H,
                                             int8_pv=int8_pv)


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_plain_matches_jax_reference(kind, int8_pv):
    """The port's plain version on the JAX layer's weights and scales
    against JAX's ``*_reference``."""
    jw, _, x, mem = jax_fused_layer(kind, int8_pv)
    if kind == "encoder":
        want = jk11.encoder_layer_int8_reference(x, jw._weights(), jw.scales, n_heads=H, int8_pv=int8_pv)
    else:
        want = jk11.decoder_layer_int8_reference(x, mem, jw._weights(), jw.scales, n_heads=H, int8_pv=int8_pv)
    got = port_reference(kind, x, mem, torch_weights(jw), torch_scales(jw), int8_pv)
    assert got.dtype == torch.float32
    assert_tieflip_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_plain_matches_jax_kernel_interpret(kind):
    """The port's plain version against the JAX kernel itself (Pallas
    interpret mode), batch 1, hybrid P.V on the decoder, int8 on the
    encoder."""
    int8_pv = kind == "encoder"
    jw, _, x, mem = jax_fused_layer(kind, int8_pv, batch=1, seed=3)
    with pltpu.force_tpu_interpret_mode():
        if kind == "encoder":
            want = jk11.encoder_layer_int8(x, jw._weights(), jw.scales, n_heads=H, int8_pv=int8_pv, interpret=True)
        else:
            want = jk11.decoder_layer_int8(x, mem, jw._weights(), jw.scales, n_heads=H, int8_pv=int8_pv,
                                           interpret=True)
    got = port_reference(kind, x, mem, torch_weights(jw), torch_scales(jw), int8_pv)
    assert_tieflip_close(got.numpy(), np.asarray(want))


def kernel_chain(kind, x, mem, pack, int8_pv):
    """The CUDA entries' chain of launches written out in torch on the
    packed operands (``FusedLayerWeights``): the packing (transposes,
    concatenations, padding, column offsets, products of scales) is held
    here against the plain version, where no card can run the kernels."""

    def ln_quant(t, ln, s):
        y = tk11._ln(t.float(), getattr(pack, ln + "a"), getattr(pack, ln + "b")) if ln else t.float()
        return tk11._quant(y, s)

    def gemm(a, name, mode, res=None):
        acc = tk11._gemm_i8(a, getattr(pack, name + "_w").t()) * getattr(pack, name + "_cs")
        if mode == "residual":
            return (res.float() + acc) + getattr(pack, name + "_b")
        y = acc + getattr(pack, name + "_b")
        return tk11._quant(torch.relu(y) if mode == "relu" else y, getattr(pack, name + "_so"))

    def attention(q, kv, k_off, v_off, att):
        sscale, s_v, s_att = att
        d, dk = pack.d, pack.d_k
        B, N, M = q.shape[0], q.shape[1], kv.shape[1]
        split = lambda t, n: t.reshape(B, n, pack.n_heads, dk).transpose(1, 2)  # noqa: E731
        o = tk11.attend_heads(split(q[..., :d], N), split(kv[..., k_off:k_off + d], M),
                              split(kv[..., v_off:v_off + d], M), sscale, s_v, int8_pv)
        return tk11._quant(o.transpose(1, 2).reshape(B, N, d), s_att)

    sc, d = pack.scales, pack.d
    qkv = gemm(ln_quant(x, "ln1", sc.s_y), "qkv", "requant")
    x2 = gemm(attention(qkv, qkv, d, 2 * d, pack.att), "o", "residual", x)
    ln = "ln2"
    if kind == "decoder":
        q2 = gemm(ln_quant(x2, "ln2", sc.s_y2), "xq", "requant")
        kv2 = gemm(ln_quant(mem, None, sc.s_mem), "xkv", "requant")
        x2 = gemm(attention(q2, kv2, 0, d, pack.xatt), "xo", "residual", x2)
        ln = "ln3"
    h = gemm(ln_quant(x2, ln, sc.s_ff), "ff1", "relu")
    return gemm(h, "ff2", "residual", x2).to(x.dtype)


@pytest.mark.parametrize("int8_pv", [True, False])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_packed_operands_give_the_plain_version(kind, int8_pv):
    """The kernels' chain on the packed operands equals the plain version
    on the weight dict (tie-flip profile: the LayerNorm and softmax sums are
    the same torch calls, the f64 products exact; the one reordered sum is
    the residual's (x + acc cs) + b, the same as the plain version's)."""
    jw, _, x, mem = jax_fused_layer(kind, int8_pv, batch=1, seed=5)
    w, sc = torch_weights(jw), torch_scales(jw)
    pack = tk11.FusedLayerWeights(w, sc, H, kind == "decoder")
    assert pack.qkv_w.shape == (3 * D, D) and pack.ff1_w.shape == (FF, D) and pack.ff2_w.shape == (D, FF)
    tx = torch.from_numpy(np.array(x))
    tmem = None if mem is None else torch.from_numpy(np.array(mem))
    got = kernel_chain(kind, tx, tmem, pack, int8_pv)
    want = port_reference(kind, x, mem, w, sc, int8_pv)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_feed_forward_width_is_padded():
    """A hidden width that is not a multiple of 128 (ff 200) is padded with
    zero weights to 256; the padded units are 0 and change nothing."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((1, NPTS, D)), jnp.float32)
    layer = jquant.quantize_transformer_layer(jtr._EncoderLayer(D, H, 200, rngs=nnx.Rngs(7)), lambda lyr: lyr(x))
    jw = jquant.QuantEncoderLayerFused(layer)
    w, sc = torch_weights(jw), torch_scales(jw)
    pack = tk11.FusedLayerWeights(w, sc, H, False)
    assert pack.ff1_w.shape == (256, D) and pack.ff2_w.shape == (D, 256)
    assert not pack.ff1_w[200:].any() and not pack.ff2_w[:, 200:].any() and not pack.ff1_cs[200:].any()
    tx = torch.from_numpy(np.array(x))
    torch.testing.assert_close(kernel_chain("encoder", tx, None, pack, True), port_reference("encoder", x, None, w, sc,
                                                                                            True), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_plain_matches_composed_blocks_at_f32(kind):
    """At f32 the port's layer on the gate (K11's plain version on the CPU)
    against the same port layer composing its int8 blocks (the module path),
    both from the port's own quantization: the module path adds a block's
    bias before the residual, x + (acc cs + b), where the layer adds it
    after, (x + acc cs) + b, so the profile is the tie-flip one."""
    _, jfloat, x, mem = jax_fused_layer(kind, True, seed=9)
    cls = ttr._EncoderLayer if kind == "encoder" else ttr._DecoderLayer
    tl = load_nnx_state(cls(D, H, FF, device="cpu"), nnx_flat(jfloat)).eval()
    args = (torch.from_numpy(np.array(x)),) if mem is None else (torch.from_numpy(np.array(x)),
                                                                    torch.from_numpy(np.array(mem)))
    tquant.quantize_transformer_layer(tl, lambda lyr: lyr(*args), int8_pv=True)
    wrapper = (tquant.QuantEncoderLayerFused if kind == "encoder" else tquant.QuantDecoderLayerFused)(tl)
    with torch.inference_mode():
        fused, composed = wrapper(*args), wrapper.inner(*args)
    assert fused.dtype == composed.dtype == torch.float32
    assert_tieflip_close(fused.numpy(), composed.numpy())


def test_gate_matches_jax():
    for n in (128, 200, 255, 256, 512, 768, 1024, 2048, 2304):
        for d in (64, 128, 256, 384, 512, 640, 1024, 1152):
            for h in (1, 2, 3, 4, 8):
                want = jk11.fused_layer_ok(n, d, h)
                assert tk11.fused_layer_ok(n, d, h) == want, (n, d, h)
                if want:  # every shape the gate admits is inside the kernel's limit
                    assert tk11.kernel_limit(d, h) is None, (n, d, h)
    assert tk11.kernel_limit(512, 8) is not None  # d_k = 64


def test_kernel_entries_raise_off_the_card():
    """The CUDA entries take no CPU or meta tensor: K11 is named."""
    jw, _, x, mem = jax_fused_layer("decoder", True, batch=1)
    pack = tk11.FusedLayerWeights(torch_weights(jw), torch_scales(jw), H, True)
    for dev in ("cpu", "meta"):
        t = torch.empty(1, NPTS, D, device=dev)
        with pytest.raises(NotImplementedError, match="K11a"):
            tk11.encoder_layer_int8(t, pack)
        with pytest.raises(NotImplementedError, match="K11b"):
            tk11.decoder_layer_int8(t, t, pack)


# --- the slice: int8 DCP with fused layers against JAX's clone -----------

EMB, K = 512, 20
KEYS = ("est_R", "est_t", "est_R_", "est_t_", "est_T", "r", "transformed_source")
TOLS = {**{key: 3e-2 for key in KEYS}, "r": 5e-2}


def test_fused_int8_dcp_matches_jax(monkeypatch):
    """DCP(DGCNN(512)) at B=1, N=256 in bf16, quantized with
    fused_layers=True: the port's clone (the JAX clone's state carried over,
    and the port's own quantization) against JAX's, with JAX's gate opened
    as its accelerator would open it (``_fused_ok`` reduced to
    ``fused_layer_ok``, the layer kernels' calls routed to their
    ``*_reference`` functions, K9 in interpret mode), so that both sides
    compute what JAX's accelerator computes. The bf16 slice's tolerances;
    each pointer layer took its fused path on both sides."""
    jm = JDCP(JDGCNN(emb_dims=EMB, k=K, dtype=jnp.bfloat16, rngs=nnx.Rngs(0)), dtype=jnp.bfloat16,
              rngs=nnx.Rngs(1))
    randomize_bn(jm, np.random.default_rng(0))
    jm.eval()
    tm = load_nnx_state(DCP(DGCNN(emb_dims=EMB, k=K, dtype=torch.bfloat16, device="cpu"), dtype=torch.bfloat16,
                            device="cpu"), nnx_flat(jm)).eval()
    calib_t, calib_s = cloud(1, NPTS, seed=60), cloud(1, NPTS, seed=61)
    template, source = cloud(1, NPTS, seed=62), cloud(1, NPTS, seed=63)

    jcalls = {"enc": 0, "dec": 0}

    def enc(x, w, sc, *, interpret=False, **kw):
        jcalls["enc"] += 1
        return jk11.encoder_layer_int8_reference(x, w, sc, **kw)

    def dec(x, m, w, sc, *, interpret=False, **kw):
        jcalls["dec"] += 1
        return jk11.decoder_layer_int8_reference(x, m, w, sc, **kw)

    monkeypatch.setattr(jquant, "_fused_ok", lambda x, h: jk11.fused_layer_ok(x.shape[1], x.shape[2], h))
    monkeypatch.setattr(jk11, "encoder_layer_int8", enc)
    monkeypatch.setattr(jk11, "decoder_layer_int8", dec)
    monkeypatch.setattr(jdgcnn_mod, "dgcnn_fused_ok", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        jq = jquant.quantize_dcp(jm, jnp.asarray(calib_t), jnp.asarray(calib_s), int8_pv=True, fused_layers=False)
        jf = jquant.quantize_dcp(jm, jnp.asarray(calib_t), jnp.asarray(calib_s), int8_pv=True, fused_layers=True)
        want = jf(jnp.asarray(template), jnp.asarray(source))
    assert jcalls == {"enc": 2, "dec": 2}

    carried = load_quant_dcp(tm, nnx_flat(jq), quant_dcp_scales(jq), jq.emb_nn.int8_scales, int8_pv=True)
    tquant._fuse_layers(carried.pointer, int8_pv=True)
    own = tquant.quantize_dcp(tm, torch.from_numpy(calib_t), torch.from_numpy(calib_s), int8_pv=True,
                              fused_layers=True)
    calls = {"enc": 0, "dec": 0}
    for name in ("encoder_layer_int8_reference", "decoder_layer_int8_reference"):
        fn = getattr(tquant, name)
        key = name[:3]
        monkeypatch.setattr(tquant, name, lambda *a, _fn=fn, _k=key, **kw: calls.__setitem__(_k, calls[_k] + 1)
                            or _fn(*a, **kw))
    with torch.inference_mode():
        got = carried(torch.from_numpy(template), torch.from_numpy(source))
        mine = own(torch.from_numpy(template), torch.from_numpy(source))
    assert calls == {"enc": 4, "dec": 4}
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key], want[key]) <= TOLS[key], key
        assert rel_err(mine[key], want[key]) <= TOLS[key], key
