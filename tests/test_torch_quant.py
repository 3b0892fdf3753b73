"""The port's w8a8 int8 execution (pbe_tpu_torch/ops/quant.py) against the
JAX package's (pbe_tpu/ops/quant.py), fp32 on the CPU: the int8 operands
and int32 accumulators bit for bit at the op level in each of the three
modes, the gates, the calibration records of one UNet call, one int8 UNet
call, calibrate_int8 and the int8 edit, on the eligible geometry of
tests/test_quant.py (128 channels, 16x16 latents)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pbe_tpu.models.clip_vit import CLIPVisionConfig as JClip
from pbe_tpu.models.exemplar import ExemplarEncoderConfig as JExemplar
from pbe_tpu.models.pbe import PaintByExample as JPBE
from pbe_tpu.models.unet import UNetConfig as JUNet
from pbe_tpu.models.vae import AutoencoderKLConfig as JVAE
from pbe_tpu.ops import quant as jq
from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline

from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig as TClip
from pbe_tpu_torch.models.exemplar import ExemplarEncoderConfig as TExemplar
from pbe_tpu_torch.models.pbe import PaintByExample as TPBE
from pbe_tpu_torch.models.unet import UNetConfig as TUNet
from pbe_tpu_torch.models.vae import AutoencoderKLConfig as TVAE
from pbe_tpu_torch.ops import conv as tconv
from pbe_tpu_torch.ops import quant as tq
from pbe_tpu_torch.pipelines.inference import EditPipeline as TEditPipeline

from _torch_port import init_jax, load_into, to_t

S = 64  # image side: 16x16 latents, so conv spatial 256 and dense rows 256 a call
GEO = dict(
    unet=dict(model_channels=128, channel_mult=(1,), num_res_blocks=1,
              attention_resolutions=(1,), num_heads=4, context_dim=768,
              use_checkpoint=False),
    vae=dict(ddconfig={"ch": 16, "ch_mult": [1, 2, 2], "num_res_blocks": 1,
                       "z_channels": 4, "double_z": True, "out_ch": 3,
                       "in_channels": 3, "resolution": S}, embed_dim=4),
    clip=dict(hidden_size=1024, num_layers=1, num_heads=4, mlp_dim=32, patch_size=8,
              image_size=32),
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite's workers share the CPU, and idle
    threads spinning for work take it from the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _rng(seed):
    return np.random.default_rng(seed)


def _ulp_jitter(a, seed):
    """a with every value moved by one fp32 ulp, up or down at random."""
    return (a * (1 + 2.0 ** -23 * _rng(seed).choice([-1, 1], a.shape))).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(jax model, variables, port model) at GEO, the same weights."""
    jm = JPBE(unet_config=JUNet(**GEO["unet"]), vae_config=JVAE(**GEO["vae"]),
              cond_config=JExemplar(clip=JClip(**GEO["clip"]), mapper_layers=1))
    variables = init_jax(jm, S, 32)
    tm = TPBE(unet_config=TUNet(**GEO["unet"]), vae_config=TVAE(**GEO["vae"]),
              cond_config=TExemplar(clip=TClip(**GEO["clip"]), mapper_layers=1),
              attn_impl="flash")
    return jm, variables, load_into(tm, variables)


# ---- op level ----------------------------------------------------------------

# (name, x shape NHWC or (B, rows, k), weight shape HWIO or (k, n), stride)
OPS = {
    "dense": ((2, 256, 128), (128, 256), None),
    "conv3x3": ((2, 16, 16, 128), (3, 3, 128, 128), 1),
    "conv1x1": ((2, 16, 16, 128), (1, 1, 128, 128), 1),
    "conv3x3_stride2": ((2, 16, 16, 128), (3, 3, 128, 128), 2),
}
MODES = ("per_row", "per_tensor", "static")


def _jax_op(name, x, w, stride):
    """The JAX override on (x, w) under whatever context is active."""
    if name == "dense":
        return jq.dot_general_int8(x, w, (((x.ndim - 1,), (0,)), ((), ())))
    pad = (w.shape[0] - 1) // 2
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return jq.conv_general_dilated_int8(x, w, (stride, stride), ((pad, pad), (pad, pad)),
                                        dimension_numbers=dn)


def _port_op(name, x, w, stride):
    """The port's op on the same values, in torch layouts; returns NHWC."""
    if name == "dense":
        return tq.linear_int8(to_t(x), to_t(w.T)).numpy()
    pad = (w.shape[0] - 1) // 2
    out = tq.conv2d_int8(to_t(x).permute(0, 3, 1, 2), to_t(w).permute(3, 2, 0, 1), None,
                         (stride, stride), (pad, pad))
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", list(OPS))
def test_int8_op_matches_jax(op, mode):
    xs, ws, stride = OPS[op]
    g = _rng(0)
    x = g.standard_normal(xs).astype(np.float32)
    w = (g.standard_normal(ws) * 0.05).astype(np.float32)
    dense = op == "dense"
    # torch layouts: x (B, rows, k) or NCHW; w (n, k) or OIHW
    xt = to_t(x) if dense else to_t(x).permute(0, 3, 1, 2)
    wt = to_t(w.T) if dense else to_t(w).permute(3, 2, 0, 1)
    back = (lambda a: a) if dense else (lambda a: a.permute(0, 2, 3, 1))
    wback = (lambda a: a.T) if dense else (lambda a: a.permute(2, 3, 1, 0))
    knobs = {"per_tensor": {"per_row": False}}.get(mode, {})
    if mode == "static":
        with jq.calibration() as col:
            _jax_op(op, jnp.asarray(x), jnp.asarray(w), stride)
        scales = jq.scales_from_records([jax.tree.map(np.asarray, col.records)])
        knobs = {"static": scales}
        s_act, s_w = scales[0]
        sw = jnp.asarray(s_w, jnp.float32)
        # the JAX override's static operands (pbe_tpu/ops/quant.py)
        jql = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / s_act)), -127, 127).astype(jnp.int8)
        jqr = jnp.clip(jnp.round(jnp.asarray(w) / sw.reshape((1,) * (w.ndim - 1) + (-1,))),
                       -127, 127).astype(jnp.int8)
        tql = tq.quantize_static(xt, s_act)
        tqr = tq.quantize_static_weight(wt, torch.tensor(s_w))
    else:
        axes = ((x.ndim - 1,) if dense else (1, 2, 3)) if mode == "per_row" \
            else tuple(range(x.ndim))
        jql, _ = jq._quantize_rows(jnp.asarray(x), axes)
        jqr, _ = jq._quantize_per_channel(jnp.asarray(w), w.ndim - 1)
        dims = ((xt.dim() - 1,) if dense else (1, 2, 3)) if mode == "per_row" \
            else tuple(range(xt.dim()))
        tql, _ = tq.quantize_rows(xt, dims)
        tqr, _ = tq.quantize_per_channel(wt)
    np.testing.assert_array_equal(back(tql).numpy(), np.asarray(jql))
    np.testing.assert_array_equal(wback(tqr).numpy(), np.asarray(jqr))
    # the int32 accumulators
    if dense:
        jacc = jax.lax.dot_general(jql, jqr, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        tacc = tq.int8_linear_acc(tql, tqr)
    else:
        pad = (ws[0] - 1) // 2
        dn = jax.lax.conv_dimension_numbers(xs, ws, ("NHWC", "HWIO", "NHWC"))
        jacc = jax.lax.conv_general_dilated(jql, jqr, (stride, stride),
                                            ((pad, pad), (pad, pad)), dimension_numbers=dn,
                                            preferred_element_type=jnp.int32)
        tacc = tq.int8_conv_acc(tql, tqr, (stride, stride), (pad, pad))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(back(tacc).numpy(), np.asarray(jacc))
    # the whole op
    with jq.quantized("int8", **knobs):
        want = np.asarray(_jax_op(op, jnp.asarray(x), jnp.asarray(w), stride))
    with tq.quantized("int8", **knobs):
        got = _port_op(op, x, w, stride)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_int8_product_pads_shapes_the_card_cannot_take():
    """k and n off multiples of 8 are zero-padded into the int8 product:
    the accumulator is the exact integer product."""
    g = _rng(1)
    a = torch.from_numpy(g.integers(-127, 128, (300, 130)).astype(np.int8))
    b = torch.from_numpy(g.integers(-127, 128, (131, 130)).astype(np.int8))
    torch.testing.assert_close(tq.int8_linear_acc(a, b), a.int() @ b.int().T, rtol=0, atol=0)


# (name, x shape, w shape, quantizes): each gate just below its bound falls
# back to the exact fp op in both packages, and just at it quantizes in both
GATES = {
    "dense_contract_127": ((1, 256, 127), (127, 256), False),
    "dense_out_127": ((1, 256, 128), (128, 127), False),
    "dense_rows_per_example_255": ((2, 255, 128), (128, 128), False),
    "dense_rows_total_256_but_64_per_example": ((4, 64, 128), (128, 128), False),
    "dense_two_dim_input": ((512, 128), (128, 128), False),
    "dense_eligible": ((1, 256, 128), (128, 128), True),
    "conv_spatial_255": ((1, 15, 17, 64), (3, 3, 64, 64), False),
    "conv_in_63": ((1, 16, 16, 63), (3, 3, 63, 64), False),
    "conv_out_63": ((1, 16, 16, 64), (3, 3, 64, 63), False),
    "conv_eligible": ((1, 16, 16, 64), (3, 3, 64, 64), True),
    "dense_knob_off": ((1, 256, 128), (128, 128), "dense"),
    "conv_knob_off": ((1, 16, 16, 64), (3, 3, 64, 64), "convs"),
}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_fall_back_exactly_where_jax_does(case):
    xs, ws, quantizes = GATES[case]
    g = _rng(2)
    x = g.standard_normal(xs).astype(np.float32)
    w = (g.standard_normal(ws) * 0.05).astype(np.float32)
    knobs = {quantizes: False} if isinstance(quantizes, str) else {}
    dense = len(ws) == 2
    op = "dense" if dense else "conv3x3"
    if dense:
        jplain = np.asarray(jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                                                (((x.ndim - 1,), (0,)), ((), ()))))
        tplain = F.linear(to_t(x), to_t(w.T)).numpy()
    else:
        dn = jax.lax.conv_dimension_numbers(xs, ws, ("NHWC", "HWIO", "NHWC"))
        jplain = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)), dimension_numbers=dn))
        tplain = F.conv2d(to_t(x).permute(0, 3, 1, 2), to_t(w).permute(3, 2, 0, 1),
                          padding=1).permute(0, 2, 3, 1).numpy()
    with jq.quantized("int8", **knobs):
        jout = np.asarray(_jax_op(op, jnp.asarray(x), jnp.asarray(w), 1))
    with tq.quantized("int8", **knobs):
        tout = _port_op(op, x, w, 1)
    if quantizes is True:
        assert not np.array_equal(jout, jplain) and not np.array_equal(tout, tplain)
        np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())
    else:
        np.testing.assert_array_equal(jout, jplain)
        np.testing.assert_array_equal(tout, tplain)


# ---- one UNet call -------------------------------------------------------------

def _unet_inputs():
    g = _rng(3)
    x9 = g.standard_normal((2, 16, 16, 9)).astype(np.float32)
    t = np.array([500.0, 500.0], np.float32)
    ctx = g.standard_normal((2, 1, 768)).astype(np.float32)
    return x9, t, ctx


def _jax_unet_ops(jm, variables, knobs):
    """One JAX UNet call, jitted inside ``quantized("int8", **knobs)``, as
    a function of x9 -> (its output, [(kind, input, output) of every
    Dense/Conv override call in call order]). Outputs are without the
    layer's bias, which flax adds after the override."""
    kinds = []
    dense, conv = jq.dot_general_int8, jq.conv_general_dilated_int8

    def rec(kind, fn, ops):
        def wrapped(lhs, *a, **k):
            out = fn(lhs, *a, **k)
            kinds.append(kind)
            ops.append((lhs, out))
            return out
        return wrapped

    _, t, ctx = _unet_inputs()

    def f(x9):
        ops = []
        jq.dot_general_int8 = rec("dense", dense, ops)
        jq.conv_general_dilated_int8 = rec("conv", conv, ops)
        try:
            out = jm.apply(variables, x9, t, ctx, method=JPBE.apply_model)
        finally:
            jq.dot_general_int8, jq.conv_general_dilated_int8 = dense, conv
        return out, ops

    jitted = jax.jit(f)

    def run(x9):
        with jq.quantized("int8", **knobs):
            out, ops = jitted(x9)
        return np.asarray(out), [(k, np.asarray(a), np.asarray(o))
                                 for k, (a, o) in zip(kinds, ops)]
    return run


def _port_unet_layers(tm, x9, knobs):
    """One port UNet call inside ``quantized("int8", **knobs)`` -> (its
    output, [(kind, args after the input) of every layer call in order])."""
    layers = []
    dense, conv = tq.linear_int8, tq.conv2d_int8

    def rec(kind, fn):
        def wrapped(x, *a):
            layers.append((kind, a))
            return fn(x, *a)
        return wrapped

    _, t, ctx = _unet_inputs()
    tq.linear_int8, tq.conv2d_int8 = rec("dense", dense), rec("conv", conv)
    try:
        with torch.inference_mode(), tq.quantized("int8", **knobs):
            out = tm.apply_model(to_t(x9), to_t(t), to_t(ctx)).numpy()
    finally:
        tq.linear_int8, tq.conv2d_int8 = dense, conv
    return out, layers


@pytest.fixture(scope="module")
def jax_calibration(models):
    """JAX's calibration records and scales of one UNet call."""
    jm, variables, _ = models
    x9, t, ctx = _unet_inputs()

    @jax.jit
    def f(v, x, tt, c):
        with jq.calibration() as col:
            jm.apply(v, x, tt, c, method=JPBE.apply_model)
        return col.records

    recs = jax.tree.map(np.asarray, f(variables, x9, t, ctx))
    return recs, jq.scales_from_records([recs])


def test_calibration_records_match_jax(models, jax_calibration):
    _, _, tm = models
    want, want_scales = jax_calibration
    x9, t, ctx = _unet_inputs()
    with torch.inference_mode(), tq.calibration() as col:
        tm.apply_model(to_t(x9), to_t(t), to_t(ctx))
    got = [(float(a), w.numpy()) for a, w in col.records]
    # ResBlock convs, proj_in, to_q/k/v, to_out, ff, proj_out ... in call order
    assert len(got) == len(want) > 0
    for (ga, gw), (wa, ww) in zip(got, want):
        assert gw.shape == ww.shape
        np.testing.assert_allclose(ga, wa, rtol=1e-5)
        np.testing.assert_allclose(gw, ww, rtol=1e-5)
    got_scales = tq.scales_from_records([col.records])
    assert len(got_scales) == len(want_scales)
    for (ga, gw), (wa, ww) in zip(got_scales, want_scales):
        np.testing.assert_allclose(ga, wa, rtol=1e-5)
        np.testing.assert_allclose(gw, ww, rtol=1e-5)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_unet_call_matches_jax(models, jax_calibration, mode):
    """Every Linear/conv of one int8 UNet call, in call order, given the
    input JAX's call gave that op, gives JAX's output (rtol 1e-6); then the
    whole call. The static mode runs on JAX's own scales tuple in both."""
    jm, variables, tm = models
    x9, t, ctx = _unet_inputs()
    knobs = {"static": jax_calibration[1]} if mode == "static" else {}
    jax_unet = _jax_unet_ops(jm, variables, knobs)
    want, jax_ops = jax_unet(x9)
    got, layers = _port_unet_layers(tm, x9, knobs)
    assert [k for k, _ in layers] == [k for k, _, _ in jax_ops]
    quantized = 0
    with torch.inference_mode(), tq.quantized("int8", **knobs):
        for (kind, args), (_, lhs, jout) in zip(layers, jax_ops):
            weight = args[0]
            if kind == "dense":
                out = tq.linear_int8(to_t(lhs), weight).numpy()
                plain = F.linear(to_t(lhs), weight).numpy()
            else:
                x = to_t(lhs).permute(0, 3, 1, 2)
                out = tq.conv2d_int8(x, weight, None, *args[2:]).permute(0, 2, 3, 1).numpy()
                plain = tconv.conv2d(x, weight, None, *args[2:]).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())
            quantized += not np.array_equal(out, plain)
    assert quantized == len(jax_calibration[1])  # every eligible op took int8
    with torch.inference_mode():
        fp = tm.apply_model(to_t(x9), to_t(t), to_t(ctx)).numpy()
    assert not np.array_equal(got, fp)
    # The whole call: int8 rounding amplifies fp32 noise. An activation
    # within (fp error x 127) of a rounding boundary moves a whole step, and
    # its successors then differ by more, so the two packages' fp32 sums in
    # another order leave their int8 results as far apart as JAX's result
    # is from itself when its input moves by one fp32 ulp (2.3% rel L2 at
    # this geometry, against 3.1% between int8 and fp). The bound: twice
    # that self-distance, measured here on the same inputs.
    self_dist = np.linalg.norm(jax_unet(_ulp_jitter(x9, 9))[0] - want)
    assert np.linalg.norm(got - want) <= 2 * self_dist
    assert self_dist > 0


# ---- the edit ------------------------------------------------------------------

def _edit_inputs():
    g = _rng(5)
    image = g.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    mask = np.ones((1, S, S, 1), np.float32)
    mask[:, 16:48, 16:48] = 0.0
    ref = g.standard_normal((1, 32, 32, 3)).astype(np.float32)
    x_T = g.standard_normal((1, 16, 16, 4)).astype(np.float32)
    return image, mask, ref, x_T


def _jax_calibration_draws(n_t, seed, shape):
    """The standard normals JAX's calibrate_int8 draws at each of its n_t
    calls (posterior samples of the source and the masked source, then the
    forward noise), to hand the port the same values."""
    out = []
    for i in range(n_t):
        r_enc, r_noise = jax.random.split(jax.random.PRNGKey(seed + i))
        r1, r2 = jax.random.split(r_enc)
        out.append(tuple(np.asarray(jax.random.normal(r, shape, jnp.float32))
                         for r in (r1, r2, r_noise)))
    return out


def test_int8_edit_and_calibrate_int8_match_jax(models):
    jm, variables, tm = models
    image, mask, ref, x_T = _edit_inputs()
    jp = JEditPipeline(jm, variables, quantize="int8")
    tp = TEditPipeline(tm, quantize="int8")
    want_scales = jp.calibrate_int8(image, mask, ref, n_t=2, seed=3)
    got_scales = tp.calibrate_int8(image, mask, ref, n_t=2,
                                   draws=_jax_calibration_draws(2, 3, (1, 16, 16, 4)))
    assert len(got_scales) == len(want_scales) > 0
    for (ga, gw), (wa, ww) in zip(got_scales, want_scales):
        np.testing.assert_allclose(ga, wa, rtol=1e-4)
        np.testing.assert_allclose(gw, ww, rtol=1e-5)
    kw = dict(steps=2, scale=5.0, x_T=x_T, det_first_stage=True)
    fp = TEditPipeline(tm).edit_batch(image, mask, ref, **kw)
    # the static edit on JAX's scales in both. As in the UNet call, int8
    # rounding amplifies the fp32 noise (the fp edits agree to ~5e-7): the
    # bound is twice the distance of JAX's edit from itself when the image,
    # the exemplar and x_T move by one fp32 ulp (the same program, so no new
    # compile)
    jp.quant_scales = tp.quant_scales = want_scales
    want = jp.edit_batch(image, mask, ref, **kw)
    got = tp.edit_batch(image, mask, ref, **kw)
    assert got.shape == want.shape == (1, S, S, 3) and np.isfinite(got).all()
    image_j, ref_j, x_T_j = (_ulp_jitter(a, seed) for seed, a in enumerate((image, ref, x_T)))
    self_dist = float(np.abs(jp.edit_batch(image_j, mask, ref_j, **{**kw, "x_T": x_T_j})
                             - want).mean())
    assert 0 < float(np.abs(got - want).mean()) <= 2 * self_dist
    assert not np.array_equal(got, fp)
    assert float(np.abs(got - fp).mean()) < 0.05  # tests/test_quant.py's bound
    # a second static edit gives the same bits
    np.testing.assert_array_equal(tp.edit_batch(image, mask, ref, **kw), got)
    with pytest.raises(ValueError, match="quant_scales"):
        TEditPipeline(tm, quant_scales=want_scales)


# ---- the context ---------------------------------------------------------------

def test_static_count_mismatch_raises():
    g = _rng(12)
    x = torch.from_numpy(g.standard_normal((1, 512, 256)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((512, 256)).astype(np.float32))
    with tq.calibration() as col:
        tq.linear_int8(x, w)
    scales = tq.scales_from_records([col.records])
    # two calibrated ops claimed, one run: the whole-block check fires
    with pytest.raises(RuntimeError, match="static-scale mismatch"):
        with tq.quantized("int8", static=scales + scales + scales[:1]):
            tq.linear_int8(x, w)
    # a weight-scale vector of the wrong length: at once
    with pytest.raises(RuntimeError, match="misaligned"):
        with tq.quantized("int8", static=((scales[0][0], scales[0][1][:17]),)):
            tq.linear_int8(x, w)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        with tq.quantized("fp4"):
            pass


def test_context_is_thread_local_and_nests():
    seen = {}
    assert not tq.is_active()
    with tq.quantized("int8"):
        t = threading.Thread(target=lambda: seen.update(other=tq.is_active()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        with tq.quantized(None):
            assert tq.is_active()  # None nests transparently
    assert seen == {"other": False} and not tq.is_active()


@pytest.mark.parametrize("op", ["dense", "conv3x3"])
def test_zero_weights_give_exact_zero(op):
    xs, ws, stride = OPS[op]
    x = _rng(4).standard_normal(xs).astype(np.float32)
    out = _port_op(op, x, np.zeros(ws, np.float32), stride)
    assert np.abs(out).max() == 0.0
