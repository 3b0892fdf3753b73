"""The port's legacy models (models/encoder_unet.py, vae_legacy.py,
text_transformer.py, diffusion_wrapper.py) against the JAX modules, fp32 on
the CPU at small widths: the same seeded weights (flax params carried
across by convert.py with strict=True) and the same inputs, every output
within 2e-4 of its RMS (PARITY.md:51-53's UNet bound)."""
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.models import diffusion_wrapper as jdw
from pbe_tpu.models import encoder_unet as jeu
from pbe_tpu.models import text_transformer as jtt
from pbe_tpu.models import vae_legacy as jvl
from pbe_tpu.models.unet import UNetConfig as JUNet
from pbe_tpu.schedules import DiffusionSchedule as JSchedule

from pbe_tpu_torch import convert
from pbe_tpu_torch.models import diffusion_wrapper as tdw
from pbe_tpu_torch.models import encoder_unet as teu
from pbe_tpu_torch.models import text_transformer as ttt
from pbe_tpu_torch.models import vae_legacy as tvl
from pbe_tpu_torch.models.unet import UNetConfig as TUNet
from pbe_tpu_torch.schedules import DiffusionSchedule as TSchedule

TOL = 2e-4  # x the output's RMS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_variables(module, *args, seed=0, **kw):
    """Seeded values for every parameter of a flax module (shapes from
    jax.eval_shape, so nothing compiles): lecun-normal kernels and
    non-trivial scales, biases and embeddings, so no term is vacuous."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kw), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return g.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * g.standard_normal(s.shape)
        return 0.1 * g.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(leaf(p, s), np.float32),
                                            shapes)


def run_jax(module, variables, *args, **kw):
    """module.apply under jax.jit (an op-by-op apply compiles every op
    alone: seconds more), keyword arguments static."""
    return jax.jit(functools.partial(module.apply, **kw))(variables, *args)


def load(tmodel, state_dict):
    tmodel.load_state_dict(state_dict, strict=True)
    return tmodel.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rms = np.sqrt(np.mean(want ** 2))
    assert rms > 1e-3
    assert np.abs(got - want).max() <= TOL * rms, np.abs(got - want).max() / rms


# ---- encoder_unet ----------------------------------------------------------------------

ENC_GEO = dict(image_size=16, in_channels=4, model_channels=32, out_channels=10,
               num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 4),
               num_head_channels=16)


@functools.lru_cache(maxsize=None)
def _encoder_pair(pool, new_order):
    """(JAX module, its variables, the port's module with their weights)."""
    cfg = dict(ENC_GEO, pool=pool, use_new_attention_order=new_order)
    jm = jeu.EncoderUNetConfig(**cfg).build()
    x = jnp.zeros((2, 16, 16, 4))
    t = jnp.zeros((2,))
    variables = jax_variables(jm, x, t)
    tm = load(teu.EncoderUNetConfig(**cfg).build(),
              convert.encoder_unet_state_dict_from_flax(variables["params"]))
    return jm, variables, tm


@pytest.mark.parametrize("pool,new_order", [("adaptive", False), ("attention", True),
                                            ("spatial", False), ("spatial_v2", True)])
def test_encoder_unet_matches_jax(pool, new_order):
    jm, variables, tm = _encoder_pair(pool, new_order)
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([3.0, 777.0], np.float32)
    want = run_jax(jm, variables, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t))
    assert got.shape == (2, 10)
    close(got, want)


def test_qkv_attention_orders_match_jax():
    g = np.random.default_rng(2)
    qkv = g.standard_normal((2, 7, 3 * 4 * 8)).astype(np.float32)  # (B, T, 3*H*ch)
    for legacy in (True, False):
        want = jeu._qkv_attention(jnp.asarray(qkv), 4, legacy)
        got = teu._qkv_attention(torch.from_numpy(qkv.transpose(0, 2, 1).copy()), 4, legacy)
        close(got.numpy().transpose(0, 2, 1), want)


def test_classifier_loss_and_top_k_match_jax():
    jm, variables, tm = _encoder_pair("adaptive", False)
    sched = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    js, ts = JSchedule.create(**sched), TSchedule.create(**sched)
    g = np.random.default_rng(3)
    z = g.standard_normal((2, 16, 16, 4)).astype(np.float32)
    labels = np.asarray([1, 7])
    rng = jax.random.PRNGKey(5)
    fwd = jax.jit(jm.apply)
    apply = lambda x, t: fwd(variables, x, t)
    want_loss, want_logits = jeu.classifier_loss(apply, js, jnp.asarray(z), jnp.asarray(labels),
                                                 rng)
    # JAX's draws, injected
    r_t, r_noise = jax.random.split(rng)
    t = np.asarray(jax.random.randint(r_t, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(r_noise, z.shape, jnp.float32))
    with torch.no_grad():
        loss, logits = teu.classifier_loss(tm, ts, nchw(z), torch.from_numpy(labels),
                                           t=torch.from_numpy(t), noise=nchw(noise))
    close(logits, want_logits)
    close(loss, want_loss)
    # a fixed t, as per-noise-level evaluation uses it
    want_loss, _ = jeu.classifier_loss(apply, js, jnp.asarray(z), jnp.asarray(labels), rng, t=50)
    with torch.no_grad():
        loss, _ = teu.classifier_loss(tm, ts, nchw(z), torch.from_numpy(labels), t=50,
                                      noise=nchw(noise))
    close(loss, want_loss)
    for k in (1, 3, 10):
        assert float(teu.top_k_accuracy(logits, torch.from_numpy(labels), k)) == float(
            jeu.top_k_accuracy(jnp.asarray(logits.numpy()), jnp.asarray(labels), k))


# ---- vae_legacy ------------------------------------------------------------------------

def _model_args():
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 16, 16, 3)).astype(np.float32)
    ctx = g.standard_normal((2, 16, 16, 2)).astype(np.float32)
    return x, ctx, np.asarray([3.0, 500.0], np.float32)


# name -> (JAX module, port module, NHWC input shape)
VAE_LEGACY = {
    "Model": (lambda m: m.Model(ch=16, out_ch=3, num_res_blocks=1, resolution=16, in_channels=5,
                                ch_mult=(1, 2), attn_resolutions=(8,)), None),
    "Model_no_timestep": (lambda m: m.Model(ch=16, out_ch=3, num_res_blocks=1, resolution=16,
                                            in_channels=3, ch_mult=(1, 2), use_timestep=False),
                          (2, 16, 16, 3)),
    "SimpleDecoder": (lambda m: m.SimpleDecoder(in_channels=8, out_channels=3), (2, 4, 4, 8)),
    "UpsampleDecoder": (lambda m: m.UpsampleDecoder(in_channels=8, out_channels=3, ch=8,
                                                    num_res_blocks=1, resolution=16,
                                                    ch_mult=(2, 2)), (2, 4, 4, 8)),
    "LatentRescaler_x2": (lambda m: m.LatentRescaler(factor=2.0, in_channels=6, mid_channels=16,
                                                     out_channels=5, depth=1), (2, 4, 4, 6)),
    "LatentRescaler_x1.5": (lambda m: m.LatentRescaler(factor=1.5, in_channels=6,
                                                       mid_channels=16, out_channels=5,
                                                       depth=2), (2, 5, 5, 6)),
    "LatentRescaler_x0.6": (lambda m: m.LatentRescaler(factor=0.6, in_channels=6,
                                                       mid_channels=16, out_channels=5,
                                                       depth=1), (2, 7, 7, 6)),
    "MergedRescaleEncoder": (lambda m: m.MergedRescaleEncoder(
        in_channels=3, ch=8, resolution=16, out_ch=6, num_res_blocks=1, ch_mult=(1, 2),
        rescale_factor=1.0), (2, 16, 16, 3)),
    "MergedRescaleDecoder": (lambda m: m.MergedRescaleDecoder(
        z_channels=4, out_ch=3, resolution=16, num_res_blocks=1, ch=8, ch_mult=(1, 2),
        rescale_factor=1.0), (2, 4, 4, 4)),
    "Upsampler": (lambda m: m.Upsampler(in_size=8, out_size=16, in_channels=4, out_channels=3),
                  (1, 8, 8, 4)),
}


@pytest.mark.parametrize("name", list(VAE_LEGACY))
def test_vae_legacy_matches_jax(name):
    build, shape = VAE_LEGACY[name]
    jm, tm = build(jvl), build(tvl)
    if shape is None:  # the DDPM UNet with its timestep and a channel-concat context
        x, ctx, t = _model_args()
        jargs, targs = ((jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)),
                        (nchw(x), torch.from_numpy(t), nchw(ctx)))
    else:
        x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
        jargs, targs = (jnp.asarray(x),), (nchw(x),)
    variables = jax_variables(jm, *jargs)
    load(tm, convert.vae_legacy_state_dict_from_flax(variables["params"]))
    want = run_jax(jm, variables, *jargs)
    with torch.no_grad():
        got = tm(*targs)
    close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("factor", [2.0, 0.75])
def test_resize_picks_jax_pixels(mode, factor):
    x = np.random.default_rng(6).standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = jvl.Resize(mode)(jnp.asarray(x), scale_factor=factor)
    got = tvl.Resize(mode)(nchw(x), scale_factor=factor)
    close(got.numpy().transpose(0, 2, 3, 1), want)
    t = nchw(x)
    assert tvl.Resize(mode)(t) is t


def test_latent_rescaler_flash_matches_jax_and_refuses_a_head_dim_without_kernel():
    """On the CPU "flash" runs the kernels' plain version, at a head dim of
    the tuned kernels (16) and at one only csrc/flash_anyd.cu takes (64);
    the DDPM CIFAR-10 UNet (256-wide heads) builds with "flash"; a width
    past every kernel's (1024) raises before anything runs."""
    x = np.random.default_rng(7).standard_normal((1, 4, 4, 4)).astype(np.float32)
    for width in (16, 64):
        jm = jvl.LatentRescaler(factor=2.0, in_channels=4, mid_channels=width, out_channels=4,
                                depth=1)
        variables = jax_variables(jm, jnp.asarray(x))
        tm = load(tvl.LatentRescaler(2.0, 4, width, 4, depth=1, attn_impl="flash"),
                  convert.vae_legacy_state_dict_from_flax(variables["params"]))
        with torch.no_grad():
            close(tm(nchw(x)).numpy().transpose(0, 2, 3, 1),
                  run_jax(jm, variables, jnp.asarray(x)))
    ddpm = tvl.Model(ch=128, out_ch=3, num_res_blocks=2, resolution=32, in_channels=3,
                     ch_mult=(1, 2, 2, 2), attn_resolutions=(16,), attn_impl="flash")
    assert [m.attn_impl for m in ddpm.modules() if isinstance(m, tvl.AttnBlock)] == ["flash"] * 6
    assert tvl.attn_block(1024, "flash").attn_impl == "flash"
    with pytest.raises(ValueError, match="head dim 2048 unsupported"):
        tvl.attn_block(2048, "flash")


# ---- text_transformer ------------------------------------------------------------------

TT_GEO = dict(num_tokens=50, max_seq_len=12, dim=48, depth=2, heads=3, dim_head=16)


@pytest.mark.parametrize("case", ["logits", "mask", "glu"])
def test_text_transformer_matches_jax(case):
    glu = case == "glu"
    jm = jtt.TextTransformer(**TT_GEO, ff_glu=glu)
    tokens = np.random.default_rng(8).integers(0, 50, (2, 10)).astype(np.int32)
    variables = jax_variables(jm, jnp.asarray(tokens))  # with the logit head
    tm = load(ttt.TextTransformer(**TT_GEO, ff_glu=glu),
              convert.text_transformer_state_dict_from_flax(variables["params"], glu=glu))
    mask = np.ones((2, 10), bool)
    mask[1, 6:] = False
    kw = dict(mask=mask) if case == "mask" else {}
    emb = case != "logits"
    want = run_jax(jm, variables, jnp.asarray(tokens), return_embeddings=emb,
                   **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long(), return_embeddings=emb,
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == ((2, 10, 48) if emb else (2, 10, 50))
    close(got, want)


def test_embedder_configs_build_and_tokenize_is_gated(monkeypatch):
    cfg = ttt.TransformerEmbedderConfig(n_embed=48, n_layer=2, vocab_size=50, max_seq_len=12)
    m = cfg.build()
    assert m(torch.zeros((1, 12), dtype=torch.long), return_embeddings=True).shape == (1, 12, 48)
    bert = ttt.BERTEmbedderConfig(n_embed=48, n_layer=1, max_seq_len=12)
    assert bert.build().token_emb.num_embeddings == 30522 and bert.use_tokenizer
    jkeys = set(convert.text_transformer_state_dict_from_flax(jax_variables(
        jtt.BERTEmbedderConfig(n_embed=48, n_layer=1, max_seq_len=12).build(),
        jnp.zeros((1, 12), jnp.int32))["params"]))
    assert jkeys == set(bert.build().state_dict())

    # the vocabulary is not on disk: a clear error, and nothing fetched
    class _Tokenizer:
        @staticmethod
        def from_pretrained(name):
            raise OSError(f"{name} not in the cache")

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(BertTokenizerFast=_Tokenizer))
    with pytest.raises(RuntimeError, match="bert-base-uncased vocab"):
        bert.tokenize(["a photo of a cat"])


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic", "area"])
def test_class_embedder_and_spatial_rescaler_match_jax(method):
    x = np.random.default_rng(9).standard_normal((2, 16, 16, 3)).astype(np.float32)
    jr = jtt.SpatialRescaler(n_stages=2, method=method, multiplier=0.5, out_channels=5)
    variables = jax_variables(jr, jnp.asarray(x))
    tr = load(ttt.SpatialRescaler(n_stages=2, method=method, multiplier=0.5, out_channels=5),
              convert.text_transformer_state_dict_from_flax(variables["params"]))
    with torch.no_grad():
        close(tr(nchw(x)).numpy().transpose(0, 2, 3, 1), run_jax(jr, variables, jnp.asarray(x)))

    je = jtt.ClassEmbedder(embed_dim=24, n_classes=7)
    batch = {"class": np.asarray([1, 5])}
    variables = jax_variables(je, {"class": jnp.asarray(batch["class"])})
    te = load(ttt.ClassEmbedder(24, 7),
              convert.text_transformer_state_dict_from_flax(variables["params"]))
    with torch.no_grad():
        got = te({"class": torch.from_numpy(batch["class"])})
    assert got.shape == (2, 1, 24)
    close(got, je.apply(variables, {"class": jnp.asarray(batch["class"])}))


# ---- diffusion_wrapper -----------------------------------------------------------------

def _recording(fw, log):
    """A model_fn that records what the wrapper hands it."""
    def fn(x, t, context, y=None):
        log.append((np.asarray(x), None if context is None else np.asarray(context),
                    None if y is None else np.asarray(y)))
        return x
    return fn


@pytest.mark.parametrize("key", [None, "concat", "crossattn", "hybrid", "adm"])
def test_diffusion_wrapper_dispatches_as_jax(key):
    g = np.random.default_rng(10)
    x = g.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cc = [g.standard_normal((2, 8, 8, 5)).astype(np.float32)]
    ca = [g.standard_normal((2, 2, 6)).astype(np.float32),
          g.standard_normal((2, 1, 6)).astype(np.float32)]
    y = [np.asarray([3, 1])]
    jlog, tlog = [], []
    c_cross = y if key == "adm" else ca
    jdw.apply_diffusion_wrapper(_recording("jax", jlog), jnp.asarray(x), jnp.zeros(2), key,
                                c_concat=[jnp.asarray(c) for c in cc],
                                c_crossattn=[jnp.asarray(c) for c in c_cross])
    tdw.apply_diffusion_wrapper(_recording("torch", tlog), nchw(x), torch.zeros(2), key,
                                c_concat=[nchw(c) for c in cc],
                                c_crossattn=[torch.from_numpy(c) for c in c_cross])
    (jx, jc, jy), (tx, tc, ty) = jlog[0], tlog[0]
    np.testing.assert_array_equal(tx.transpose(0, 2, 3, 1), jx)  # NCHW: concat on dim 1
    for a, b in ((tc, jc), (ty, jy)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tdw.apply_diffusion_wrapper(_recording("torch", []), nchw(x), torch.zeros(2), "bogus")


def test_diffusion_wrapper_adm_conditions_a_num_classes_unet_as_jax():
    """'adm' on the port UNet's label_emb, against the JAX UNet with the same
    weights (one conditioning token: PBE's cross-attention)."""
    geo = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=1,
               attention_resolutions=(1,), channel_mult=(1, 2), num_heads=4, context_dim=48,
               use_checkpoint=False, num_classes=7)
    jm = JUNet(**geo).build()
    g = np.random.default_rng(11)
    x = g.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = g.standard_normal((2, 1, 48)).astype(np.float32)
    t = np.asarray([11.0, 600.0], np.float32)
    y = np.asarray([0, 6])
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                              y=jnp.asarray(y))
    sd = convert.state_dict_from_flax({"model": variables["params"]})
    tm = load(TUNet(**geo).build(), {k.removeprefix("model.diffusion_model."): v
                                     for k, v in sd.items()})
    fwd = jax.jit(jm.apply)
    jfn = lambda x, t, c, y=None: fwd(variables, x, t, jnp.asarray(ctx), y)
    tfn = lambda x, t, c, y=None: tm(x.permute(0, 2, 3, 1), t, torch.from_numpy(ctx),
                                     y=y).permute(0, 3, 1, 2)
    for labels in (y, np.asarray([2, 2])):
        want = jdw.apply_diffusion_wrapper(jfn, jnp.asarray(x), jnp.asarray(t), "adm",
                                           c_crossattn=[jnp.asarray(labels)])
        with torch.no_grad():
            got = tdw.apply_diffusion_wrapper(tfn, nchw(x), torch.from_numpy(t), "adm",
                                              c_crossattn=[torch.from_numpy(labels)])
        close(got.numpy().transpose(0, 2, 3, 1), want)
