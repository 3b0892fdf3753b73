"""The port's first-stage training (``pbe_tpu_torch/training/vae_train.py``,
``training/perceptual.py``, ``models/vae_asym.py`` and the VAE's forward)
against the JAX package on the CPU, fp32, with the JAX weights carried
across by ``pbe_tpu_torch/convert.py`` and JAX's own latent draws injected:
the modules, the adaptive GAN weight, and two whole train steps at the
geometry of tests/test_training.py (VAE ch 8, ch_mult (1, 2), 32^2)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbe_tpu.models import vae_asym as jasym
from pbe_tpu.models.vae import AutoencoderKL as JVAE
from pbe_tpu.models.vae import diagonal_gaussian_kl as j_kl
from pbe_tpu.training import perceptual as jperc
from pbe_tpu.training import vae_train as jvt

from pbe_tpu_torch.convert import (asym_decoder_state_dict_from_flax,
                                   discriminator_state_dict_from_flax, state_dict_from_flax,
                                   vgg16_state_dict_from_flax)
from pbe_tpu_torch.models import vae_asym as tasym
from pbe_tpu_torch.models.vae import AutoencoderKL as TVAE
from pbe_tpu_torch.models.vae import Decoder
from pbe_tpu_torch.models.vae import diagonal_gaussian_kl as t_kl
from pbe_tpu_torch.training import perceptual as tperc
from pbe_tpu_torch.training import vae_train as tvt

VAE_GEO = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=3, embed_dim=3)
to_t = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _seeded(module, *args, seed=0, scale=None):
    """Seeded values for every parameter of a flax module (shapes traced,
    nothing compiled): kernels at their fan-in scale (activations keep
    their size through the layers), other leaves N(0, 0.1) (or ``scale``
    for every leaf), so zero-init biases and gates are not vacuous."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args)
    g = np.random.default_rng(seed + 100)

    def leaf(path, s):
        if scale is not None:
            return g.standard_normal(s.shape) * scale
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            return g.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return g.standard_normal(s.shape) * 0.1

    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(leaf(p, s), jnp.float32), shapes)


def _vae_pair(seed=0):
    jv = JVAE(**VAE_GEO)
    x0 = jnp.zeros((1, 32, 32, 3))
    variables = _seeded(jv, x0, jax.random.PRNGKey(0), seed=seed)
    tv = TVAE(**VAE_GEO, attn_impl="flash")
    sd = state_dict_from_flax({"x": jax.tree.map(np.asarray, variables["params"])})
    tv.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jv, variables, tv


def _disc_pair(seed=1):
    jd = jvt.PatchDiscriminator(ch=8, n_layers=2)
    variables = _seeded(jd, jnp.zeros((1, 32, 32, 3)), seed=seed)
    td = tvt.PatchDiscriminator(ch=8, n_layers=2)
    td.load_state_dict(discriminator_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    return jd, variables, td


def _vgg_pair(seed=2):
    variables = _seeded(jperc.VGG16Features(), jnp.zeros((1, 32, 32, 3)), seed=seed)
    tower = tperc.VGG16Features()
    tower.load_state_dict(vgg16_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    return variables, tower


def _images(n=2, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _bound(want):
    """PARITY.md's module bound: 2e-4 x the output's scale (fp32 on both
    sides; only the order of the reductions differs)."""
    return 2e-4 * float(np.abs(want).max())


def test_autoencoder_forward_with_injected_noise_and_the_kl():
    jv, variables, tv = _vae_pair()
    x = _images()
    rng = jax.random.PRNGKey(7)
    (recon, (mean, logvar)) = jax.jit(lambda v, x: jv.apply(v, x, rng, sample=True))(
        variables, x)
    eps = jax.random.normal(rng, mean.shape, mean.dtype)
    with torch.no_grad():
        got, (tmean, tlogvar) = tv(to_t(x), noise=to_t(eps))
        mode, _ = tv(to_t(x), sample=False)
    for g, w in ((tmean, mean), (tlogvar, logvar), (got, recon)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=_bound(w))
    want_mode, _ = jax.jit(lambda v, x: jv.apply(v, x, sample=False))(variables, x)
    np.testing.assert_allclose(mode.numpy(), np.asarray(want_mode), rtol=0,
                               atol=_bound(want_mode))
    kl = t_kl(tmean, tlogvar)
    np.testing.assert_allclose(kl.numpy(), np.asarray(j_kl(mean, logvar)), rtol=1e-5)
    assert kl.shape == (2,) and tv.latent_shape(x.shape) == tuple(mean.shape)


@pytest.fixture(scope="module")
def asym_pair():
    jd = jasym.AsymmetricDecoder(ch=8, ch_mult=(1, 2), num_res_blocks=1, cond_ch=4)
    z = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    cond = _images(seed=5)
    mask = np.ones((2, 32, 32, 1), np.float32)
    mask[:, 6:25, 9:30] = 0.0
    variables = _seeded(jd, z, cond, mask, seed=3)  # the gates seeded too: not vacuous
    td = tasym.AsymmetricDecoderConfig(
        {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4},
        cond_ch=4).build()
    td.load_state_dict(asym_decoder_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    return jd, variables, td, (z, cond, mask)


def test_asymmetric_decoder_matches_jax(asym_pair):
    jd, variables, td, args = asym_pair
    want = np.asarray(jax.jit(jd.apply)(variables, *args))
    assert np.all(td.blend_scale.detach().numpy() != 0)
    with torch.no_grad():
        got = td(*(to_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_bound(want))


def test_asymmetric_decoder_at_zero_gates_is_the_plain_decoder(asym_pair):
    """With blend_scale at its zero init the module computes the plain
    decode bit for bit, on a plain Decoder's state_dict (the trunk's names
    are Decoder's; the conditional branch keeps its own weights)."""
    _, _, td, (z, cond, mask) = asym_pair
    plain = Decoder(8, 3, (1, 2), 1, 4, "plain")
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0, 0.2)
    missing, unexpected = td.load_state_dict(plain.state_dict(), strict=False)
    assert unexpected == [] and all(
        k.startswith(("cond_encoder.", "cond_proj.", "blend_scale")) for k in missing)
    with torch.no_grad():
        td.blend_scale.zero_()
        got = td(to_t(z), to_t(cond), to_t(mask))
        want = plain(to_t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("size,out", [(32, 16), (32, 8), (30, 8), (16, 16)])
def test_mask_at_matches_jax_nearest_resize(size, out):
    m = (np.random.default_rng(size + out).uniform(size=(2, size, size, 1)) > 0.5)
    m = m.astype(np.float32)
    want = np.asarray(jasym._mask_at(jnp.asarray(m), (out, out)))
    got = tasym._mask_at(to_t(m).permute(0, 3, 1, 2), (out, out)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vgg16_features_and_the_perceptual_fn_match_jax():
    variables, tower = _vgg_pair()
    x, y = _images(seed=6), _images(seed=7)
    want_taps = jax.jit(jperc.VGG16Features().apply)(variables, x)
    with torch.no_grad():
        taps = tower(to_t(x))
    assert len(taps) == 5
    for t, w in zip(taps, want_taps):
        w = np.asarray(w)
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), w, rtol=0, atol=_bound(w))
    want = np.asarray(jax.jit(jperc.make_vgg_perceptual_fn(variables))(x, y))
    got = tperc.make_vgg_perceptual_fn(tower)(to_t(x), to_t(y))
    assert got.shape == want.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4)


def test_torchvision_vgg16_weights_load_into_both_towers():
    """One torchvision-layout state_dict (features.* plus classifier keys)
    through each package's converter gives the same taps."""
    g = np.random.default_rng(8)
    sd = {}
    for k, v in tperc.VGG16Features().state_dict().items():
        fan_in = np.prod(v.shape[1:]) if v.dim() > 1 else 1
        sd[k] = (g.standard_normal(tuple(v.shape)) / np.sqrt(fan_in)).astype(np.float32)
    sd["classifier.0.weight"] = np.zeros((4, 4), np.float32)
    tower = tperc.VGG16Features()
    tower.load_state_dict(tperc.convert_torchvision_vgg16(sd))
    x = _images(n=1, seed=9)
    want = jax.jit(jperc.VGG16Features().apply)(jperc.convert_torchvision_vgg16(sd), x)[-1]
    with torch.no_grad():
        got = tower(to_t(x))[-1].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=_bound(want))


def test_patch_discriminator_and_hinge_loss_match_jax():
    jd, variables, td = _disc_pair()
    x, y = _images(seed=10), _images(seed=11)
    want_real = np.asarray(jax.jit(jd.apply)(variables, x))
    want_fake = np.asarray(jax.jit(jd.apply)(variables, y))
    with torch.no_grad():
        real, fake = td(to_t(x)), td(to_t(y))
    assert real.shape == want_real.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(real.numpy(), want_real, rtol=0, atol=_bound(want_real))
    np.testing.assert_allclose(
        tvt.hinge_d_loss(real, fake).item(),
        float(jvt.hinge_d_loss(jnp.asarray(want_real), jnp.asarray(want_fake))), rtol=1e-5)


def test_calculate_adaptive_weight_matches_jax():
    jv, vv, tv = _vae_pair()
    jd, dv, td = _disc_pair()
    x = _images(seed=12)
    rng = jax.random.PRNGKey(13)
    want = float(jax.jit(lambda a, b, x: jvt.calculate_adaptive_weight(
        jv, jd, a, b, x, rng, lambda p, q: jnp.abs(p - q), 0.5))(vv, dv, x))
    eps = jax.random.normal(rng, tv.latent_shape(x.shape), jnp.float32)
    got = tvt.calculate_adaptive_weight(tv, td, to_t(x), to_t(eps),
                                        lambda p, q: (p - q).abs(), 0.5).item()
    assert 0 < want < 0.5e4
    # a ratio of two gradient norms, each a sum over the conv_out weight
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_two_train_steps_match_jax():
    """make_vae_train_step with the adaptive weight, the perceptual term
    and the GAN term on (disc_start=0), Adam(0.5, 0.9) at lr 1e-3 on both
    sides; the port gets JAX's draw of each step (fold_in(key, step))."""
    lr, steps = 1e-3, 2
    jv, vv, tv = _vae_pair()
    jd, dv, td = _disc_pair()
    vgg_vars, vgg = _vgg_pair()
    x = _images(seed=14)
    key = jax.random.PRNGKey(15)

    tx = optax.adam(lr, b1=0.5, b2=0.9)
    jstate = jvt.VAETrainState(step=jnp.zeros((), jnp.int32), vae_params=vv, disc_params=dv,
                               vae_opt=tx.init(vv), disc_opt=tx.init(dv))
    jstep = jax.jit(jvt.make_vae_train_step(
        jv, jd, tx, disc_start=0, perceptual_fn=jperc.make_vgg_perceptual_fn(vgg_vars),
        perceptual_weight=0.1))
    tstate = tvt.create_vae_train_state(tv, td, lr=lr)
    tstep = tvt.make_vae_train_step(tv, td, disc_start=0,
                                    perceptual_fn=tperc.make_vgg_perceptual_fn(vgg),
                                    perceptual_weight=0.1)
    for i in range(steps):
        jstate, jm = jstep(jstate, x, key)
        eps = jax.random.normal(jax.random.fold_in(key, i), tv.latent_shape(x.shape))
        tm = tstep(tstate, to_t(x), noise=to_t(eps))
        # per-step losses and the adaptive weight: sums over the batch in
        # fp32 on both sides, through weights that agree to ~1e-6
        for name in ("g_loss", "rec", "kl", "d_loss", "d_weight"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]), rtol=1e-4,
                                       err_msg=f"step {i} {name}")
    assert tstate.step == int(jstate.step) == steps

    # Adam moves each weight by about lr a step whatever its gradient's
    # size (m_hat / sqrt(v_hat) is +-1 at the first step). Here every
    # GroupNorm has one channel a group, so the bias of a conv feeding one
    # (and the attention's key bias, which the softmax ignores) has a zero
    # gradient in exact arithmetic, and fp32 noise of a different sign on
    # the two sides: Adam scales that noise up to its step, so those
    # updates may differ by up to 2 lr a step (measured: the biases carry a
    # rel L2 difference of 2e-3 of the whole VAE update). Every element is
    # held to that, and the kernels and norm scales, whose gradients are
    # not noise, to 1e-4 of their update (measured 3e-5 VAE, 6e-6 disc).
    for tmod, params, init in ((tv, jstate.vae_params, vv), (td, jstate.disc_params, dv)):
        conv = (lambda p: {k[2:]: w for k, w in state_dict_from_flax({"x": p}).items()}) \
            if tmod is tv else discriminator_state_dict_from_flax
        want = conv(jax.tree.map(np.asarray, params["params"]))
        before = conv(jax.tree.map(np.asarray, init["params"]))
        got = tmod.state_dict()
        update = lambda sd, keys: torch.cat([(sd[k] - before[k]).flatten() for k in keys])
        assert (update(got, want) - update(want, want)).abs().max() <= 2 * lr * steps
        weights = [k for k in want if not k.endswith("bias")]
        d_want, d_got = update(want, weights), update(got, weights)
        rel = ((d_got - d_want).norm() / d_want.norm()).item()
        assert rel <= 1e-4, rel
        assert d_want.norm() > lr  # the weights moved
