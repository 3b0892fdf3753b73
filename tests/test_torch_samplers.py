"""The port's DDIM and DDPM samplers and its edit pipeline's sampler,
paste_back and edit() options against the JAX package: the same synthetic
eps function or the same weights, JAX's own normals injected into the port,
fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline
from pbe_tpu.samplers import ddim_sample as j_ddim
from pbe_tpu.samplers import ddpm_ancestral_sample as j_ddpm
from pbe_tpu.schedules import DiffusionSchedule as JDiffusionSchedule
from pbe_tpu.schedules import SamplerSchedule as JSamplerSchedule

from pbe_tpu_torch.pipelines.inference import EditPipeline as TEditPipeline
from pbe_tpu_torch.samplers.ddim import ddim_sample as t_ddim
from pbe_tpu_torch.samplers.ddpm_ancestral import ddpm_ancestral_sample as t_ddpm
from pbe_tpu_torch.schedules import DiffusionSchedule as TDiffusionSchedule
from pbe_tpu_torch.schedules import SamplerSchedule as TSamplerSchedule

from _torch_port import pipeline_pair, to_t

SHAPE = (2, 4, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _schedules(steps=8, eta=0.0):
    args = (1000, "linear", 0.00085, 0.0120)
    jbase, tbase = JDiffusionSchedule.create(*args), TDiffusionSchedule.create(*args)
    return (jbase, JSamplerSchedule.create(jbase, steps, eta=eta),
            tbase, TSamplerSchedule.create(tbase, steps, eta=eta))


def _latents(seed=0):
    g = np.random.default_rng(seed)
    x_T = g.standard_normal(SHAPE).astype(np.float32)
    z_inpaint = g.standard_normal(SHAPE).astype(np.float32)
    mask = (g.uniform(size=SHAPE[:-1] + (1,)) > 0.5).astype(np.float32)
    return x_T, z_inpaint, mask


# a non-zero eps that depends on x, the masked-source latent, the mask and t
# (a zero eps would make every sampler trivially agree)
def _j_eps(x9, t):
    return 0.1 * x9[..., :4] + 0.05 * x9[..., 4:8] * x9[..., 8:9] \
        + 1e-4 * t[:, None, None, None]


def _t_eps(x9, t):
    return 0.1 * x9[..., :4] + 0.05 * x9[..., 4:8] * x9[..., 8:9] \
        + 1e-4 * t[:, None, None, None]


def _jax_normals(key, n):
    """The per-step standard normals the JAX samplers draw: one key a step
    from jax.random.split(key, n), each drawn at the latent's shape."""
    keys = jax.random.split(key, n)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, SHAPE, jnp.float32))(keys))


def _assert_rel(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(eta):
    _, jss, _, tss = _schedules(eta=eta)
    x_T, zi, m = _latents()
    key = jax.random.PRNGKey(3) if eta > 0 else None
    want = np.asarray(j_ddim(_j_eps, jss, jnp.asarray(x_T), jnp.asarray(zi),
                             jnp.asarray(m), rng=key))
    noise = to_t(_jax_normals(key, jss.num_steps)) if eta > 0 else None
    got = t_ddim(_t_eps, tss, to_t(x_T), to_t(zi), to_t(m), noise=noise).numpy()
    _assert_rel(got, want)
    assert np.abs(want - x_T).max() > 0.1  # the chain moved


@pytest.mark.parametrize("clip_denoised", [False, True])
def test_ddpm_matches_jax(clip_denoised):
    jbase, _, tbase, _ = _schedules()
    x_T, zi, m = _latents(1)
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_ddpm(_j_eps, jbase, jnp.asarray(x_T), jnp.asarray(zi),
                             jnp.asarray(m), key, clip_denoised=clip_denoised))
    noise = to_t(_jax_normals(key, jbase.num_timesteps))
    got = t_ddpm(_t_eps, tbase, to_t(x_T), to_t(zi), to_t(m), noise=noise,
                 clip_denoised=clip_denoised).numpy()
    _assert_rel(got, want)


def test_ddpm_clip_changes_the_chain():
    """clip_denoised clips x0 at every step: the two chains differ, so the
    parity cases above cover two paths."""
    _, _, tbase, _ = _schedules()
    x_T, zi, m = _latents(1)
    noise = torch.randn((tbase.num_timesteps, *SHAPE), generator=torch.Generator().manual_seed(0))
    a, b = (t_ddpm(_t_eps, tbase, to_t(x_T), to_t(zi), to_t(m), noise=noise,
                   clip_denoised=c).numpy() for c in (False, True))
    assert np.abs(a - b).max() > 1e-2


def test_samplers_need_noise_or_a_generator():
    _, _, tbase, tss = _schedules(eta=0.5)
    x_T, zi, m = (to_t(a) for a in _latents())
    with pytest.raises(ValueError, match="eta > 0"):
        t_ddim(_t_eps, tss, x_T, zi, m)
    with pytest.raises(ValueError, match="generator or injected noise"):
        t_ddpm(_t_eps, tbase, x_T, zi, m)
    with pytest.raises(ValueError, match="noise must have shape"):
        t_ddim(_t_eps, tss, x_T, zi, m, noise=torch.zeros((3, *SHAPE)))
    # eta = 0 draws nothing
    _, _, _, det = _schedules(eta=0.0)
    t_ddim(_t_eps, det, x_T, zi, m)


def test_ddim_generator_draws_are_seeded():
    _, _, _, tss = _schedules(eta=0.5)
    x_T, zi, m = (to_t(a) for a in _latents())
    run = lambda seed: t_ddim(_t_eps, tss, x_T, zi, m,
                              generator=torch.Generator().manual_seed(seed)).numpy()
    np.testing.assert_array_equal(run(0), run(0))
    assert np.abs(run(0) - run(1)).max() > 1e-3


# ---- the edit pipeline --------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    jm, variables, tm = pipeline_pair()
    return JEditPipeline(jm, variables), TEditPipeline(tm)


def _inputs():
    g = np.random.default_rng(0)
    image = g.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 6:20] = 0.0
    ref = g.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x_T = g.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return image, mask, ref, x_T


# the UNet bound of PARITY.md:51-53, 2e-4 x the output scale (images in [0,1])
IMAGE_ATOL = 2e-4


@pytest.mark.parametrize("paste_back,eta", [(None, 0.0), (0, 0.0), (8, 0.5)])
def test_edit_ddim_matches_jax(pipelines, paste_back, eta):
    """DDIM edits at CFG scale 5 with x_T injected and the posterior mode;
    at eta 0.5 the port gets the normals the JAX program draws from its
    seed (PRNGKey(seed) split into the encoder's and the sampler's keys)."""
    jp, tp = pipelines
    image, mask, ref, x_T = _inputs()
    steps, seed = 4, 11
    kw = dict(steps=steps, scale=5.0, sampler="ddim", eta=eta, seed=seed, x_T=x_T,
              paste_back=paste_back, det_first_stage=True)
    want = jp.edit_batch(image, mask, ref, **kw)
    noise = None
    if eta > 0:
        _, r_sample = jax.random.split(jax.random.PRNGKey(seed))
        keys = jax.random.split(r_sample, steps)
        noise = np.stack([np.asarray(jax.random.normal(k, x_T.shape, jnp.float32))
                          for k in keys])
    got = tp.edit_batch(image, mask, ref, noise=noise, **kw)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    if paste_back is not None:
        keep = mask[..., 0] == 1.0
        np.testing.assert_array_equal(got[keep], ((image + 1.0) / 2.0)[keep])
        # the edit region is the decode's, not the source's
        assert np.abs(got[~keep] - ((image + 1.0) / 2.0)[~keep]).max() > 1e-2


def test_edit_is_edit_batch_of_one(pipelines):
    _, tp = pipelines
    image, mask, ref, x_T = _inputs()
    kw = dict(steps=2, scale=5.0, sampler="ddim", seed=5, paste_back=2)
    got = tp.edit(image[0], mask[0], ref[0], x_T=x_T[:1], **kw)
    want = tp.edit_batch(image[:1], mask[:1], ref[:1], x_T=x_T[:1], **kw)[0]
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_edit_hands_the_model_dense_inputs(pipelines, monkeypatch):
    """edit() batches with ref[None], a view whose batch axis has stride 0;
    the pipeline copies its inputs, so the exemplar encoder sees a real
    batch's strides. On the card the bf16 result depended on them: edit()
    and the CLI's batch of one differed by up to 0.09 after 50 steps."""
    _, tp = pipelines
    image, mask, ref, x_T = _inputs()
    seen = []
    cond = tp.model.get_conditioning
    monkeypatch.setattr(tp.model, "get_conditioning",
                        lambda r: seen.append(r.stride()) or cond(r))
    tp.edit(image[0], mask[0], ref[0], steps=1, sampler="ddim", x_T=x_T[:1])
    assert seen == [(32 * 32 * 3, 32 * 3, 3, 1)]


def test_edit_draws_follow_the_seed(pipelines):
    """x_T, the encoder's sample and DDIM's noise come from the seeded
    generator: one seed gives one edit, another seed another."""
    _, tp = pipelines
    image, mask, ref, _ = _inputs()
    kw = dict(steps=2, scale=5.0, sampler="ddim", eta=0.5)
    a, b = (tp.edit_batch(image, mask, ref, seed=s, **kw) for s in (1, 1))
    np.testing.assert_array_equal(a, b)
    c = tp.edit_batch(image, mask, ref, seed=2, **kw)
    assert np.abs(a - c).max() > 1e-3
