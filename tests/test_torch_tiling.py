"""The port's tiling (pbe_tpu_torch.ops.tiling) against the JAX package's
(pbe_tpu.ops.tiling): unfold/fold, the border weighting bit for bit,
tiled_apply with uf and df, and a tiled 4-step edit of configs/tiny.yaml
(64^2, latent crops of 8 at stride 4: 49 crops, one UNet call at batch 98
a step) through EditPipeline(tiling=) against the JAX pipeline's, same
weights, fp32 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.ops import tiling as jt
from pbe_tpu.pipelines.inference import EditPipeline as JEditPipeline

from pbe_tpu_torch.ops import tiling as tt
from pbe_tpu_torch.pipelines.inference import EditPipeline as TEditPipeline

from _torch_port import tiny_yaml_pair


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw,ks,stride", [((16, 24), (8, 8), (4, 4)),
                                          ((12, 12), (6, 4), (3, 2))],
                         ids=["square_crops", "oblong_crops"])
def test_unfold_fold_match_jax(hw, ks, stride):
    x = _x((2, *hw, 3))
    crops = tt.unfold(torch.from_numpy(x), ks, stride)
    want = np.asarray(jt.unfold(jnp.asarray(x), ks, stride))
    np.testing.assert_array_equal(crops.numpy(), want)
    np.testing.assert_array_equal(tt.fold(crops, hw, stride).numpy(),
                                  np.asarray(jt.fold(jnp.asarray(want), hw, stride)))


@pytest.mark.parametrize("geo,spec_kw", [
    ((8, 8, 3, 5), {}),
    ((6, 10, 1, 1), {}),
    ((16, 16, 4, 4), dict(tie_braker=False, clip_min_weight=0.05, clip_max_weight=0.3)),
], ids=["tie_braker", "single_crop", "no_tie_braker"])
def test_tile_weighting_is_jax_bit_for_bit(geo, spec_kw):
    spec_t, spec_j = tt.TilingSpec((8, 8), (4, 4), **spec_kw), jt.TilingSpec((8, 8), (4, 4),
                                                                             **spec_kw)
    np.testing.assert_array_equal(tt.delta_border(*geo[:2]), jt.delta_border(*geo[:2]))
    got, want = tt.tile_weighting(*geo, spec_t), jt.tile_weighting(*geo, spec_j)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _fns(uf, df):
    """The same up- or downsampling function of a crop in both frameworks:
    nearest upsampling by uf or mean pooling by df, then a channel mix."""
    mix = _x((3, 5), seed=9)

    def tfn(x):
        b, h, w, c = x.shape
        if uf > 1:
            x = x.repeat_interleave(uf, 1).repeat_interleave(uf, 2)
        if df > 1:
            x = x.reshape(b, h // df, df, w // df, df, c).mean(dim=(2, 4))
        return torch.tanh(x @ torch.from_numpy(mix))

    def jfn(x):
        b, h, w, c = x.shape
        if uf > 1:
            x = jnp.repeat(jnp.repeat(x, uf, 1), uf, 2)
        if df > 1:
            x = x.reshape(b, h // df, df, w // df, df, c).mean(axis=(2, 4))
        return jnp.tanh(x @ jnp.asarray(mix))

    return tfn, jfn


@pytest.mark.parametrize("uf,df", [(1, 1), (2, 1), (1, 2)], ids=["same", "uf2", "df2"])
def test_tiled_apply_matches_jax(uf, df):
    x = _x((2, 16, 24, 3), seed=1)
    tfn, jfn = _fns(uf, df)
    t_spec, j_spec = tt.TilingSpec((8, 8), (4, 4)), jt.TilingSpec((8, 8), (4, 4))
    got = tt.tiled_apply(tfn, torch.from_numpy(x), t_spec, uf=uf, df=df).numpy()
    want = np.asarray(jt.tiled_apply(jfn, jnp.asarray(x), j_spec, uf=uf, df=df))
    assert got.shape == want.shape == (2, 16 * uf // df, 24 * uf // df, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="cover the input exactly"):
        tt.tiled_apply(tfn, torch.from_numpy(x), tt.TilingSpec((8, 8), (5, 5)), uf=uf, df=df)
    with pytest.raises(NotImplementedError):
        tt.tiled_apply(tfn, torch.from_numpy(x), t_spec, uf=2, df=2)


def test_tiled_tiny_edit_matches_jax():
    jm, variables, tm = tiny_yaml_pair()
    spec_kw = dict(ks=(8, 8), stride=(4, 4))
    jp = JEditPipeline(jm, variables, tiling=jt.TilingSpec(**spec_kw))
    tp = TEditPipeline(tm, tiling=tt.TilingSpec(**spec_kw))
    g = np.random.default_rng(0)
    image = g.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = np.ones((1, 64, 64, 1), np.float32)
    mask[:, 16:48, 8:40] = 0.0
    ref = g.standard_normal((1, 224, 224, 3)).astype(np.float32)
    n = 64 // tm.latent_downsample
    x_T = g.standard_normal((1, n, n, 4)).astype(np.float32)
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    calls = []
    unet = tm.model.diffusion_model
    hook = unet.register_forward_hook(lambda m, args, out: calls.append(args[0].shape))
    try:
        got = tp.edit_batch(image, mask, ref, **kw)
    finally:
        hook.remove()
    want = jp.edit_batch(image, mask, ref, **kw)
    # 5 UNet calls (4 PLMS steps + the Heun call), each ONE call over all
    # (32 - 8) / 4 + 1 = 7 x 7 crops of the CFG-doubled batch
    assert calls == [torch.Size([2 * 49, 8, 8, 9])] * 5
    assert got.shape == want.shape == (1, 64, 64, 3)
    # the whole-edit bound of tests/test_torch_edit.py (PARITY.md:51-53)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # tiling changed the edit (the comparison is not the un-tiled path's)
    untiled = TEditPipeline(tm).edit_batch(image, mask, ref, **kw)
    assert np.abs(untiled - got).max() > 1e-3
