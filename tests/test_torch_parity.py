"""Golden value-parity tests against PyTorch for the op semantics that are
easy to get subtly wrong across frameworks (padding alignment, norm eps,
softmax precision, activation variants) plus a full CLIP tower cross-check
against HuggingFace transformers with converted weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn

from pbe_tpu.ops.image import nearest_upsample_2x
from pbe_tpu.ops.attention import multi_head_attention

torch.manual_seed(0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)))


def _nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return np.transpose(x_nchw.detach().numpy(), (0, 2, 3, 1))


def test_conv3x3_stride1_padding_matches_torch(np_rng):
    x = np_rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    w = np_rng.standard_normal((4, 5, 3, 3)).astype(np.float32)
    b = np_rng.standard_normal(4).astype(np.float32)
    ours = nn.Conv(4, (3, 3), padding=((1, 1), (1, 1)))
    params = {"params": {"kernel": jnp.asarray(np.transpose(w, (2, 3, 1, 0))),
                         "bias": jnp.asarray(b)}}
    got = np.asarray(ours.apply(params, jnp.asarray(x)))
    want = _nhwc(F.conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), padding=1))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_conv3x3_stride2_padding_matches_torch(np_rng):
    """UNet Downsample: torch pads symmetrically even at stride 2."""
    x = np_rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    w = np_rng.standard_normal((3, 3, 3, 3)).astype(np.float32)
    ours = nn.Conv(3, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)), use_bias=False)
    params = {"params": {"kernel": jnp.asarray(np.transpose(w, (2, 3, 1, 0)))}}
    got = np.asarray(ours.apply(params, jnp.asarray(x)))
    want = _nhwc(F.conv2d(_nchw(x), torch.from_numpy(w), stride=2, padding=1))
    assert got.shape == want.shape == (1, 4, 4, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_vae_downsample_asymmetric_padding_matches_torch(np_rng):
    """VAE Downsample: F.pad((0,1,0,1)) + stride-2 valid conv
    (diffusionmodules/model.py:62-81)."""
    from pbe_tpu.models.vae import Downsample

    x = np_rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ds = Downsample()
    params = ds.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = np.asarray(ds.apply(params, jnp.asarray(x)))

    w = np.transpose(np.asarray(params["params"]["conv"]["kernel"]), (3, 2, 0, 1))
    b = np.asarray(params["params"]["conv"]["bias"])
    xt = F.pad(_nchw(x), (0, 1, 0, 1))
    want = _nhwc(F.conv2d(xt, torch.from_numpy(w), torch.from_numpy(b), stride=2))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_nearest_upsample_matches_torch(np_rng):
    x = np_rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    got = np.asarray(nearest_upsample_2x(jnp.asarray(x)))
    want = _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
    np.testing.assert_allclose(got, want)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm_matches_torch(np_rng, eps):
    from pbe_tpu.ops.norms import GroupNorm32

    c = 8
    x = np_rng.standard_normal((2, 4, 4, c)).astype(np.float32)
    gn = GroupNorm32(num_groups=4, epsilon=eps)
    params = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # randomize affine
    params = jax.tree.map(
        lambda p: jnp.asarray(np_rng.standard_normal(p.shape), jnp.float32), params
    )
    got = np.asarray(gn.apply(params, jnp.asarray(x)))
    tg = torch.nn.GroupNorm(4, c, eps=eps)
    tg.weight.data = torch.from_numpy(np.asarray(params["params"]["norm"]["scale"]))
    tg.bias.data = torch.from_numpy(np.asarray(params["params"]["norm"]["bias"]))
    want = _nhwc(tg(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_multi_head_attention_matches_torch(np_rng):
    b, n, h, d = 2, 16, 4, 8
    q = np_rng.standard_normal((b, n, h * d)).astype(np.float32)
    k = np_rng.standard_normal((b, n, h * d)).astype(np.float32)
    v = np_rng.standard_normal((b, n, h * d)).astype(np.float32)
    got = np.asarray(multi_head_attention(*map(jnp.asarray, (q, k, v)), num_heads=h))

    qt = torch.from_numpy(q).view(b, n, h, d).transpose(1, 2)
    kt = torch.from_numpy(k).view(b, n, h, d).transpose(1, 2)
    vt = torch.from_numpy(v).view(b, n, h, d).transpose(1, 2)
    want = F.scaled_dot_product_attention(qt, kt, vt)
    want = want.transpose(1, 2).reshape(b, n, h * d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_single_token_cross_attention_equals_full_attention(np_rng):
    """The PBE fast path: with one context token, full attention == value
    broadcast, independent of q/k."""
    from pbe_tpu.ops.attention import single_token_attention

    b, n, h, d = 2, 16, 4, 8
    q = np_rng.standard_normal((b, n, h * d)).astype(np.float32)
    k = np_rng.standard_normal((b, 1, h * d)).astype(np.float32)
    v = np_rng.standard_normal((b, 1, h * d)).astype(np.float32)
    full = np.asarray(multi_head_attention(*map(jnp.asarray, (q, k, v)), num_heads=h))
    fast = np.asarray(single_token_attention(jnp.asarray(v), n))
    np.testing.assert_allclose(fast, full, atol=1e-5)


def test_gelu_variants_match_torch(np_rng):
    x = np_rng.standard_normal((128,)).astype(np.float32)
    # exact (erf) gelu used by GEGLU / mapper MLP
    got = np.asarray(nn.gelu(jnp.asarray(x), approximate=False))
    want = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # quick gelu used by CLIP
    from pbe_tpu.models.clip_vit import quick_gelu

    got = np.asarray(quick_gelu(jnp.asarray(x)))
    want = (torch.from_numpy(x) * torch.sigmoid(1.702 * torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_clip_tower_matches_transformers(np_rng):
    """Full tiny CLIP vision tower vs HF CLIPVisionModel with converted
    weights — validates both the flax tower and the weight converter."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from pbe_tpu.convert import convert_clip_vision_state_dict
    from pbe_tpu.models.clip_vit import CLIPVisionTower

    hf_cfg = CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8,
        hidden_act="quick_gelu",
    )
    hf = CLIPVisionModel(hf_cfg).eval()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    params, dropped = convert_clip_vision_state_dict(sd)
    assert all("position_ids" in d for d in dropped), dropped

    tower = CLIPVisionTower(
        hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
        patch_size=8, image_size=32,
    )
    x = np_rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    _, pooled = tower.apply(params, jnp.asarray(x))

    with torch.no_grad():
        out = hf(pixel_values=_nchw(x))
    np.testing.assert_allclose(
        np.asarray(pooled), out.pooler_output.numpy(), atol=2e-4
    )
