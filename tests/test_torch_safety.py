"""The port's safety checker (pbe_tpu_torch.models.safety) against the JAX
package's (pbe_tpu.models.safety) on one seeded diffusers-layout
state_dict that both load: CLIP width 64, 2 layers, patch 8, image 32 (one
64-wide head, as the loaders infer), projection 24, 5 + 3 concepts. Both
run in fp32 on the CPU; the unrounded embeddings and cosines agree to
float32 rounding, and the 3-decimal scores and flags exactly away from a
rounding edge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbe_tpu.convert import convert_safety_checker_state_dict
from pbe_tpu.models import safety as jsafety

from pbe_tpu_torch.models import safety as tsafety

from _torch_port import SAFETY_GEO, safety_state_dict

@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port(sd):
    module = tsafety.SafetyChecker(**SAFETY_GEO)
    module.load_state_dict({k: v for k, v in sd.items() if "position_ids" not in k})
    return tsafety.LoadedSafetyChecker(module.eval())


def _jax(sd):
    params, dropped = convert_safety_checker_state_dict({k: v.numpy() for k, v in sd.items()})
    assert dropped == ["vision_model.vision_model.embeddings.position_ids"]
    return jsafety.LoadedSafetyChecker(module=jsafety.SafetyChecker(**SAFETY_GEO), params=params)


def _jax_embeds(checker, pixels):
    from pbe_tpu.models.clip_vit import CLIPVisionTower

    t = {k: SAFETY_GEO[k] for k in ("hidden_size", "num_layers", "num_heads", "mlp_dim",
                              "patch_size", "image_size")}
    p = checker.params["params"]
    _, pooled = jax.jit(CLIPVisionTower(**t).apply)({"params": p["vision_model"]},
                                                    jnp.asarray(pixels))
    return np.asarray(pooled @ p["visual_projection"]["kernel"])


@pytest.mark.parametrize("thresholds", ["none_flag", "all_flag", "adjustment"])
def test_checker_matches_jax(thresholds):
    sd = safety_state_dict(seed=1, concept_thr=2.0)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    port = _port(sd)
    with torch.no_grad():
        embeds = port.module.embed(torch.from_numpy(x))
    cos = lambda bank: tsafety.cosine_distance(embeds, sd[bank]).numpy()
    concept_cos, special_cos = cos("concept_embeds"), cos("special_care_embeds")
    if thresholds == "all_flag":
        sd["concept_embeds_weights"][:] = -2.0
    elif thresholds == "adjustment":
        # special care fires for image 0 alone (at the special concept it
        # leads image 1 on most), and image 0's concept scores are -0.005
        # before the 0.01 adjustment: it flags only through it
        s = int(np.argmax(special_cos[0] - special_cos[1]))
        assert special_cos[0, s] - special_cos[1, s] > 0.006
        sd["special_care_embeds_weights"][s] = float(special_cos[0, s] + special_cos[1, s]) / 2
        sd["concept_embeds_weights"] = torch.from_numpy(concept_cos[0] + 0.005)
    port, jax_checker = _port(sd), _jax(sd)

    np.testing.assert_allclose(embeds.numpy(), _jax_embeds(jax_checker, x), rtol=0,
                               atol=2e-5 * np.abs(embeds.numpy()).max())
    with torch.no_grad():
        got = [t.numpy() for t in port.module(torch.from_numpy(x))]
    want = [np.asarray(t) for t in jax_checker.module.apply(jax_checker.params,
                                                           jnp.asarray(x))]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):  # 3-decimal scores, one step at most apart
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 + 1e-6)
    expected = {"none_flag": [False, False], "all_flag": [True, True]}
    assert list(got[0]) == expected.get(thresholds, list(got[0]))
    if thresholds == "adjustment":
        assert got[0][0] and (got[2][0] > 0).any() and not (got[2][1] > 0).any()


def test_safety_scores_adjustment_semantics():
    """The 0.01 adjustment is triggered only by a positive special score
    and can tip a concept score over the line (tests/test_safety.py)."""
    embeds = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    bank = np.asarray([[1.0, 0.0]], np.float32)
    for special_thr, want in ((0.9, [True, False]), (1.5, [False, False])):
        args = (embeds, bank, np.asarray([1.005], np.float32), bank,
                np.asarray([special_thr], np.float32))
        got = tsafety.safety_scores(*(torch.from_numpy(a) for a in args))
        ref = jsafety.safety_scores(*(jnp.asarray(a) for a in args))
        assert got[0].tolist() == want == [bool(v) for v in np.asarray(ref[0])]
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_round3_rounds_as_jax_does():
    """Scores on a grid through every rounding edge of 3 decimals: the
    port's round-half-to-even and division give JAX's bits."""
    v = np.linspace(-0.01, 0.01, 4001, dtype=np.float32)
    v = np.concatenate([v, np.nextafter(v, 1.0), (np.arange(-20, 21) + 0.5) / 1000.0]
                       ).astype(np.float32)
    np.testing.assert_array_equal(tsafety._round3(torch.from_numpy(v)).numpy(),
                                  np.asarray(jsafety._round3(jnp.asarray(v))))


@pytest.mark.parametrize("hw", [(512, 512), (512, 384), (100, 150)],
                         ids=["square_512", "nonsquare_512x384", "upsample_100x150"])
def test_preprocess_matches_jax_cubic_resize(hw):
    """The shortest edge to 224 by JAX's antialiased Keys cubic (a = -0.5),
    the centre crop and the CLIP normalization; 100x150 upsamples, where
    the kernel is not widened."""
    x = np.random.default_rng(3).random((2, *hw, 3)).astype(np.float32)
    got = tsafety.preprocess_for_safety(torch.from_numpy(x)).numpy()
    want = np.asarray(jsafety.preprocess_for_safety(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 224, 224, 3)
    # the weights agree to an fp32 ulp (XLA contracts the kernel's
    # polynomial into FMAs) and JAX contracts both axes in one einsum: the
    # CLIP-normalized values (|x| <= 2.2) agree to 3e-7 on average, and a
    # few of 301,056 to 2.2e-5 where both axes are resampled
    diff = np.abs(got - want)
    assert diff.max() <= 5e-5 and diff.mean() <= 1e-6, (diff.max(), diff.mean())


@pytest.mark.parametrize("layout", ["bin", "ckpt_state_dict"])
def test_load_safety_checker_infers_geometry(tmp_path, layout):
    sd = safety_state_dict(seed=4)
    path = tmp_path / ("safety.bin" if layout == "bin" else "safety.ckpt")
    torch.save(sd if layout == "bin" else {"state_dict": sd}, str(path))
    port = tsafety.load_safety_checker(str(path), device="cpu")
    jax_checker = jsafety.load_safety_checker(str(path))
    m, jm = port.module, jax_checker.module
    vision = m.vision_model.vision_model
    geo = (vision.embeddings.patch_embedding.out_channels, len(vision.encoder.layers),
           vision.encoder.layers[0].self_attn.heads, vision.encoder.layers[0].mlp.fc1.out_features,
           vision.embeddings.patch_embedding.kernel_size[0], m.image_size,
           m.visual_projection.out_features, m.concept_embeds.shape[0],
           m.special_care_embeds.shape[0])
    assert geo == (jm.hidden_size, jm.num_layers, jm.num_heads, jm.mlp_dim, jm.patch_size,
                   jm.image_size, jm.projection_dim, jm.num_concepts, jm.num_special)
    assert geo == tuple(SAFETY_GEO[k] for k in ("hidden_size", "num_layers", "num_heads", "mlp_dim",
                                          "patch_size", "image_size", "projection_dim",
                                          "num_concepts", "num_special"))
    images = np.random.default_rng(5).random((2, 48, 48, 3)).astype(np.float32)
    assert port.check(images)[1] == jax_checker.check(images)[1] == [True, True]


@pytest.mark.parametrize("enforce", [False, True], ids=["report_only", "enforce"])
def test_check_blacks_out_only_under_enforce(enforce):
    # image 0 flags, image 1 does not: thresholds from the port's cosines
    sd = safety_state_dict(seed=6, concept_thr=2.0)
    images = np.random.default_rng(7).random((2, 40, 56, 3)).astype(np.float32)
    port = _port(sd)
    with torch.no_grad():
        pixels = tsafety.preprocess_for_safety(torch.from_numpy(images), SAFETY_GEO["image_size"])
        cos = tsafety.cosine_distance(port.module.embed(pixels), sd["concept_embeds"])
    # the concept image 0 leads image 1 on most; a threshold halfway
    # between them flags image 0 alone, each score > 0.01 from 0
    j = int(torch.argmax(cos[0] - cos[1]))
    assert cos[0, j] - cos[1, j] > 0.02
    sd["concept_embeds_weights"][j] = (cos[0, j] + cos[1, j]) / 2
    sd["special_care_embeds_weights"][:] = 2.0
    port, jax_checker = _port(sd), _jax(sd)
    out, flags = port.check(images, enforce=enforce)
    want_out, want_flags = jax_checker.check(images, enforce=enforce)
    assert flags == want_flags == [True, False]
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(out[1], images[1])
    if enforce:
        assert not out[0].any()
    else:
        np.testing.assert_array_equal(out[0], images[0])
