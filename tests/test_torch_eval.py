"""The port's evaluation tools (``pbe_tpu_torch/evaltools/gmm_score.py``,
``clip_score.py`` and the four CLIs) against ``pbe_tpu/evaltools`` and
sklearn on the CPU: the GMM log-likelihood for every covariance type, QS,
the CLIP embedder on a tiny tower with the JAX weights carried across, the
mask-box crop, the region CLIP score; then each CLI in-process on a few
64^2 images against the port's own library call on the same inputs (the
library calls are the ones held against JAX above)."""
import contextlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.decomposition import PCA
from sklearn.mixture import GaussianMixture

from pbe_tpu.evaltools import clip_score as jclip
from pbe_tpu.evaltools import gmm_score as jgmm
from pbe_tpu.models.clip_vit import CLIPVisionConfig as JClipConfig

from pbe_tpu_torch.convert import state_dict_from_flax
from pbe_tpu_torch.evaltools import clip_score as tclip
from pbe_tpu_torch.evaltools import gmm_score as tgmm
from pbe_tpu_torch.evaltools.fid import fid_between_dirs, list_images, make_inception_feature_fn
from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig as TClipConfig
from pbe_tpu_torch.scripts import (create_square_gt_for_fid, eval_clip_score, eval_fid,
                                   eval_gmm)

# a tower at CLIP's 224 input (the crops are resized to 224) but narrow
TINY_CLIP = dict(hidden_size=64, num_layers=2, num_heads=2, mlp_dim=32, patch_size=32,
                 image_size=224)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each, and two
    BLAS threads for numpy (the FID trio's float64 eigendecompositions,
    which with a thread per core stall behind the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:  # scikit-learn's dependency, there wherever tests/test_torch_eval.py runs
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = lambda n: contextlib.nullcontext()
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


def _features(n=300, d=6, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, d)) * g.uniform(0.5, 3.0, d) + g.standard_normal(d))


@pytest.mark.parametrize("covariance_type", ["full", "tied", "diag", "spherical"])
def test_gmm_log_likelihood_matches_sklearn(covariance_type):
    x = _features()
    gmm = GaussianMixture(3, covariance_type=covariance_type, random_state=0).fit(x)
    want = gmm.score_samples(x)
    got = tgmm.gmm_log_likelihood(x, gmm, device="cpu")
    # float64 on both sides, the same formula; sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("whiten", [False, True])
def test_gmm_log_likelihood_through_a_pca_matches_sklearn(whiten):
    x = _features(d=8, seed=1)
    pca = PCA(4, whiten=whiten).fit(x)
    gmm = GaussianMixture(2, random_state=0).fit(pca.transform(x))
    want = gmm.score_samples(pca.transform(x))
    got = tgmm.gmm_log_likelihood(x, gmm, pca, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_qs_matches_the_jax_gmm_score():
    """The same fitted GMM and feature function: QS to 1e-10 (the clip to
    [0, 300] and the mean are the JAX module's)."""
    g = np.random.default_rng(2)
    proj = g.standard_normal((3, 5))
    # features concentrated enough that their log-likelihoods land in (0, 300)
    feature_fn = lambda imgs: imgs.mean(axis=(1, 2)) @ proj * 1e-4
    gmm = GaussianMixture(2, reg_covar=1e-8, random_state=0).fit(
        feature_fn(g.uniform(0, 1, (64, 4, 4, 3))))
    images = list(g.uniform(0, 1, (7, 4, 4, 3)))
    want = jgmm.gmm_score(feature_fn, images, gmm, batch_size=3)
    got = tgmm.gmm_score(feature_fn, images, gmm, batch_size=3, device="cpu")
    assert 0.0 < want < 100.0  # some log-likelihoods inside (0, 300)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(tgmm.qs_from_loglik(np.asarray([-5.0, 150.0, 400.0])),
                               jgmm.qs_from_loglik(np.asarray([-5.0, 150.0, 400.0])))


@pytest.fixture(scope="module")
def clip_pair():
    """The JAX embedder on a tiny tower with seeded weights (and a
    projection), and the port's with the same weights carried across."""
    jcfg = JClipConfig(**TINY_CLIP)
    shapes = jax.eval_shape(jcfg.build().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    g = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda s: jnp.asarray(g.standard_normal(s.shape) * 0.1, jnp.float32), shapes)
    proj = g.standard_normal((64, 24)).astype(np.float32)
    j = jclip.CLIPImageEmbedder(jcfg, variables=variables, projection=proj)
    params = jax.tree.map(np.asarray, variables["params"])
    sd = state_dict_from_flax({"cond_stage_model": {"transformer": params}})
    sd = {k.removeprefix("cond_stage_model.transformer."): v for k, v in sd.items()}
    t = tclip.CLIPImageEmbedder(TClipConfig(**TINY_CLIP), state_dict=sd, projection=proj,
                                device="cpu")
    return j, t


def test_clip_embedder_matches_jax(clip_pair):
    j, t = clip_pair
    x = np.random.default_rng(6).uniform(0, 1, (3, 224, 224, 3)).astype(np.float32)
    want, got = np.asarray(j(x)), t(x)
    assert got.shape == want.shape == (3, 24)
    # unit vectors from fp32 towers that differ only in the order of sums
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_clip_embedder_from_torch_reads_an_hf_state_dict(clip_pair, tmp_path):
    """HF's CLIPModel layout: the tower's vision_model.* keys, the
    visual_projection (out, in), text-side keys and a position_ids buffer
    that the tower does not have."""
    _, t = clip_pair
    sd = {k: v.clone() for k, v in t.tower.state_dict().items()}
    sd["visual_projection.weight"] = t.projection.T.clone()
    sd["vision_model.embeddings.position_ids"] = torch.arange(50)[None]
    sd["text_model.embeddings.token_embedding.weight"] = torch.zeros(3, 4)
    sd["logit_scale"] = torch.tensor(2.0)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    loaded = tclip.CLIPImageEmbedder.from_torch(str(path), TClipConfig(**TINY_CLIP),
                                                device="cpu")
    x = np.random.default_rng(7).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    np.testing.assert_array_equal(loaded(x), t(x))


@pytest.mark.parametrize("box", [(10, 30, 5, 50), None])
def test_crop_to_mask_bbox_is_bitwise_the_jax_one(box):
    g = np.random.default_rng(8)
    image = g.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64, 1), np.float32)
    if box:
        y1, y2, x1, x2 = box
        mask[y1:y2, x1:x2] = 1.0
    want = jclip.crop_to_mask_bbox(image, mask)
    got = tclip.crop_to_mask_bbox(image, mask)
    assert got.dtype == want.dtype and got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_region_clip_score_matches_jax(clip_pair):
    j, t = clip_pair
    g = np.random.default_rng(9)
    results = list(g.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32))
    refs = list(g.uniform(0, 1, (3, 48, 48, 3)).astype(np.float32))
    masks = [np.zeros((64, 64, 1), np.float32) for _ in range(3)]
    for i, m in enumerate(masks):
        m[8 * i:40, 4:20 + 8 * i] = 1.0
    want = jclip.region_clip_score(j, results, refs, masks, batch_size=2)
    got = tclip.region_clip_score(t, results, refs, masks, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---- the CLIs, in-process on the CPU ------------------------------------------

def _write_pngs(folder, n, size, seed):
    folder.mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(g.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            folder / f"{i:03d}.png")
    return str(folder)


def test_eval_fid_cli_equals_the_library_call(tmp_path, capsys):
    a = _write_pngs(tmp_path / "a", 3, 64, 10)
    b = _write_pngs(tmp_path / "b", 3, 64, 11)
    got = eval_fid.main([a, b, "--batch-size", "2", "--device", "cpu"])
    want = fid_between_dirs(a, b, make_inception_feature_fn(device="cpu"), batch_size=2)
    assert got == want and np.isfinite(got)
    assert f"FID: {want:.4f}" in capsys.readouterr().out


def test_eval_fid_cli_on_clip_features_equals_the_library_call(tmp_path, clip_pair):
    """--clip-features: the CLI builds ViT-B/32 (seeded random weights
    without --clip-weights) and its FID equals the library call's on the
    same embedder."""
    a = _write_pngs(tmp_path / "a", 3, 64, 12)
    b = _write_pngs(tmp_path / "b", 3, 64, 13)
    got = eval_fid.main([a, b, "--clip-features", "--batch-size", "3", "--device", "cpu"])
    emb = tclip.CLIPImageEmbedder(tclip.VIT_B32, device="cpu")
    want = fid_between_dirs(a, b, emb, batch_size=3, size=224)
    assert got == want and np.isfinite(got)


def test_eval_clip_score_cli_equals_the_library_call(tmp_path, capsys):
    from pbe_tpu_torch.data.test_bench import COCOEEDataset
    from pbe_tpu_torch.data.transforms import unnormalize_clip

    bench, results = tmp_path / "bench", tmp_path / "results"
    g = np.random.default_rng(14)
    ids = [7, 42]
    for sub in ("GT_3500", "Ref_3500", "Mask_bbox_3500"):
        (bench / sub).mkdir(parents=True)
    results.mkdir()
    np.save(bench / "id_list.npy", np.asarray(ids))
    for i in ids:
        for sub, suf in (("GT_3500", "GT"), ("Ref_3500", "ref")):
            Image.fromarray(g.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                bench / sub / f"{i:012d}_{suf}.png")
        m = np.zeros((64, 64), np.uint8)
        m[10:40, 20:50] = 255
        Image.fromarray(m).save(bench / "Mask_bbox_3500" / f"{i:012d}_mask.png")
        Image.fromarray(g.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            results / f"{i:012d}.png")
    got = eval_clip_score.main(["--result_dir", str(results), "--test_bench_dir", str(bench),
                                "--device", "cpu"])
    ds = COCOEEDataset(str(bench))
    exs = [ds[i] for i in range(len(ds))]
    want = tclip.region_clip_score(
        tclip.CLIPImageEmbedder(tclip.VIT_B32, device="cpu"),
        [np.asarray(Image.open(results / f"{e['id']}.png"), np.float32) / 255.0 for e in exs],
        [np.clip(unnormalize_clip(e["ref"]), 0, 1) for e in exs],
        [1.0 - e["mask"] for e in exs])
    assert got == want and -100.0 <= got <= 100.0
    assert "region CLIP score over 2 pairs" in capsys.readouterr().out


def test_eval_gmm_cli_equals_the_library_call(tmp_path):
    folder = _write_pngs(tmp_path / "imgs", 3, 64, 15)
    feature_fn = make_inception_feature_fn(device="cpu")
    images = [np.asarray(Image.open(f).convert("RGB").resize((299, 299), Image.BILINEAR),
                         np.float32) / 255.0 for f in list_images(folder)]
    feats = feature_fn(np.stack(images))
    # a GMM near these features, so that QS is not pinned at 0 or 100
    gmm = GaussianMixture(1, covariance_type="diag", reg_covar=1e-2, random_state=0).fit(
        np.concatenate([feats, feats + 0.01]))
    with open(tmp_path / "gmm.pkl", "wb") as f:
        pickle.dump(gmm, f)
    out = tmp_path / "qs.txt"
    got = eval_gmm.main([folder, "--gmm", str(tmp_path / "gmm.pkl"), "--batch-size", "2",
                         "--output_file", str(out), "--device", "cpu"])
    want = tgmm.gmm_score(feature_fn, images, gmm, batch_size=2, device="cpu")
    assert got == want and 0.0 <= got <= 100.0
    assert float(out.read_text()) == got


def test_create_square_gt_for_fid_cli(tmp_path):
    src = tmp_path / "coco"
    src.mkdir()
    g = np.random.default_rng(16)
    Image.fromarray(g.integers(0, 256, (40, 70, 3), dtype=np.uint8)).save(src / "a.jpg")
    Image.fromarray(g.integers(0, 256, (90, 50, 3), dtype=np.uint8)).save(src / "b.png")
    (src / "notes.txt").write_text("skipped")
    assert create_square_gt_for_fid.main([str(src), str(tmp_path / "out")]) == 2
    for name, img in (("a", Image.open(src / "a.jpg")), ("b", Image.open(src / "b.png"))):
        w, h = img.size
        s = min(w, h)
        want = img.convert("RGB").crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s,
                                        (h - s) // 2 + s)).resize((512, 512), Image.BICUBIC)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / f"{name}.png")),
                                      np.asarray(want))


@pytest.mark.parametrize("cli", [eval_fid, eval_clip_score, eval_gmm])
def test_eval_clis_exit_without_a_card_unless_asked_for_the_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {eval_fid: [str(tmp_path), str(tmp_path)],
            eval_clip_score: ["--result_dir", str(tmp_path)],
            eval_gmm: [str(tmp_path), "--gmm", "x.pkl"]}[cli]
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(argv)
