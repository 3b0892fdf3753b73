"""The port's FID tools (``pbe_tpu_torch/evaltools``) against
``pbe_tpu/evaltools`` on the CPU: InceptionV3 pool3 features on one random
torchvision-format state_dict (both pool conventions), the float64
statistics and the Fréchet distance, the mask boxes, the antialiased
crop-and-resize and resize, and the FID trio over the same batch,
predictions and feature function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pbe_tpu.evaltools import fid as jfid
from pbe_tpu.evaltools import fid_callback as jcb
from pbe_tpu.evaltools.inception import InceptionV3Features as JInception
from pbe_tpu.evaltools.inception import convert_inception_state_dict

from pbe_tpu_torch.evaltools import fid as tfid
from pbe_tpu_torch.evaltools import fid_callback as tcb
from pbe_tpu_torch.evaltools.inception import InceptionA
from pbe_tpu_torch.evaltools.inception import InceptionV3Features as TInception
from pbe_tpu_torch.evaltools.inception import (init_random, load_torchvision_state_dict,
                                               state_dict_from_flax)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torchvision_sd():
    """Seeded values for every key of a torchvision Inception3 state_dict
    (convs at their fan-in scale, BatchNorm statistics away from the
    identity), plus the fc/AuxLogits keys the loaders drop."""
    g = np.random.default_rng(0)
    sd = {}
    for k, v in TInception().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            sd[k] = g.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            sd[k] = g.uniform(0.5, 2.0, shape)
        elif k.endswith("bn.weight"):
            sd[k] = g.uniform(0.8, 1.2, shape)
        elif k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(7)
            continue
        else:
            sd[k] = g.standard_normal(shape) * 0.1
        sd[k] = sd[k].astype(np.float32)
    sd["fc.weight"] = np.zeros((1000, 2048), np.float32)
    sd["AuxLogits.fc.bias"] = np.zeros((1000,), np.float32)
    return sd


@pytest.mark.parametrize("fid_pools, size, batch", [(True, 299, 1), (True, 75, 2),
                                                    (False, 75, 2)])
def test_inception_features_match_jax(torchvision_sd, fid_pools, size, batch):
    x = np.random.default_rng(size).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    variables = convert_inception_state_dict(torchvision_sd)
    want = np.asarray(jax.jit(JInception(fid_pools=fid_pools).apply)(variables, x))
    model = load_torchvision_state_dict(TInception(fid_pools=fid_pools).eval(), torchvision_sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, 2048)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_flax_params_carry_back_to_the_torchvision_keys(torchvision_sd):
    sd = state_dict_from_flax(convert_inception_state_dict(torchvision_sd))
    kept = {k for k in torchvision_sd if k.split(".")[0] not in ("fc", "AuxLogits")}
    assert set(sd) == kept
    for k in kept:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(sd[k], torchvision_sd[k], err_msg=k)
    load_torchvision_state_dict(TInception(), sd)  # strict


def test_random_feature_fn_is_seeded_and_finite():
    x = np.random.default_rng(1).uniform(0, 1, (2, 75, 75, 3)).astype(np.float32)
    fn = tfid.make_inception_feature_fn(device="cpu", seed=3)
    a, b = fn(x), tfid.make_inception_feature_fn(device="cpu", seed=3)(torch.from_numpy(x))
    assert a.shape == (2, 2048) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert a.std() > 0
    block = lambda seed: init_random(InceptionA(16, 8), seed).branch1x1.conv.weight
    assert torch.equal(block(3), block(3)) and not torch.equal(block(3), block(4))


def test_running_stats_and_frechet_distance_match_jax():
    g = np.random.default_rng(2)
    feats = [g.standard_normal((n, 16)) * 0.5 + 0.1 for n in (5, 9, 3)]
    fake = [g.standard_normal((n, 16)) for n in (7, 6)]
    stats = []
    for mod in (tfid, jfid):
        real_s, fake_s = mod.RunningStats(), mod.RunningStats()
        for f in feats:
            real_s.update(f)
        for f in fake:
            fake_s.update(f.astype(np.float32))
        stats.append((real_s.finalize(), fake_s.finalize()))
    for (tm, ts), (jm, js) in zip(*stats):
        np.testing.assert_allclose(tm, jm, rtol=1e-10)
        np.testing.assert_allclose(ts, js, rtol=1e-10)
    (m1, s1), (m2, s2) = stats[0]
    np.testing.assert_allclose(tfid.frechet_distance(m1, s1, m2, s2),
                               jfid.frechet_distance(m1, s1, m2, s2), rtol=1e-10)
    np.testing.assert_allclose(np.cov(np.concatenate(feats), rowvar=False), s1, rtol=1e-10)
    # a rank-deficient pair (fewer samples than dimensions) stays finite
    few = tfid.RunningStats()
    few.update(feats[0])
    assert np.isfinite(tfid.frechet_distance(*few.finalize(), m2, s2))


def _masks():
    m = np.zeros((4, 40, 56, 1), np.float32)
    m[0, 3:17, 8:30] = 1.0
    m[1, 0:40, 55:56] = 1.0
    m[3, 20:21, 0:1] = 1.0  # row 2: empty -> the whole image
    return m


def test_bboxes_from_masks_equal_jax():
    m = _masks()
    got = tcb.bboxes_from_masks(torch.from_numpy(m))
    want = np.asarray(jcb.bboxes_from_masks(jnp.asarray(m)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[2], [0, 0, 40, 56])


def test_crop_and_resize_matches_scale_and_translate():
    g = np.random.default_rng(4)
    images = g.uniform(0, 1, (4, 40, 56, 3)).astype(np.float32)
    boxes = np.asarray([[3.0, 8.0, 17.0, 30.0],       # integral edges
                        [0.5, 10.25, 39.75, 55.5],    # fractional edges
                        [12.3, 1.7, 13.9, 4.1],       # under 2 px: upsampled
                        [0.0, 0.0, 40.0, 56.0]], np.float32)
    for size in (299, 24):  # up- and downsampling (antialiased)
        got = tcb.crop_and_resize(torch.from_numpy(images), torch.from_numpy(boxes), size)
        want = np.asarray(jcb.crop_and_resize(jnp.asarray(images), jnp.asarray(boxes), size))
        assert got.shape == want.shape == (4, size, size, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h, w", [(512, 512), (64, 64), (224, 224), (37, 90)])
def test_resize_matches_jax_image_resize(h, w):
    x = np.random.default_rng(h + w).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    got = tcb.resize(torch.from_numpy(x), 299).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _shared_feature_fn():
    """A numpy feature function both trackers call: 16x16 area means of the
    (B,299,299,3) input (299 = 16*18 + 11; the last 11 rows and columns
    dropped) through a fixed random projection to 24 dimensions."""
    proj = np.random.default_rng(9).standard_normal((16 * 16 * 3, 24)).astype(np.float32)

    def fn(x):
        x = np.asarray(x, np.float32)[:, :288, :288]
        pooled = x.reshape(x.shape[0], 16, 18, 16, 18, 3).mean(axis=(2, 4))
        return pooled.reshape(x.shape[0], -1) @ proj

    return fn


def test_fid_trio_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a device the tracker takes CUDA, and raises where there is
    none rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcb.FIDTrioTracker(lambda x: x)
    assert tcb.FIDTrioTracker(lambda x: x, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcb.FIDTrioTracker(lambda x: x).device == torch.device("cuda")


def test_fid_trio_matches_jax():
    g = np.random.default_rng(6)
    b, s = 4, 64
    image = g.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.ones((b, s, s, 1), np.float32)
    for i, (y, x, hh, ww) in enumerate([(5, 9, 20, 31), (0, 0, 64, 10), (30, 40, 3, 2),
                                        (10, 10, 40, 40)]):
        mask[i, y:y + hh, x:x + ww] = 0.0
    batches = [{"image": image, "inpaint_image": image * mask, "mask": mask,
                "ref": g.standard_normal((b, 224, 224, 3)).astype(np.float32)}
               for _ in range(2)]
    preds = [g.uniform(0, 1, (b, s, s, 3)).astype(np.float32) for _ in range(2)]
    fn = _shared_feature_fn()
    got, want = tcb.FIDTrioTracker(fn, device="cpu"), jcb.FIDTrioTracker(fn)
    for batch, p in zip(batches, preds):
        got.update(batch, p)
        want.update(batch, p)
    got, want = got.compute(), want.compute()
    assert set(got) == set(want) == {"fid_global", "fid_local", "fid_ref"}
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_fid_between_dirs_matches_jax(tmp_path):
    g = np.random.default_rng(8)
    for d, n in (("a", 5), ("b", 4)):
        (tmp_path / d).mkdir()
        for i in range(n):
            Image.fromarray(g.integers(0, 256, (50, 70, 3), np.uint8)).save(
                tmp_path / d / f"{i}.png")
    fn = _shared_feature_fn()
    kw = dict(feature_fn=fn, batch_size=3, size=299)
    got = tfid.fid_between_dirs(str(tmp_path / "a"), str(tmp_path / "b"), **kw)
    want = jfid.fid_between_dirs(str(tmp_path / "a"), str(tmp_path / "b"), **kw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-10)
