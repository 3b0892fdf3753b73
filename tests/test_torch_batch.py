"""The port's host-side modules of the edit CLIs against the JAX package's
(byte for byte: paste_back, bbox masks, transforms, CLIP preprocessing,
the watermark, the COCOEE dataset and its loader) and the port's batch API
on a tiny pipeline on the CPU."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pbe_tpu.data import transforms as JT
from pbe_tpu.data.augment import clip_preprocess as j_clip_preprocess
from pbe_tpu.data.loader import DataLoader as JDataLoader
from pbe_tpu.data.masks import bbox_mask as j_bbox_mask
from pbe_tpu.data.test_bench import COCOEEDataset as JCOCOEEDataset
from pbe_tpu.models.vae_asym import feather_mask as j_feather_mask
from pbe_tpu.models.vae_asym import paste_back as j_paste_back
from pbe_tpu.pipelines.batch import load_mask_from_image_or_txt as j_load_mask_any
from pbe_tpu.utils.watermark import embed_watermark as j_embed

from pbe_tpu_torch.data import transforms as TT
from pbe_tpu_torch.data.augment import clip_preprocess
from pbe_tpu_torch.data.loader import DataLoader
from pbe_tpu_torch.data.masks import bbox_mask
from pbe_tpu_torch.data.test_bench import COCOEEDataset
from pbe_tpu_torch.models.vae_asym import feather_mask, paste_back
from pbe_tpu_torch.pipelines.batch import (infer_all, infer_batch,
                                           load_mask_from_image_or_txt, run_batch,
                                           visualize_batch)
from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params
from pbe_tpu_torch.utils.async_writer import AsyncWriter
from pbe_tpu_torch.utils.watermark import embed_watermark, extract_watermark

from _torch_port import write_test_bench


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _keep_mask(n=2, hw=32):
    m = np.ones((n, hw, hw, 1), np.float32)
    m[:, 8:24, 6:20] = 0.0
    m[1:, 2:5, 25:30] = 0.0  # a second hole near an edge in example 1
    return m


@pytest.mark.parametrize("radius", [0, 1, 3, 8])
def test_feather_and_paste_back_match_jax(radius):
    g = np.random.default_rng(radius)
    decoded = g.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    original = g.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = _keep_mask()
    want_w = np.asarray(j_feather_mask(jnp.asarray(mask), radius))
    got_w = feather_mask(torch.from_numpy(mask), radius).numpy()
    np.testing.assert_array_equal(got_w, want_w)
    want = np.asarray(j_paste_back(jnp.asarray(decoded), jnp.asarray(original),
                                   jnp.asarray(mask), feather=radius))
    got = paste_back(torch.from_numpy(decoded), torch.from_numpy(original),
                     torch.from_numpy(mask), feather=radius).numpy()
    np.testing.assert_array_equal(got, want)
    # the feather is one-sided: every mask==1 pixel is the original's bits
    keep = mask[..., 0] == 1.0
    np.testing.assert_array_equal(got[keep], original[keep])
    if radius:
        assert ((got_w > 0) & (got_w < 1)).any()  # a real transition band


def test_bbox_mask_matches_jax():
    for h, w, box in ((32, 48, (3, 4, 20, 30)), (17, 9, (0.4, 1.5, 8.6, 16.5)),
                      (8, 8, (0, 0, 8, 8)), (8, 8, (5, 5, 5, 7))):
        got, want = bbox_mask(h, w, box), j_bbox_mask(h, w, box)
        assert got.dtype == want.dtype and got.shape == want.shape == (h, w, 1)
        np.testing.assert_array_equal(got, want)


def _write_rgb(path, h, w, seed):
    g = np.random.default_rng(seed)
    Image.fromarray(g.integers(0, 256, (h, w, 3), np.uint8)).save(path)


def test_transforms_match_jax(tmp_path):
    _write_rgb(tmp_path / "img.png", 40, 56, 0)
    _write_rgb(tmp_path / "ref.jpg", 70, 50, 1)
    g = np.random.default_rng(2)
    Image.fromarray(g.integers(0, 256, (40, 56), np.uint8)).save(tmp_path / "mask.png")
    for size in (None, (32, 48)):
        np.testing.assert_array_equal(TT.load_image(str(tmp_path / "img.png"), size),
                                      JT.load_image(str(tmp_path / "img.png"), size))
        np.testing.assert_array_equal(TT.load_mask(str(tmp_path / "mask.png"), size),
                                      JT.load_mask(str(tmp_path / "mask.png"), size))
    for size in (224, 32):
        np.testing.assert_array_equal(TT.load_reference(str(tmp_path / "ref.jpg"), size),
                                      JT.load_reference(str(tmp_path / "ref.jpg"), size))
    x = g.uniform(-0.2, 1.2, (8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(TT.to_uint8(x), JT.to_uint8(x))
    np.testing.assert_array_equal(TT.unnormalize(x), JT.unnormalize(x))
    np.testing.assert_array_equal(TT.unnormalize_clip(x), JT.unnormalize_clip(x))
    panels = [g.uniform(0, 1, (16, 16, 3)).astype(np.float32),
              g.uniform(0, 1, (8, 12, 3)).astype(np.float32)]
    np.testing.assert_array_equal(TT.hstack_grid(panels), JT.hstack_grid(panels))
    TT.save_image(x, str(tmp_path / "a.png"))
    JT.save_image(x, str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    u8 = {"image": g.integers(0, 256, (2, 8, 8, 3), np.uint8),
          "mask": g.integers(0, 256, (2, 8, 8, 1), np.uint8),
          "ref": g.integers(0, 256, (2, 8, 8, 3), np.uint8), "id": ["a", "b"]}
    got, want = TT.unpack_uint8_batch(u8), JT.unpack_uint8_batch(u8)
    assert sorted(got) == sorted(want)
    for k in ("image", "inpaint_image", "mask", "ref"):
        np.testing.assert_array_equal(got[k], want[k])


def test_clip_preprocess_matches_jax(tmp_path):
    _write_rgb(tmp_path / "ref.png", 61, 47, 3)
    img = Image.open(tmp_path / "ref.png").convert("RGB")
    for size in (224, 64):
        np.testing.assert_array_equal(clip_preprocess(img, size), j_clip_preprocess(img, size))


def test_watermark_matches_jax_and_reads_back():
    g = np.random.default_rng(4)
    img = np.kron(g.integers(40, 215, (32, 32, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    got = embed_watermark(img)
    np.testing.assert_array_equal(got, j_embed(img))
    assert extract_watermark(got) == b"Paint-by-Example"
    assert np.abs(got.astype(np.int16) - img).max() > 0  # it did stamp


def test_load_mask_from_image_or_txt_matches_jax(tmp_path):
    (tmp_path / "box.txt").write_text("3.2 4 20.7 30\n")
    g = np.random.default_rng(5)
    Image.fromarray(g.integers(0, 256, (40, 40), np.uint8)).save(tmp_path / "m.png")
    for name in ("box.txt", "m.png"):
        got = load_mask_from_image_or_txt(str(tmp_path / name), (32, 36))
        want = j_load_mask_any(str(tmp_path / name), (32, 36))
        assert got.shape == (32, 36, 1)
        np.testing.assert_array_equal(got, want)


def test_cocoee_dataset_and_loader_match_jax(tmp_path):
    ids = write_test_bench(tmp_path, 5, 32)
    ds, jds = COCOEEDataset(str(tmp_path)), JCOCOEEDataset(str(tmp_path))
    assert len(ds) == len(jds) == 5
    for i in range(5):
        got, want = ds[i], jds[i]
        assert got["id"] == want["id"] == f"{ids[i]:012d}"
        for k in ("image", "inpaint_image", "mask", "ref"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for shuffle in (False, True):
        kw = dict(batch_size=2, shuffle=shuffle, num_workers=2, drop_last=False, seed=3)
        got, want = list(DataLoader(ds, **kw)), list(JDataLoader(jds, **kw))
        assert [len(b["id"]) for b in got] == [2, 2, 1]  # the ragged tail is kept
        assert [b["id"] for b in got] == [b["id"] for b in want]
        for gb, wb in zip(got, want):
            np.testing.assert_array_equal(gb["image"], wb["image"])
    assert len(DataLoader(ds, 2, drop_last=True)) == 2
    assert [len(b["id"]) for b in DataLoader(ds, 2, drop_last=True)] == [2, 2]


class _Failing:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise OSError("unreadable sample 2")
        return {"x": np.full((2,), i, np.float32)}


def test_data_loader_raises_a_failing_sample():
    """A sample that fails to load ends the iteration with its error; the
    consumer is not left waiting for a batch that never comes."""
    seen, errors = [], []

    def consume():
        try:
            for batch in DataLoader(_Failing(), 2, num_workers=2):
                seen.append(batch["x"][:, 0].tolist())
        except OSError as e:
            errors.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == [[0.0, 1.0]] and len(errors) == 1 and "sample 2" in str(errors[0])


def test_async_writer_writes_and_reraises(tmp_path):
    with AsyncWriter(workers=2, max_queue=2) as w:
        for i in range(5):
            w.submit((tmp_path / f"{i}.txt").write_text, str(i))
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{i}.txt" for i in range(5)]
    w = AsyncWriter(workers=1)
    w.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        w.close()


# ---- the batch API on a tiny pipeline -------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    pipe, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                            verbose=False)
    randomize_zero_params(pipe.model, seed=0)
    return pipe


KW = dict(steps=2, scale=5.0, sampler="ddim", seed=7, det_first_stage=True)


def test_infer_and_visualize_batch(tiny, tmp_path):
    ids = write_test_bench(tmp_path / "bench", 3, 16)
    batch = next(iter(DataLoader(COCOEEDataset(str(tmp_path / "bench")), 3)))
    preds = infer_batch(tiny, batch, **KW)
    want = tiny.edit_batch(batch["image"], batch["mask"], batch["ref"], **KW)
    assert preds.shape == (3, 16, 16, 3) and preds.dtype == np.float32
    np.testing.assert_array_equal(preds, want)
    u8 = infer_batch(tiny, batch, output="uint8", **KW)
    assert u8.dtype == np.uint8 and np.abs(u8.astype(int) - TT.to_uint8(preds)).max() <= 1
    grids = visualize_batch(batch, preds, str(tmp_path / "out"), ids=batch["id"])
    # [before | mask | inpaint | ref | GT | pred], 2 px apart, each panel
    # resized to the tallest one's height (the 224^2 exemplar)
    assert len(grids) == 3 and grids[0].shape == (224, 6 * 224 + 5 * 2, 3)
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == sorted([f"grid_{i:012d}.png" for i in ids]
                           + [f"pred_{i:012d}.png" for i in ids])
    saved = np.asarray(Image.open(tmp_path / "out" / f"pred_{ids[0]:012d}.png"))
    np.testing.assert_array_equal(saved, TT.to_uint8(preds[0]))
    with AsyncWriter() as w:
        again = run_batch(tiny, batch, str(tmp_path / "run"), writer=w, **KW)
    np.testing.assert_array_equal(again, preds)
    assert len(list((tmp_path / "run").iterdir())) == 6


def test_infer_all_walks_matched_stems(tiny, tmp_path):
    g = np.random.default_rng(6)
    for sub in ("img", "mask", "ref", "out"):
        (tmp_path / sub).mkdir()
    for stem in ("a", "b", "c", "lonely"):
        Image.fromarray(g.integers(0, 256, (20, 20, 3), np.uint8)).save(
            tmp_path / "img" / f"{stem}.png")
    for stem in ("a", "b", "c"):
        Image.fromarray(g.integers(0, 256, (30, 30, 3), np.uint8)).save(
            tmp_path / "ref" / f"{stem}.jpg")
    Image.fromarray(np.where(g.uniform(size=(20, 20)) > 0.5, 255, 0).astype(np.uint8)).save(
        tmp_path / "mask" / "a.png")
    (tmp_path / "mask" / "b.txt").write_text("2 3 10 12")
    (tmp_path / "mask" / "c.txt").write_text("0 0 8 16")
    n = infer_all(tiny, str(tmp_path / "img"), str(tmp_path / "mask"), str(tmp_path / "ref"),
                  str(tmp_path / "out"), size=(16, 16), batch_size=2, **KW)
    assert n == 3  # "lonely" has no mask and no reference
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == sorted([f"{k}_{s}.png" for s in "abc" for k in ("grid", "pred")])
    # the one-example batch (c) is the edit of its own inputs
    image = TT.load_image(str(tmp_path / "img" / "c.png"), (16, 16))
    mask = load_mask_from_image_or_txt(str(tmp_path / "mask" / "c.txt"), (16, 16))
    ref = TT.load_reference(str(tmp_path / "ref" / "c.jpg"))
    want = tiny.edit(image, mask, ref, **KW)
    got = np.asarray(Image.open(tmp_path / "out" / "pred_c.png"))
    np.testing.assert_array_equal(got, TT.to_uint8(want))
