"""The port's data pipeline (``pbe_tpu_torch/data``) against ``pbe_tpu/data``
on one synthetic OpenImages tree written by the JAX package's writer: every
mask function, the exemplar augmentation, both datasets and the data
module's first batches are bitwise equal for the same seeds, with the C++
helpers on and with both packages forced onto the numpy/PIL fallback. Then
the port's own native build against its fallback, its tree writer and its
config surface."""
import csv
import filecmp
import math

import numpy as np
import pytest
from PIL import Image, ImageDraw

from pbe_tpu import config as jconfig
from pbe_tpu.data import augment as jaugment
from pbe_tpu.data import masks as jmasks
from pbe_tpu.data import native as jnative
from pbe_tpu.data.openimages import OpenImagesDataset as JOpenImages
from pbe_tpu.data.quadruple import QuadrupleDataset as JQuadruple
from scripts.make_synthetic_openimages import make_tree as j_make_tree

from pbe_tpu_torch import config as tconfig
from pbe_tpu_torch.data import augment as taugment
from pbe_tpu_torch.data import masks as tmasks
from pbe_tpu_torch.data import native as tnative
from pbe_tpu_torch.data.openimages import OpenImagesDataset as TOpenImages
from pbe_tpu_torch.data.quadruple import QuadrupleDataset as TQuadruple
from pbe_tpu_torch.scripts.make_synthetic_openimages import make_tree as t_make_tree

SIZE = 64


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("oi")
    j_make_tree(str(out), n_train=6, n_val=4, size=96, seed=0)
    return str(out)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages on the C++ helpers, or both forced onto numpy/PIL."""
    if request.param == "native":
        if not (jnative.available() and tnative.available()):
            pytest.skip("no C++ compiler: the native helpers are not built")
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    return request.param


def _equal(got, want):
    """Bitwise equality of nested results (arrays, tuples, dicts, scalars)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


BBOX = (14.5, 20.0, 50.25, 44.0)


@pytest.mark.parametrize("fn, args", [
    ("bezier_curve", lambda r: (r.uniform(0, 60, (4, 2)), 33)),
    ("blob_polygon", lambda r: (SIZE, SIZE, BBOX, r)),
    ("arbitrary_blob_mask", lambda r: (SIZE, SIZE, BBOX, r)),
    ("training_mask", lambda r: (SIZE, SIZE, BBOX, r, 0.5)),
    ("mask_geometry", lambda r: (SIZE, SIZE, BBOX, r, 0.5)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_mask_functions_equal_jax(native_mode, fn, args):
    for seed in range(8):  # both arms of the bbox/blob draws
        got = getattr(tmasks, fn)(*args(np.random.default_rng(seed)))
        want = getattr(jmasks, fn)(*args(np.random.default_rng(seed)))
        _equal(got, want)


def test_geometry_raster_bbox_and_crop_equal_jax(native_mode):
    for seed in range(6):
        geom = jmasks.mask_geometry(SIZE, SIZE, BBOX, np.random.default_rng(seed), 0.5)
        _equal(tmasks.geometry_bbox(geom), jmasks.geometry_bbox(geom))
        for kw in ({}, dict(left=9.0, top=5.0, scale=1.7)):
            _equal(tmasks.rasterize_geometry(geom, 48, 40, **kw),
                   jmasks.rasterize_geometry(geom, 48, 40, **kw))
        mask = jmasks.training_mask(SIZE, SIZE, BBOX, np.random.default_rng(seed), 0.5)
        _equal(tmasks.mask_bbox(mask), jmasks.mask_bbox(mask))
        g = np.random.default_rng(seed)
        image, source = g.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        _equal(tmasks.crop_square_around_mask(image, source, mask, np.random.default_rng(seed)),
               jmasks.crop_square_around_mask(image, source, mask, np.random.default_rng(seed)))
    empty = np.zeros((SIZE, SIZE, 1), np.float32)
    assert tmasks.mask_bbox(empty) is None is jmasks.mask_bbox(empty)


@pytest.mark.parametrize("kw", [{}, {"normalize": False}, {"color_jitter": 0.2}],
                         ids=["float", "uint8", "jitter"])
def test_augment_exemplar_equals_jax(tree, kw):
    img = Image.open(f"{tree}/images/train/syn000001.png").convert("RGB").crop((5, 9, 70, 61))
    for seed in range(6):  # flip, blur and their draws both ways
        _equal(taugment.augment_exemplar(img, np.random.default_rng(seed), **kw),
               jaugment.augment_exemplar(img, np.random.default_rng(seed), **kw))


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_openimages_dataset_equals_jax(tree, native_mode, uint8):
    for state in ("train", "validation"):
        kw = dict(state=state, image_size=SIZE, seed=3, uint8=uint8)
        got, want = TOpenImages(tree, **kw), JOpenImages(tree, **kw)
        assert got.ids == want.ids and len(got) == len(want) > 0
        for i in range(len(want)):
            _equal(got[i], want[i])


def test_quadruple_dataset_equals_jax(tree, tmp_path):
    m = np.full((96, 96), 255, np.uint8)
    m[30:70, 20:60] = 0  # black = edit region, white = keep
    Image.fromarray(m, "L").save(tmp_path / "mask.png")
    with open(tmp_path / "data.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["tgt", "src", "mask", "ref"])
        w.writeheader()
        for i in range(3):
            w.writerow({"tgt": f"{tree}/images/train/syn{i:06d}.png",
                        "src": f"{tree}/images/train/syn{i + 1:06d}.png",
                        "mask": str(tmp_path / "mask.png"),
                        "ref": f"{tree}/images/train/syn{i + 2:06d}.png"})
    for augment in (True, False):
        kw = dict(image_size=48, seed=5, augment=augment)
        got, want = TQuadruple(str(tmp_path / "data.csv"), **kw), JQuadruple(
            str(tmp_path / "data.csv"), **kw)
        assert len(got) == len(want) == 3
        for i in range(3):
            _equal(got[i], want[i])


def _data_config(tree):
    split = lambda state: {"target": "ldm.data.open-images.OpenImageDataset",
                           "params": {"state": state, "dataset_dir": tree,
                                      "arbitrary_mask_percent": 0.5, "image_size": SIZE}}
    return {"target": "main.DataModuleFromConfig",
            "params": {"batch_size": 2, "num_workers": 2, "train": split("train"),
                       "validation": split("validation")}}


def test_data_module_first_batches_equal_jax(tree, native_mode):
    got = tconfig.instantiate_from_config(_data_config(tree))
    want = jconfig.instantiate_from_config(_data_config(tree))
    assert type(got).__module__ == "pbe_tpu_torch.data.loader"
    for split in ("train_dataloader", "val_dataloader"):
        g, w = getattr(got, split)(), getattr(want, split)()
        assert len(g) == len(w) > 0
        _equal(next(iter(g)), next(iter(w)))
    assert got.test_dataloader() is None


def test_port_writer_writes_the_jax_tree(tree, tmp_path):
    t_make_tree(str(tmp_path), n_train=6, n_val=4, size=96, seed=0)
    for sub in ("images/train", "images/validation", "bbox/train", "bbox/validation"):
        names = sorted(p.name for p in (tmp_path / sub).iterdir())
        assert len(names) == (6 if sub.endswith("train") else 4)
        _, mismatch, errors = filecmp.cmpfiles(f"{tree}/{sub}", tmp_path / sub, names,
                                               shallow=False)
        assert mismatch == errors == []


# -- the port's own C++ build against its numpy/PIL fallback ------------------

@pytest.fixture
def built():
    if not tnative.available():
        pytest.skip("no C++ compiler: the native helpers are not built")
    assert tnative.library_path().exists()
    assert tnative.library_path().parent.name == "build"


@pytest.mark.parametrize("degree", [1, 2, 3, 5])
def test_native_bezier_matches_numpy(built, degree):
    pts = np.random.default_rng(degree).uniform(0, 100, (degree + 1, 2))
    t = np.linspace(0.0, 1.0, 33)[:, None]
    binom = np.array([math.comb(degree, i) for i in range(degree + 1)], np.float64)
    i = np.arange(degree + 1)[None, :]
    want = (binom[None, :] * (t ** i) * ((1 - t) ** (degree - i))) @ pts
    np.testing.assert_allclose(tnative.bezier_eval(pts, 33), want, atol=1e-9)


def test_native_fill_polygon_close_to_pil(built):
    angles = np.sort(np.random.default_rng(0).uniform(0, 2 * np.pi, 12))
    poly = np.stack([32 + 20 * np.cos(angles), 32 + 20 * np.sin(angles)], axis=1)
    got = tnative.fill_polygon(poly, 64, 64)
    img = Image.new("L", (64, 64), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in poly.tolist()], fill=255)
    want = (np.asarray(img) > 127).astype(np.uint8)
    # the two rasterizers differ on edge pixels only
    assert np.abs(got.astype(int) - want.astype(int)).sum() / want.sum() < 0.08
    assert got[32, 32] == 1


def test_native_mask_bbox_matches_python(built):
    m = np.zeros((40, 50, 1), np.float32)
    m[5:17, 8:30] = 1.0
    assert tnative.mask_bbox(m[..., 0]) == tmasks.mask_bbox(m) == (8, 5, 30, 17)
    assert tnative.mask_bbox(np.zeros((4, 4))) is None


# -- config ---------------------------------------------------------------------

def test_merge_dotlist_matches_jax():
    overrides = ["model.params.timesteps=500", "data.params.batch_size=2",
                 "model.base_learning_rate=2.0e-05", "new.key=[1, 2]", "flag=true"]
    got = tconfig.merge_dotlist(tconfig.load_config("configs/v1.yaml"), overrides)
    want = jconfig.merge_dotlist(jconfig.load_config("configs/v1.yaml"), overrides)
    assert got == want and got["model"]["params"]["timesteps"] == 500
    with pytest.raises(ValueError):
        tconfig.merge_dotlist({}, ["no_equals_sign"])


@pytest.mark.parametrize("target", ["ldm.data.open-images.OpenImageDataset",
                                    "ldm.data.open-images.PBEQuadrupleDataset",
                                    "main.DataModuleFromConfig"])
def test_data_targets_resolve_to_the_port(target):
    got, want = tconfig.get_obj_from_str(target), jconfig.get_obj_from_str(target)
    assert got.__module__.startswith("pbe_tpu_torch.data.")
    assert got.__name__ == want.__name__
