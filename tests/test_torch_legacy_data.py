"""The port's legacy datasets (data/legacy.py), its copies of the bbox and
synthetic test-bench scripts, and its config loader, against the JAX
package: the same trees on disk give the same arrays and keys in the same
order, the same files byte for byte, and every target the JAX loader maps
resolves in the port."""
import os
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

from pbe_tpu import config as jconfig
from pbe_tpu.data import legacy as jlegacy

from pbe_tpu_torch import config as tconfig
from pbe_tpu_torch.data import legacy as tlegacy
from pbe_tpu_torch.scripts import make_synthetic_test_bench, read_bbox

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_imagenet_tree(root, n_synsets=2, per_synset=2, hw=(40, 56)):
    rng = np.random.default_rng(0)
    rels = []
    for s in range(n_synsets):
        syn = f"n{s:08d}"
        os.makedirs(os.path.join(root, syn), exist_ok=True)
        for j in range(per_synset):
            rel = f"{syn}/img_{j}.JPEG"
            Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(
                os.path.join(root, rel))
            rels.append(rel)
    with open(os.path.join(root, "synset_human.txt"), "w") as f:
        f.write("n00000000 tench, Tinca tinca\nn00000001 goldfish\n")
    return rels


def _same_examples(jds, tds):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        assert list(got) == list(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
            else:
                assert got[k] == v


@pytest.fixture
def inet(tmp_path):
    root = str(tmp_path / "inet")
    os.makedirs(root)
    _write_imagenet_tree(root, hw=(80, 96))
    return root


@pytest.mark.parametrize("cls,kw", [
    ("ImageNetTrain", dict(size=32)),
    ("ImageNetValidation", dict(size=32)),
    ("ImageNetSRTrain", dict(size=32, degradation="pil_bicubic", downscale_f=4)),
    ("ImageNetSRValidation", dict(size=32, degradation="cv_area", random_crop=False,
                                  min_crop_f=0.5, max_crop_f=1.0)),
])
def test_imagenet_datasets_match_jax(inet, cls, kw):
    rng = lambda: np.random.default_rng(3)
    jds = getattr(jlegacy, cls)(data_root=inet, rng=rng(), **kw)
    tds = getattr(tlegacy, cls)(data_root=inet, rng=rng(), **kw)
    _same_examples(jds, tds)


def test_imagenet_filelist_and_errors_match_jax(inet, tmp_path):
    rels = sorted(os.path.relpath(os.path.join(d, f), inet)
                  for d, _, fs in os.walk(inet) for f in fs if f.endswith(".JPEG"))
    with open(os.path.join(inet, "filelist.txt"), "w") as f:
        f.write("\n".join(reversed(rels)))
    jds = jlegacy.ImageNetValidation(data_root=inet, size=16)
    tds = tlegacy.ImageNetValidation(data_root=inet, size=16, process_images=False)
    assert tds.relpaths == jds.relpaths == list(reversed(rels))
    assert tds.class_labels == jds.class_labels and tds.human_labels == jds.human_labels
    with pytest.raises(FileNotFoundError, match="not ported"):
        tlegacy.ImageNetValidation(data_root=str(tmp_path / "missing"))
    with pytest.raises(ImportError):
        tlegacy.ImageNetSRTrain(data_root=inet, size=32, degradation="bsrgan")


def test_lsun_datasets_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    root = tmp_path / "lsun"
    os.makedirs(root)
    names = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (50, 70, 3), np.uint8)).save(root / f"img_{i}.png")
        names.append(f"img_{i}.png")
    (tmp_path / "list.txt").write_text("\n".join(names))
    for flip_p in (0.0, 0.5, 1.0):
        kw = dict(txt_file=str(tmp_path / "list.txt"), data_root=str(root), size=24,
                  flip_p=flip_p)
        _same_examples(jlegacy.LSUNBase(rng=np.random.default_rng(1), **kw),
                       tlegacy.LSUNBase(rng=np.random.default_rng(1), **kw))
    # the six splits read their reference filelists relative to the working dir
    monkeypatch.chdir(tmp_path)
    for name in ("churches", "bedrooms", "cats"):
        os.makedirs(f"data/lsun/{name}", exist_ok=True)
    for txt in ("church_outdoor", "bedrooms", "cat"):
        for split in ("train", "val"):
            with open(f"data/lsun/{txt}_{split}.txt", "w") as f:
                f.write("a.png\nb.png\n")
    for cls in ("LSUNChurchesTrain", "LSUNChurchesValidation", "LSUNBedroomsTrain",
                "LSUNBedroomsValidation", "LSUNCatsTrain", "LSUNCatsValidation"):
        j, t = getattr(jlegacy, cls)(), getattr(tlegacy, cls)()
        assert (t.labels, t.flip_p, t.interpolation) == (j.labels, j.flip_p, j.interpolation)


def test_txt2img_iterable_interface():
    class Impl(tlegacy.Txt2ImgIterableBaseDataset):
        def __iter__(self):
            return iter([{"caption": "x"}] * self.num_records)

    ds = Impl(num_records=5, valid_ids=[1, 2], size=64)
    assert len(ds) == 5 and ds.sample_ids == [1, 2] and sum(1 for _ in ds) == 5
    with pytest.raises(TypeError):
        tlegacy.Txt2ImgIterableBaseDataset()


def _run_jax_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(ROOT, "scripts", name), run_name="__main__")


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_read_bbox_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    images = tmp_path / "images"
    os.makedirs(images)
    g = np.random.default_rng(2)
    rows = ["ImageID,Source,LabelName,Confidence,XMin,XMax,YMin,YMax"]
    for i, ext in enumerate((".jpg", ".png", ".jpeg", None)):
        if ext:
            Image.fromarray(g.integers(0, 255, (30 + 7 * i, 50, 3), np.uint8)).save(
                images / f"im{i}{ext}")
        for _ in range(4):  # some boxes too small or too large to keep
            x1, y1 = g.uniform(0, 0.5, 2)
            w, h = g.uniform(0.05, 0.5, 2) ** (1 + (i % 2))
            rows.append(f"im{i},x,/m/0,1,{x1:.4f},{min(x1 + w, 1):.4f},{y1:.4f},"
                        f"{min(y1 + h, 1):.4f}")
    rows.append("im0,x,/m/0,1,0.0,1.0,0.0,1.0")
    (tmp_path / "boxes.csv").write_text("\n".join(rows) + "\n")
    args = lambda out: ["--csv", str(tmp_path / "boxes.csv"), "--image_dir", str(images),
                        "--out_dir", str(tmp_path / out)]
    _run_jax_script(monkeypatch, "read_bbox.py", args("jax"))
    assert read_bbox.main(args("port")) >= 1
    want = _files(tmp_path / "jax")
    assert want and _files(tmp_path / "port") == want


def test_make_synthetic_test_bench_is_the_jax_scripts_bytes(tmp_path, monkeypatch):
    args = lambda out: ["--n", "3", "--size", "48", "--seed", "5", "--out", str(tmp_path / out)]
    _run_jax_script(monkeypatch, "make_synthetic_test_bench.py", args("jax"))
    ids = make_synthetic_test_bench.main(args("port"))
    want = _files(tmp_path / "jax")
    assert len(want) == 10 and ids == [100000, 100001, 100002]
    assert _files(tmp_path / "port") == want


# ---- the config loader ------------------------------------------------------------------

def test_port_maps_every_target_the_jax_loader_maps():
    jal, tal = jconfig._TARGET_ALIASES, tconfig._TARGET_ALIASES
    assert list(tal) == list(jal)
    for key, target in jal.items():
        want = ("torch.nn.Identity" if key == "torch.nn.Identity"
                else "pbe_tpu_torch." + target.removeprefix("pbe_tpu."))
        assert tal[key] == want, key
        assert callable(tconfig.get_obj_from_str(key)), key


@pytest.mark.parametrize("sentinel", ["__is_first_stage__", "__is_unconditional__"])
def test_sentinels_are_returned(sentinel):
    assert tconfig.instantiate_from_config(sentinel) == jconfig.instantiate_from_config(sentinel)
    with pytest.raises(KeyError):
        tconfig.instantiate_from_config({"params": {}})


def _yaml_targets(tmp_path):
    inet = str(tmp_path / "inet")
    os.makedirs(inet)
    _write_imagenet_tree(inet)
    bench = str(tmp_path / "bench")
    make_synthetic_test_bench.write_bench(bench, n=1, size=32)
    return {
        "ldm.data.imagenet.ImageNetValidation": ({"data_root": inet, "size": 16},
                                                 tlegacy.ImageNetValidation),
        "ldm.data.imagenet.ImageNetSRTrain": ({"data_root": inet, "size": 16,
                                               "degradation": "pil_nearest"},
                                              tlegacy.ImageNetSRTrain),
        "ldm.data.test_bench_dataset.COCOImageDataset": ({"test_bench_dir": bench}, None),
        "ldm.modules.diffusionmodules.openaimodel.EncoderUNetModel": (
            {"image_size": 16, "in_channels": 4, "model_channels": 32, "out_channels": 3,
             "num_res_blocks": 1, "attention_resolutions": [2], "channel_mult": [1, 2]}, None),
        "ldm.modules.encoders.modules.BERTEmbedder": ({"n_embed": 32, "n_layer": 1}, None),
        "ldm.modules.encoders.modules.TransformerEmbedder": (
            {"n_embed": 32, "n_layer": 1, "vocab_size": 10}, None),
        "ldm.modules.encoders.modules.ClassEmbedder": ({"embed_dim": 8, "n_classes": 3}, None),
        "ldm.modules.encoders.modules.SpatialRescaler": ({"n_stages": 1}, None),
        "torch.nn.Identity": ({}, None),
    }


def test_yaml_targets_build_in_the_port(tmp_path):
    """tests/test_legacy_datasets.py::test_yaml_targets_build's shape, for
    each kind of target the repair added: the port builds its own class
    where the JAX loader builds its."""
    import torch

    for target, (params, cls) in _yaml_targets(tmp_path).items():
        obj = tconfig.instantiate_from_config({"target": target, "params": params})
        want = type(jconfig.instantiate_from_config({"target": target, "params": params}))
        got = type(obj)
        if target == "torch.nn.Identity":
            assert got is torch.nn.Identity
            continue
        assert got.__module__ == "pbe_tpu_torch." + want.__module__.removeprefix("pbe_tpu.")
        assert got.__name__ == want.__name__
        if cls is not None:
            assert isinstance(obj, cls)
    ds = tconfig.instantiate_from_config({"target": "ldm.data.test_bench_dataset.COCOImageDataset",
                                          "params": {"test_bench_dir": str(tmp_path / "bench")}})
    assert len(ds) == 1 and ds[0]["image"].shape == (32, 32, 3)
