"""Legacy SD datasets (port of ``pbe_tpu/data/legacy.py``): ImageNet,
ImageNet-SR, LSUN and the txt2img iterable base.

The reference's leftover Stable-Diffusion data layer (ldm/data/imagenet.py,
ldm/data/lsun.py, ldm/data/base.py) on numpy + PIL only, with the
reference's example-dict surfaces; on the same tree on disk and the same
``numpy.random.Generator`` it yields the JAX module's arrays and keys in
the same order:

  * ``ImageNetTrain`` / ``ImageNetValidation``  (imagenet.py:26-269):
    synset-foldered tree -> {image [-1,1] HWC, relpath, synsets, class_label,
    human_label}. The reference's download/untar machinery is not ported:
    the tree must already be on disk (data_root); a missing tree raises with
    the expected layout in the message.
  * ``ImageNetSR(Train|Validation)``            (imagenet.py:272-394):
    random/center crop of a random fraction in [min_crop_f, max_crop_f],
    smallest-max-size resize to `size`, degradation resize to size/f ->
    {image, LR_image}. PIL interpolations map 1:1; the cv2 codes map to
    their closest PIL resamplers (INTER_AREA -> BOX); the bsrgan
    degradations raise ImportError, as upstream they live in
    taming-transformers.
  * ``LSUNBase`` + Churches/Bedrooms/Cats splits (lsun.py:9-92):
    txt filelist -> center square crop -> resize -> p-flip -> [-1,1].
  * ``Txt2ImgIterableBaseDataset``              (base.py:5-22): the chainable
    iterable-dataset interface.

Every random choice draws from an explicit ``numpy.random.Generator`` (the
reference uses the global numpy/torch state), so pipelines stay seedable.
"""
from __future__ import annotations

import abc
import os
from typing import Any, Iterator, Sequence

import numpy as np
from PIL import Image

_PIL_INTERP = {
    "linear": Image.BILINEAR,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "lanczos": Image.LANCZOS,
    "nearest": Image.NEAREST,
    "box": Image.BOX,
    "hamming": Image.HAMMING,
    # closest-PIL mapping of the cv2 codes (imagenet.py:314-326)
    "cv_nearest": Image.NEAREST,
    "cv_bilinear": Image.BILINEAR,
    "cv_bicubic": Image.BICUBIC,
    "cv_area": Image.BOX,
    "cv_lanczos": Image.LANCZOS,
    "pil_nearest": Image.NEAREST,
    "pil_bilinear": Image.BILINEAR,
    "pil_bicubic": Image.BICUBIC,
    "pil_box": Image.BOX,
    "pil_hamming": Image.HAMMING,
    "pil_lanczos": Image.LANCZOS,
}


def _load_rgb(path: str) -> np.ndarray:
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def _to_pm1(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) / 127.5 - 1.0).astype(np.float32)


def _center_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    crop = min(h, w)
    return img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]


def _smallest_max_size(img: np.ndarray, size: int, resample: int) -> np.ndarray:
    """Resize so the smaller side equals `size`, preserving aspect ratio
    (albumentations.SmallestMaxSize semantics, imagenet.py:303)."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    out = Image.fromarray(img).resize(
        (max(size, round(w * scale)), max(size, round(h * scale))), resample
    )
    return np.asarray(out, np.uint8)


class Txt2ImgIterableBaseDataset(abc.ABC):
    """Chainable iterable-dataset interface (base.py:5-22)."""

    def __init__(self, num_records: int = 0, valid_ids: Sequence | None = None,
                 size: int = 256):
        self.num_records = num_records
        self.valid_ids = valid_ids
        self.sample_ids = valid_ids
        self.size = size

    def __len__(self) -> int:
        return self.num_records

    @abc.abstractmethod
    def __iter__(self) -> Iterator[dict]:
        ...


class LSUNBase:
    """lsun.py:9-60 — filelist-driven square-crop dataset."""

    def __init__(self, txt_file: str, data_root: str, size: int | None = None,
                 interpolation: str = "bicubic", flip_p: float = 0.5,
                 rng: np.random.Generator | None = None):
        with open(txt_file) as f:
            self.image_paths = f.read().splitlines()
        self.data_root = data_root
        self.size = size
        self.interpolation = _PIL_INTERP[interpolation]
        self.flip_p = flip_p
        self.rng = rng or np.random.default_rng()
        self.labels = {
            "relative_file_path_": list(self.image_paths),
            "file_path_": [os.path.join(data_root, p) for p in self.image_paths],
        }

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> dict[str, Any]:
        example = {k: v[i] for k, v in self.labels.items()}
        img = _center_square(_load_rgb(example["file_path_"]))
        if self.size is not None:
            img = np.asarray(
                Image.fromarray(img).resize((self.size, self.size),
                                            self.interpolation), np.uint8)
        if self.rng.uniform() < self.flip_p:
            img = img[:, ::-1]
        example["image"] = _to_pm1(img)
        return example


class LSUNChurchesTrain(LSUNBase):
    def __init__(self, **kw):
        super().__init__(txt_file="data/lsun/church_outdoor_train.txt",
                         data_root="data/lsun/churches", **kw)


class LSUNChurchesValidation(LSUNBase):
    def __init__(self, flip_p=0.0, **kw):
        super().__init__(txt_file="data/lsun/church_outdoor_val.txt",
                         data_root="data/lsun/churches", flip_p=flip_p, **kw)


class LSUNBedroomsTrain(LSUNBase):
    def __init__(self, **kw):
        super().__init__(txt_file="data/lsun/bedrooms_train.txt",
                         data_root="data/lsun/bedrooms", **kw)


class LSUNBedroomsValidation(LSUNBase):
    def __init__(self, flip_p=0.0, **kw):
        super().__init__(txt_file="data/lsun/bedrooms_val.txt",
                         data_root="data/lsun/bedrooms", flip_p=flip_p, **kw)


class LSUNCatsTrain(LSUNBase):
    def __init__(self, **kw):
        super().__init__(txt_file="data/lsun/cat_train.txt",
                         data_root="data/lsun/cats", **kw)


class LSUNCatsValidation(LSUNBase):
    def __init__(self, flip_p=0.0, **kw):
        super().__init__(txt_file="data/lsun/cat_val.txt",
                         data_root="data/lsun/cats", flip_p=flip_p, **kw)


class ImageNetBase:
    """imagenet.py:26-131 minus the download/untar machinery.

    data_root must hold the extracted ``synset/filename.JPEG`` tree (the
    layout the reference's _prepare produces under ``datadir``); an optional
    ``filelist.txt`` of relpaths pins ordering, and an optional
    ``synset_human.txt`` ("n01440764 tench, Tinca tinca" lines) provides
    human labels.
    """

    def __init__(self, data_root: str, size: int = 256,
                 random_crop: bool = False, process_images: bool = True,
                 rng: np.random.Generator | None = None):
        if not os.path.isdir(data_root):
            raise FileNotFoundError(
                f"{data_root} not found. Expected the extracted ImageNet "
                "tree: <data_root>/<synset>/<image>.JPEG (+ optional "
                "filelist.txt, synset_human.txt). The reference's "
                "academictorrents auto-download is not ported."
            )
        self.data_root = data_root
        self.size = size
        self.random_crop = random_crop
        self.process_images = process_images
        self.rng = rng or np.random.default_rng()
        self._load()

    def _load(self) -> None:
        filelist = os.path.join(self.data_root, "filelist.txt")
        if os.path.exists(filelist):
            with open(filelist) as f:
                self.relpaths = f.read().splitlines()
        else:
            self.relpaths = sorted(
                os.path.join(d, f)
                for d in os.listdir(self.data_root)
                if os.path.isdir(os.path.join(self.data_root, d))
                for f in os.listdir(os.path.join(self.data_root, d))
            )
        self.synsets = [p.split("/")[0] for p in self.relpaths]
        self.abspaths = [os.path.join(self.data_root, p) for p in self.relpaths]
        unique = sorted(set(self.synsets))
        class_dict = {s: i for i, s in enumerate(unique)}
        self.class_labels = [class_dict[s] for s in self.synsets]

        human_file = os.path.join(self.data_root, "synset_human.txt")
        if os.path.exists(human_file):
            with open(human_file) as f:
                human = dict(line.split(maxsplit=1) for line in
                             f.read().splitlines() if line.strip())
        else:
            human = {}
        self.human_labels = [human.get(s, s).strip() for s in self.synsets]

    def __len__(self) -> int:
        return len(self.relpaths)

    def __getitem__(self, i: int) -> dict[str, Any]:
        example = {
            "relpath": self.relpaths[i],
            "synsets": self.synsets[i],
            "class_label": self.class_labels[i],
            "human_label": self.human_labels[i],
            "file_path_": self.abspaths[i],
        }
        if not self.process_images:
            return example
        # taming ImagePaths semantics: smallest-side resize then square crop
        img = _smallest_max_size(_load_rgb(self.abspaths[i]), self.size,
                                 Image.BICUBIC)
        h, w = img.shape[:2]
        if self.random_crop:
            top = int(self.rng.integers(0, h - self.size + 1))
            left = int(self.rng.integers(0, w - self.size + 1))
        else:
            top, left = (h - self.size) // 2, (w - self.size) // 2
        img = img[top:top + self.size, left:left + self.size]
        example["image"] = _to_pm1(img)
        return example


class ImageNetTrain(ImageNetBase):
    """imagenet.py:134-196; random_crop defaults True for training."""

    def __init__(self, data_root: str, random_crop: bool = True, **kw):
        super().__init__(data_root=data_root, random_crop=random_crop, **kw)


class ImageNetValidation(ImageNetBase):
    """imagenet.py:197-269; center crop."""

    def __init__(self, data_root: str, random_crop: bool = False, **kw):
        super().__init__(data_root=data_root, random_crop=random_crop, **kw)


class ImageNetSR:
    """imagenet.py:272-373 — superresolution pairs {image, LR_image}."""

    def __init__(self, base, size: int, degradation: str,
                 downscale_f: int = 4, min_crop_f: float = 0.5,
                 max_crop_f: float = 1.0, random_crop: bool = True,
                 rng: np.random.Generator | None = None):
        assert size and float(size / downscale_f).is_integer()
        assert max_crop_f <= 1.0
        if degradation in ("bsrgan", "bsrgan_light"):
            raise ImportError(
                "bsrgan degradations live in taming-transformers/"
                "ldm.modules.image_degradation upstream and are not bundled; "
                "use a cv_*/pil_* interpolation degradation"
            )
        self.base = base
        self.size = size
        self.LR_size = size // downscale_f
        self.min_crop_f = min_crop_f
        self.max_crop_f = max_crop_f
        self.center_crop = not random_crop
        self.degradation = _PIL_INTERP[degradation]
        self.rng = rng or np.random.default_rng()

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> dict[str, Any]:
        example = dict(self.base[i])
        img = _load_rgb(example["file_path_"])
        side = int(min(img.shape[:2]) *
                   self.rng.uniform(self.min_crop_f, self.max_crop_f))
        h, w = img.shape[:2]
        if self.center_crop:
            top, left = (h - side) // 2, (w - side) // 2
        else:
            top = int(self.rng.integers(0, h - side + 1))
            left = int(self.rng.integers(0, w - side + 1))
        img = img[top:top + side, left:left + side]
        img = _smallest_max_size(img, self.size, Image.BOX)  # INTER_AREA
        lr = np.asarray(
            Image.fromarray(img).resize((self.LR_size, self.LR_size),
                                        self.degradation), np.uint8)
        example["image"] = _to_pm1(img)
        example["LR_image"] = _to_pm1(lr)
        return example


class ImageNetSRTrain(ImageNetSR):
    """imagenet.py:375-384."""

    def __init__(self, data_root: str, **kw):
        base = ImageNetTrain(data_root=data_root, process_images=False)
        super().__init__(base=base, **kw)


class ImageNetSRValidation(ImageNetSR):
    """imagenet.py:386-394."""

    def __init__(self, data_root: str, **kw):
        base = ImageNetValidation(data_root=data_root, process_images=False)
        super().__init__(base=base, **kw)
