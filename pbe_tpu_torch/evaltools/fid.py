"""Fréchet Inception Distance (port of ``pbe_tpu/evaltools/fid.py``):
features on the model's device, statistics in float64 numpy.

The math is the reference's eval_tool/fid/fid_score.py:138-247 (standard
pytorch-fid). The matrix square root's trace comes from an eigendecomposition
of the symmetrized product (sqrtm(A B) is similar to A^1/2 B A^1/2) instead
of scipy's Schur-based sqrtm. Statistics stream over batches, so a large
set never materializes its activation matrix; any (B,H,W,3)->(B,D) feature
function works (InceptionV3 pool3 by default).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Iterable

import numpy as np
import torch

IMAGE_EXTENSIONS = ("bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp")


@dataclasses.dataclass
class RunningStats:
    """Streaming mean/covariance over feature batches (float64)."""

    n: int = 0
    s1: np.ndarray | None = None  # sum x
    s2: np.ndarray | None = None  # sum x x^T

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        if self.s1 is None:
            d = feats.shape[1]
            self.s1 = np.zeros(d)
            self.s2 = np.zeros((d, d))
        self.n += feats.shape[0]
        self.s1 += feats.sum(axis=0)
        self.s2 += feats.T @ feats

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        mu = self.s1 / self.n
        # unbiased covariance, matching np.cov(rowvar=False)
        cov = (self.s2 - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def sqrtm_product_eigh(a: np.ndarray, b: np.ndarray) -> float:
    """trace(sqrtm(a @ b)) for symmetric PSD a, b: sqrtm(AB) has the
    eigenvalues of sqrtm(A^1/2 B A^1/2), which is symmetric PSD -> eigh."""
    wa, va = np.linalg.eigh(a)
    wa = np.clip(wa, 0, None)
    a_half = (va * np.sqrt(wa)) @ va.T
    m = a_half @ b @ a_half
    m = (m + m.T) / 2
    w = np.linalg.eigvalsh(m)
    return float(np.sqrt(np.clip(w, 0, None)).sum())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    tr_covmean = sqrtm_product_eigh(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = sqrtm_product_eigh(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def list_images(path: str) -> list[pathlib.Path]:
    p = pathlib.Path(path)
    return sorted(f for ext in IMAGE_EXTENSIONS for f in p.glob(f"*.{ext}"))


def _load_batch(files: list[pathlib.Path], size: int) -> np.ndarray:
    from PIL import Image

    out = np.empty((len(files), size, size, 3), np.float32)
    for i, f in enumerate(files):
        img = Image.open(f).convert("RGB").resize((size, size), Image.BILINEAR)
        out[i] = np.asarray(img, np.float32) / 255.0
    return out


def stats_for_images(feature_fn: Callable, files: Iterable[pathlib.Path],
                     batch_size: int = 50, size: int = 299) -> tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of ``feature_fn`` over image files (each resized
    to ``size``², [0,1]); a short last batch is zero-padded to
    ``batch_size`` and its padding rows dropped, as the JAX module does."""
    files = list(files)
    stats = RunningStats()
    for i in range(0, len(files), batch_size):
        chunk = files[i:i + batch_size]
        batch = _load_batch(chunk, size)
        if len(chunk) < batch_size:
            batch = np.concatenate([batch, np.zeros((batch_size - len(chunk), size, size, 3),
                                                    np.float32)])
        stats.update(np.asarray(feature_fn(batch))[:len(chunk)])
    return stats.finalize()


def make_inception_feature_fn(weights_path: str | None = None, fid_pools: bool = True,
                              seed: int = 0, device: str | torch.device = "cuda"):
    """(B,H,W,3) [0,1] (numpy or a tensor) -> (B,2048) float32 numpy pool3
    features, computed on ``device`` in fp32 (TF32 off). With no weights file
    the network is randomly initialized from ``seed`` (mechanics only — real
    FID needs the torchvision/FID weights file)."""
    from pbe_tpu_torch.evaltools.inception import (InceptionV3Features, init_random,
                                                   load_torchvision_state_dict)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    model = InceptionV3Features(fid_pools=fid_pools).to(device).eval()
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        load_torchvision_state_dict(model, sd.get("state_dict", sd))
    else:
        init_random(model, seed)

    @torch.inference_mode()
    def features(x) -> np.ndarray:
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return model(x).cpu().numpy()

    return features


def fid_between_dirs(path1: str, path2: str, feature_fn: Callable | None = None,
                     batch_size: int = 50, size: int = 299) -> float:
    """Two-directory FID (calculate_fid_given_paths, fid_score.py:231-247);
    the default feature function is the random-weight Inception on the
    card."""
    feature_fn = feature_fn or make_inception_feature_fn()
    m1, s1 = stats_for_images(feature_fn, list_images(path1), batch_size, size)
    m2, s2 = stats_for_images(feature_fn, list_images(path2), batch_size, size)
    return frechet_distance(m1, s1, m2, s2)
