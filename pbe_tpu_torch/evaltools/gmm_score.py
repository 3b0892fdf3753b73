"""QS (quality score): GMM log-likelihood of Inception pool3 features
(port of ``pbe_tpu/evaltools/gmm_score.py``).

Spec: eval_tool/gmm/gmm_score_coco.py:49-108 — per-image
``gmm.score_samples(features)``, clipped to [0, 300], /300, mean x100.
The reference loads a pretrained sklearn GMM pickle (k=20 fit on COCO2017).

The log-likelihood is computed here, in float64 torch on the given device,
from the fitted attributes (``weights_``, ``means_``,
``precisions_cholesky_``, ``covariance_type``): sklearn's
``_estimate_log_gaussian_prob`` + ``logsumexp`` for the four covariance
types, so the scoring path needs no sklearn (a reference pickle needs it
only to unpickle). A PCA is applied the same way from ``mean_``,
``components_``, ``whiten`` and ``explained_variance_``. ``fit_gmm`` keeps
the lazy sklearn import of the JAX module.
"""
from __future__ import annotations

import math
import pickle
from typing import Callable, Iterable

import numpy as np
import torch


def qs_from_loglik(loglik: np.ndarray, min_v: float = 0.0, max_v: float = 300.0) -> float:
    scores = np.clip((np.asarray(loglik) - min_v) / (max_v - min_v), 0.0, 1.0)
    return float(scores.mean() * 100.0)


def _f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _pca_transform(pca, feats: torch.Tensor) -> torch.Tensor:
    """sklearn ``PCA.transform``: (x - mean_) components_^T, divided by
    sqrt(explained_variance_) (floored at float64 eps) where ``whiten``."""
    dev = feats.device
    out = (feats - _f64(pca.mean_, dev)) @ _f64(pca.components_, dev).T
    if getattr(pca, "whiten", False):
        scale = _f64(pca.explained_variance_, dev).sqrt()
        out = out / scale.clamp_min(np.finfo(np.float64).eps)
    return out


def gmm_log_likelihood(feats, gmm, pca=None,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """Per-row log-likelihood (sklearn ``score_samples``) of (N, D) features
    under a fitted Gaussian mixture, in float64 on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    x = _f64(feats, device)
    if pca is not None:
        x = _pca_transform(pca, x)
    n, d = x.shape
    means = _f64(gmm.means_, device)
    chol = _f64(gmm.precisions_cholesky_, device)
    kind = gmm.covariance_type
    # log det of the precision's Cholesky factor, per component
    if kind == "full":
        log_det = torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(1)
        maha = torch.stack([((x @ u) - (mu @ u)).square().sum(1)
                            for mu, u in zip(means, chol)], dim=1)
    elif kind == "tied":
        log_det = torch.log(torch.diagonal(chol)).sum().expand(means.shape[0])
        maha = torch.stack([((x @ chol) - (mu @ chol)).square().sum(1) for mu in means],
                           dim=1)
    elif kind == "diag":
        log_det = torch.log(chol).sum(1)
        prec = chol.square()
        maha = ((means.square() * prec).sum(1) - 2.0 * (x @ (means * prec).T)
                + x.square() @ prec.T)
    elif kind == "spherical":
        log_det = d * torch.log(chol)
        prec = chol.square()
        maha = ((means.square().sum(1) * prec) - 2.0 * (x @ (means.T * prec))
                + torch.outer(x.square().sum(1), prec))
    else:
        raise ValueError(f"unknown covariance_type {kind!r}")
    log_prob = -0.5 * (d * math.log(2 * math.pi) + maha) + log_det
    weighted = log_prob + torch.log(_f64(gmm.weights_, device))
    return torch.logsumexp(weighted, dim=1).cpu().numpy()


def gmm_score(
    feature_fn: Callable[[np.ndarray], np.ndarray],
    images01: Iterable[np.ndarray],
    gmm,
    pca=None,
    batch_size: int = 50,
    device: str | torch.device = "cuda",
) -> float:
    """images01: iterable of (H,W,3) [0,1] arrays at the extractor's size;
    the log-likelihoods are computed on ``device``."""
    images = list(images01)
    logs = []
    for i in range(0, len(images), batch_size):
        feats = np.asarray(feature_fn(np.stack(images[i:i + batch_size])))
        logs.append(gmm_log_likelihood(feats, gmm, pca, device))
    return qs_from_loglik(np.concatenate(logs))


def load_gmm(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def fit_gmm(features: np.ndarray, n_components: int = 20, seed: int = 0):
    from sklearn.mixture import GaussianMixture

    gmm = GaussianMixture(n_components=n_components, random_state=seed)
    gmm.fit(features)
    return gmm
