"""Training masks (port of ``pbe_tpu/data/masks.py``): bbox masks and
arbitrary Bézier-blob masks, their geometry-first variants and the square
crop around a mask.

Per example the training pipeline draws, with p = 1 - arbitrary_mask_percent,
the object's bbox as the mask, otherwise a random smooth blob around the
bbox built from Bézier segments through jittered points on an ellipse
around it (configs/v1.yaml ``arbitrary_mask_percent: 0.5``). Bézier curves
and polygon fills use the C++ helpers (``data/native.py``) when they are
built, numpy and PIL otherwise; the two fills differ at edge pixels.

Convention: returned masks are (H, W, 1) float32 with **1 = edit region**;
the model-level keep mask is 1 - this.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageDraw

from pbe_tpu_torch.data import native


def bezier_curve(points: np.ndarray, n: int = 24) -> np.ndarray:
    """Evaluate a Bézier curve of arbitrary degree at n parameters.

    points: (K, 2) control points. Returns (n, 2). Uses the C++ kernel
    (native/pbe_native.cpp, built by data/native.py); numpy Bernstein basis otherwise.
    """
    out = native.bezier_eval(points, n) if native.available() else None
    if out is not None:
        return out
    k = points.shape[0] - 1
    t = np.linspace(0.0, 1.0, n)[:, None]  # (n,1)
    # binomial coefficients
    binom = np.array([math.comb(k, i) for i in range(k + 1)], np.float64)
    i = np.arange(k + 1)[None, :]
    basis = binom[None, :] * (t**i) * ((1 - t) ** (k - i))  # (n, K)
    return basis @ points


def bbox_mask(h: int, w: int, bbox: tuple[float, float, float, float]) -> np.ndarray:
    """bbox (x1, y1, x2, y2) -> (H, W, 1) mask, 1 inside the box."""
    x1, y1, x2, y2 = bbox
    m = np.zeros((h, w), np.float32)
    m[int(round(y1)):int(round(y2)), int(round(x1)):int(round(x2))] = 1.0
    return m[..., None]


def blob_polygon(
    h: int,
    w: int,
    bbox: tuple[float, float, float, float],
    rng: np.random.Generator,
    n_anchors: int = 8,
    jitter: float = 0.25,
    expand: float = 0.15,
) -> np.ndarray:
    """Closed-contour polygon points of a random smooth blob around bbox.

    Anchors are placed on an ellipse circumscribing the (slightly expanded)
    bbox with radial jitter; consecutive anchors are joined by quadratic
    Bézier segments whose control point is jittered outward. Returns (N, 2)
    points in full-image coordinates, clipped to the canvas."""
    x1, y1, x2, y2 = bbox
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    rx = (x2 - x1) / 2 * (1 + expand)
    ry = (y2 - y1) / 2 * (1 + expand)
    rx = max(rx, 2.0)
    ry = max(ry, 2.0)

    angles = np.sort(rng.uniform(0, 2 * np.pi, n_anchors))
    radii = 1.0 + rng.uniform(-jitter, jitter, n_anchors)
    ax = cx + rx * radii * np.cos(angles)
    ay = cy + ry * radii * np.sin(angles)
    anchors = np.stack([ax, ay], axis=1)

    contour: list[np.ndarray] = []
    for i in range(n_anchors):
        p0 = anchors[i]
        p1 = anchors[(i + 1) % n_anchors]
        mid = (p0 + p1) / 2
        out_dir = mid - np.array([cx, cy])
        norm = np.linalg.norm(out_dir)
        if norm > 1e-6:
            out_dir = out_dir / norm
        ctrl = mid + out_dir * rng.uniform(-jitter, jitter) * max(rx, ry)
        contour.append(bezier_curve(np.stack([p0, ctrl, p1]), n=16)[:-1])
    poly = np.concatenate(contour, axis=0)
    poly[:, 0] = np.clip(poly[:, 0], 0, w - 1)
    poly[:, 1] = np.clip(poly[:, 1], 0, h - 1)
    return poly


def arbitrary_blob_mask(
    h: int,
    w: int,
    bbox: tuple[float, float, float, float],
    rng: np.random.Generator,
    n_anchors: int = 8,
    jitter: float = 0.25,
    expand: float = 0.15,
) -> np.ndarray:
    """Random smooth blob covering roughly the bbox region (rasterized)."""
    poly = blob_polygon(h, w, bbox, rng, n_anchors, jitter, expand)
    if native.available():
        filled = native.fill_polygon(poly, h, w)
        if filled is not None:
            return filled.astype(np.float32)[..., None]
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in poly.tolist()], fill=255)
    return (np.asarray(img, np.float32) / 255.0 >= 0.5).astype(np.float32)[..., None]


def training_mask(
    h: int,
    w: int,
    bbox: tuple[float, float, float, float],
    rng: np.random.Generator,
    arbitrary_mask_percent: float = 0.5,
) -> np.ndarray:
    """bbox mask or (with prob arbitrary_mask_percent) a Bézier blob."""
    if rng.uniform() < arbitrary_mask_percent:
        return arbitrary_blob_mask(h, w, bbox, rng)
    return bbox_mask(h, w, bbox)


# -- geometry-first variants (crop-first fast path) --------------------------
# The full-resolution rasterize->crop->resize pipeline costs ~2 full-image
# float passes per sample. These variants defer rasterization: generate the
# mask GEOMETRY in image coordinates, then draw it once directly in the
# output (cropped+resized) frame.

MaskGeometry = tuple  # ("bbox", (x1, y1, x2, y2)) | ("poly", (N, 2) ndarray)


def mask_geometry(
    h: int,
    w: int,
    bbox: tuple[float, float, float, float],
    rng: np.random.Generator,
    arbitrary_mask_percent: float = 0.5,
) -> MaskGeometry:
    """training_mask's decision + geometry, without rasterizing.

    Consumes the same rng draws as training_mask for the same outcome."""
    if rng.uniform() < arbitrary_mask_percent:
        return ("poly", blob_polygon(h, w, bbox, rng))
    return ("bbox", bbox)


def geometry_bbox(geom: MaskGeometry) -> tuple[float, float, float, float]:
    """Tight (x1, y1, x2, y2) of the geometry (polygon vertex hull — the
    filled region's bbox equals the closed contour's vertex bbox)."""
    kind, data = geom
    if kind == "bbox":
        return tuple(float(v) for v in data)
    poly = data
    return (float(poly[:, 0].min()), float(poly[:, 1].min()),
            float(poly[:, 0].max()), float(poly[:, 1].max()))


def rasterize_geometry(
    geom: MaskGeometry,
    out_h: int,
    out_w: int,
    left: float = 0.0,
    top: float = 0.0,
    scale: float = 1.0,
) -> np.ndarray:
    """Draw the geometry into an (out_h, out_w) uint8 canvas (255 = edit),
    mapping image coords p -> (p - (left, top)) * scale. With left=top=0,
    scale=1 this matches the full-res rasterization of training_mask (bbox
    arm bit-exact; blob arm equal up to polygon-edge pixels)."""
    if geom[0] == "bbox":
        x1, y1, x2, y2 = geom[1]
        u1 = int(round((x1 - left) * scale))
        v1 = int(round((y1 - top) * scale))
        u2 = int(round((x2 - left) * scale))
        v2 = int(round((y2 - top) * scale))
        m = np.zeros((out_h, out_w), np.uint8)
        m[max(v1, 0):max(v2, 0), max(u1, 0):max(u2, 0)] = 255
        return m
    poly = geom[1].astype(np.float64).copy()
    poly[:, 0] = (poly[:, 0] - left) * scale
    poly[:, 1] = (poly[:, 1] - top) * scale
    img = Image.new("L", (out_w, out_h), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in poly.tolist()], fill=255)
    return np.asarray(img)


def mask_bbox(mask: np.ndarray) -> tuple[int, int, int, int] | None:
    """Tight (x1, y1, x2, y2) around nonzero mask pixels; None if empty.
    (Counterpart of callback_fid.py:23-34 / clip_score bbox extraction.)"""
    m = mask[..., 0] if mask.ndim == 3 else mask
    ys, xs = np.nonzero(m > 0.5)
    if len(ys) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def crop_square_around_mask(
    image: np.ndarray,
    source: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    pad_min: float = 0.10,
    pad_max: float = 0.40,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random square crop covering the masked area with 10-40% padding
    (spec: the fork's crop_square_from_mask, open-images.py:121-141).
    All arrays HWC."""
    bb = mask_bbox(mask)
    if bb is None:
        return image, source, mask
    x1, y1, x2, y2 = bb
    side = int(max(y2 - y1, x2 - x1) * (1 + rng.uniform(pad_min, pad_max)))
    h, w = image.shape[:2]
    side = min(side, h, w)
    cy, cx = (y1 + y2) // 2, (x1 + x2) // 2
    top = max(min(cy - side // 2, h - side), 0)
    left = max(min(cx - side // 2, w - side), 0)
    sl = (slice(top, top + side), slice(left, left + side))
    return image[sl], source[sl], mask[sl]
