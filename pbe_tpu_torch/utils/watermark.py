"""Invisible DWT-DCT watermark (the reference's `dwtDct` channel): the
port's own copy of ``pbe_tpu/utils/watermark.py``.

The reference stamps every saved edit with the invisible-watermark
package's `dwtDct` method carrying the bytes "Paint-by-Example"
(scripts/inference.py:8,25-27,78-83,377-384; that package wraps OpenCV +
pywt, neither needed here). This is a from-scratch numpy/scipy
reimplementation of the same watermark family:

  1. RGB -> BT.601 YUV; embed in the chroma (U, V) planes.
  2. One-level Haar DWT; only the LL subband is touched (robustness to
     mild filtering, invisibility).
  3. LL is tiled into 4x4 blocks; each block gets one payload bit (cycled)
     via quantization index modulation of a mid-frequency DCT-II
     coefficient: coeff -> (floor(coeff/scale) + 0.25 + 0.5*bit) * scale.
  4. Inverse DCT / DWT / color transform, clip to [0, 255].

Decoding re-derives the bit from each block and majority-votes across all
blocks carrying the same payload position. Round-trip exactness and >40 dB
PSNR are asserted in tests/test_watermark.py (the JAX package's copy);
tests/test_torch_batch.py holds this copy to it byte for byte.
"""
from __future__ import annotations

import numpy as np
from scipy.fftpack import dctn, idctn

_SCALE = 36.0  # QIM step (the reference package's default for dwtDct)
_COEFF = (1, 2)  # mid-frequency DCT position carrying the bit

_RGB2YUV = np.array([
    [0.299, 0.587, 0.114],
    [-0.14713, -0.28886, 0.436],
    [0.615, -0.51499, -0.10001],
], np.float64)
_YUV2RGB = np.linalg.inv(_RGB2YUV)


def _haar_dwt2(x: np.ndarray):
    a = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) / 2.0
    h = (x[0::2, 0::2] - x[0::2, 1::2] + x[1::2, 0::2] - x[1::2, 1::2]) / 2.0
    v = (x[0::2, 0::2] + x[0::2, 1::2] - x[1::2, 0::2] - x[1::2, 1::2]) / 2.0
    d = (x[0::2, 0::2] - x[0::2, 1::2] - x[1::2, 0::2] + x[1::2, 1::2]) / 2.0
    return a, (h, v, d)


def _haar_idwt2(a, hvd):
    h, v, d = hvd
    out = np.empty((a.shape[0] * 2, a.shape[1] * 2), a.dtype)
    out[0::2, 0::2] = (a + h + v + d) / 2.0
    out[0::2, 1::2] = (a - h + v - d) / 2.0
    out[1::2, 0::2] = (a + h - v - d) / 2.0
    out[1::2, 1::2] = (a - h - v + d) / 2.0
    return out


def _bits(payload: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload, np.uint8))


def _blocks(ll: np.ndarray) -> tuple[int, int]:
    return ll.shape[0] // 4, ll.shape[1] // 4


def _embed_plane(ll: np.ndarray, bits: np.ndarray) -> np.ndarray:
    nby, nbx = _blocks(ll)
    out = ll.copy()
    i, j = _COEFF
    for by in range(nby):
        for bx in range(nbx):
            bit = bits[(by * nbx + bx) % len(bits)]
            blk = dctn(ll[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4], norm="ortho")
            blk[i, j] = (np.floor(blk[i, j] / _SCALE) + 0.25 + 0.5 * bit) * _SCALE
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = idctn(blk, norm="ortho")
    return out


def _extract_plane(ll: np.ndarray, nbits: int) -> np.ndarray:
    """Per-payload-position vote accumulators (sum of decoded fractions)."""
    nby, nbx = _blocks(ll)
    votes = np.zeros(nbits)
    counts = np.zeros(nbits)
    i, j = _COEFF
    for by in range(nby):
        for bx in range(nbx):
            pos = (by * nbx + bx) % nbits
            blk = dctn(ll[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4], norm="ortho")
            frac = blk[i, j] / _SCALE - np.floor(blk[i, j] / _SCALE)
            votes[pos] += 1.0 if frac > 0.5 else 0.0
            counts[pos] += 1.0
    return votes / np.maximum(counts, 1.0)


def embed_watermark(img: np.ndarray, payload: bytes = b"Paint-by-Example") -> np.ndarray:
    """img: (H, W, 3) uint8 RGB, H and W divisible by 8 -> watermarked uint8."""
    assert img.ndim == 3 and img.shape[2] == 3
    h, w = img.shape[:2]
    assert h % 8 == 0 and w % 8 == 0, "H, W must be divisible by 8"
    bits = _bits(payload)
    yuv = img.astype(np.float64) @ _RGB2YUV.T
    for ch in (1, 2):
        a, hvd = _haar_dwt2(yuv[:, :, ch])
        yuv[:, :, ch] = _haar_idwt2(_embed_plane(a, bits), hvd)
    rgb = yuv @ _YUV2RGB.T
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def extract_watermark(img: np.ndarray, nbytes: int = 16) -> bytes:
    """Recover an nbytes payload from a watermarked (H, W, 3) uint8 RGB."""
    nbits = nbytes * 8
    yuv = img.astype(np.float64) @ _RGB2YUV.T
    acc = np.zeros(nbits)
    for ch in (1, 2):
        a, _ = _haar_dwt2(yuv[:, :, ch])
        acc += _extract_plane(a, nbits)
    return np.packbits((acc / 2.0 > 0.5).astype(np.uint8)).tobytes()
