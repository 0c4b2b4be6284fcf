"""Natural-statistics synthetic content (seeded numpy).

Frames with photographic statistics: a piecewise-smooth base with a ~1/f^2
power spectrum, segmented regions with sharp boundaries at many
orientations, oriented textures, thin strokes and sensor noise, and chroma
that follows the luma segmentation. Flat regions keep large CUs, boundaries
force deep splits, textures sit in between, so the content exercises every
QT and MTT depth the Down-Up-CNN predicts.

A copy of ``natural_sequence`` and the helpers it calls from
``pmp_vvc_tpu/data/synthcontent.py``: the port imports nothing from the JAX
package. The same seed gives the same frames in both packages.
"""
from __future__ import annotations

import numpy as np


def _fractal_noise(rng, h, w, alpha):
    """Real 1/f^alpha spectral-shaped noise, unit std."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.hypot(fy, fx)
    f[0, 0] = 1.0
    spec = (rng.randn(h, w // 2 + 1) + 1j * rng.randn(h, w // 2 + 1)) \
        / f ** alpha
    spec[0, 0] = 0.0
    x = np.fft.irfft2(spec, s=(h, w))
    s = x.std()
    return x / (s if s > 1e-9 else 1.0)


def _region_masks(rng, h, w, n):
    """Antialiased masks of rotated super-ellipses + half planes —
    piecewise segmentation with boundaries at many orientations."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    masks = []
    for _ in range(n):
        kind = rng.randint(3)
        soft = rng.uniform(0.6, 2.5)       # edge transition width (px)
        ang = rng.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        u = (xx - cx) * ca + (yy - cy) * sa
        v = -(xx - cx) * sa + (yy - cy) * ca
        if kind == 0:                       # half plane
            d = u
        elif kind == 1:                     # rotated super-ellipse
            ry_, rx_ = rng.uniform(h / 16, h / 2), rng.uniform(w / 16, w / 2)
            p = rng.uniform(1.5, 4.0)
            d = ((np.abs(u / rx_) ** p + np.abs(v / ry_) ** p)
                 ** (1 / p) - 1.0) * min(rx_, ry_)
        else:                               # wavy band (curved boundary)
            amp = rng.uniform(4, h / 6)
            per = rng.uniform(w / 6, w)
            d = v - amp * np.sin(2 * np.pi * u / per) \
                - rng.uniform(-h / 4, h / 4)
        masks.append(1.0 / (1.0 + np.exp(np.clip(-d / soft, -30, 30))))
    return masks


def _texture(rng, h, w):
    """One texture layer: oriented grating, fractal field, or flat."""
    kind = rng.randint(4)
    if kind == 0:                           # oriented grating
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        ang = rng.uniform(0, np.pi)
        freq = 2 * np.pi / rng.uniform(3.0, 48.0)
        phase = rng.uniform(0, 2 * np.pi)
        t = np.sin((xx * np.cos(ang) + yy * np.sin(ang)) * freq + phase)
        if rng.rand() < 0.4:                # square-ish wave (hard bars)
            t = np.tanh(t * rng.uniform(2, 8))
        return t * rng.uniform(4, 30)
    if kind == 1:                           # fractal texture
        return _fractal_noise(rng, h, w, rng.uniform(0.6, 1.4)) \
            * rng.uniform(4, 25)
    if kind == 2:                           # fine white-ish noise
        return rng.randn(h, w) * rng.uniform(2, 10)
    return np.zeros((h, w))                 # flat


def natural_frame(w, h, seed, bit_depth=10):
    """One (y, u, v) 4:2:0 frame, int32 at ``bit_depth``; y is (h, w),
    chroma half-res.  Layered scene: smooth base + segmented regions
    with per-region luma offsets and textures + thin high-contrast
    strokes + sensor noise; chroma tracks the segmentation."""
    rng = np.random.RandomState(seed)
    # smooth base (illumination): low-order gradient + large blobs
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (rng.uniform(60, 190)
            + rng.uniform(-40, 40) * (xx / w - 0.5)
            + rng.uniform(-40, 40) * (yy / h - 0.5)
            + _fractal_noise(rng, h, w, rng.uniform(1.8, 2.6))
            * rng.uniform(2, 45))
    n_regions = rng.randint(4, 14)
    masks = _region_masks(rng, h, w, n_regions)
    luma = base
    cu = np.full((h, w), rng.uniform(-25, 25), np.float32)
    cv = np.full((h, w), rng.uniform(-25, 25), np.float32)
    for m in masks:
        off = rng.uniform(-70, 70)
        luma = luma * (1 - m) + m * (luma + off + _texture(rng, h, w))
        cu = cu * (1 - m) + m * rng.uniform(-45, 45)
        cv = cv * (1 - m) + m * rng.uniform(-45, 45)
    # a few thin strokes (text/wire-like high-frequency content)
    for _ in range(rng.randint(0, 6)):
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        ang = rng.uniform(0, np.pi)
        ln = rng.uniform(min(w, h) / 8, min(w, h))
        thick = rng.uniform(0.7, 2.5)
        u_ = (xx - x0) * np.cos(ang) + (yy - y0) * np.sin(ang)
        v_ = -(xx - x0) * np.sin(ang) + (yy - y0) * np.cos(ang)
        stroke = (np.abs(v_) < thick) & (u_ > 0) & (u_ < ln)
        luma = np.where(stroke, luma + rng.choice([-1, 1])
                        * rng.uniform(40, 110), luma)
    luma = luma + rng.randn(h, w) * rng.uniform(0.5, 3.0)   # sensor noise
    # chroma: segmentation colors + soft texture, mildly noisy
    cu = cu + _fractal_noise(rng, h, w, 2.0) * rng.uniform(2, 10)
    cv = cv + _fractal_noise(rng, h, w, 2.0) * rng.uniform(2, 10)
    # video (studio) range, like camera/CTC content
    y8 = np.clip(luma, 16, 235)
    u8 = np.clip(128 + cu, 16, 240).reshape(h // 2, 2, w // 2, 2) \
        .mean(axis=(1, 3))
    v8 = np.clip(128 + cv, 16, 240).reshape(h // 2, 2, w // 2, 2) \
        .mean(axis=(1, 3))
    sh = bit_depth - 8
    return (np.round(y8).astype(np.int32) << sh,
            np.round(u8).astype(np.int32) << sh,
            np.round(v8).astype(np.int32) << sh)


def natural_sequence(w, h, n, seed0=0, bit_depth=10):
    return [natural_frame(w, h, seed0 + i, bit_depth) for i in range(n)]
