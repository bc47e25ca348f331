"""Training losses: L1 + D-SSIM (the INRIA photometric objective).

The reference has no training at all (SURVEY.md intro); this implements the
standard 3DGS objective L = (1-λ)·L1 + λ·(1 - SSIM)/2 with λ = 0.2.

SSIM uses an 11×11 Gaussian window (σ = 1.5) realized as a separable
depthwise convolution — two `lax.conv_general_dilated` calls at
precision=HIGHEST (no TF32 on a GPU).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np


def l1_loss(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.abs(pred - target))


def psnr(pred, target) -> float:
    """Peak signal-to-noise ratio in dB for [0,1] images."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-10)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: jnp.ndarray, window: jnp.ndarray) -> jnp.ndarray:
    """Separable Gaussian blur on [H, W, C] with SAME padding."""
    c = img.shape[-1]
    x = img[None].transpose(0, 3, 1, 2)  # NCHW
    kh = jnp.asarray(window).reshape(1, 1, -1, 1)
    kw = jnp.asarray(window).reshape(1, 1, 1, -1)
    dn = ("NCHW", "OIHW", "NCHW")
    opts = dict(window_strides=(1, 1), padding="SAME",
                dimension_numbers=dn, feature_group_count=c,
                precision=jax.lax.Precision.HIGHEST)
    x = jax.lax.conv_general_dilated(x, jnp.tile(kh, (c, 1, 1, 1)), **opts)
    x = jax.lax.conv_general_dilated(x, jnp.tile(kw, (c, 1, 1, 1)), **opts)
    return x.transpose(0, 2, 3, 1)[0]


def ssim(
    a: jnp.ndarray,
    b: jnp.ndarray,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> jnp.ndarray:
    """Mean SSIM over an [H, W, C] image pair in [0, 1]."""
    w = _gaussian_window(window_size, sigma)
    mu_a = _blur(a, w)
    mu_b = _blur(b, w)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = _blur(a * a, w) - mu_aa
    sig_b = _blur(b * b, w) - mu_bb
    sig_ab = _blur(a * b, w) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2)
    )
    return jnp.mean(s)


def photometric_loss(
    pred: jnp.ndarray, target: jnp.ndarray, lambda_dssim: float = 0.2
) -> jnp.ndarray:
    """INRIA objective: (1-λ)·L1 + λ·(1-SSIM)/2."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * 0.5 * (
        1.0 - ssim(pred, target)
    )
