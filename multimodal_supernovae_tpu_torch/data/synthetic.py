"""Synthetic supernova-like light curves, spectra and host-galaxy images
(port of multimodal_supernovae_tpu/data/synthetic.py).

Draws exactly the numbers the JAX package's ``make_synthetic_dataset`` draws
for the same seed, sizes and modalities: ``make_synthetic_arrays`` returns
them as a plain dict of numpy arrays, ``make_synthetic_dataset`` as an
``ArrayDataset`` with the JAX generator's filenames. No jax. Samples share a
latent vector across modalities, so light curves, spectra, images, redshift
and class of one sample are related. Images are drawn after the spectra
from the same generator, as the JAX generator draws them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .batching import ArrayDataset

SUPPORTED_MODALITIES = ("host_galaxy", "lightcurve", "spectral", "meta")


def make_synthetic_arrays(
    n: int = 64,
    n_max_lc: int = 20,
    nband: int = 2,
    n_max_sp: int = 32,
    image_size: int = 20,
    n_classes: int = 5,
    modalities: Sequence[str] = ("lightcurve", "spectral"),
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Fields ``redshift``, ``label`` (the meta modality's inputs, always
    present) and, per modality, ``x/t/mask/err`` (``_lc`` with (n, nband *
    n_max_lc) band-blocked rows, ``_sp`` with (n, n_max_sp) rows, some with
    ragged masked tails) and ``x_img`` ((n, image_size, image_size, 3) NHWC
    in [0, 1])."""
    unknown = sorted(set(modalities) - set(SUPPORTED_MODALITIES))
    if unknown:
        raise ValueError(f"unknown modalities {unknown}")
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, 4)).astype(np.float32)
    label = rng.integers(0, n_classes, size=n).astype(np.int32)
    redshift = (0.01 + 0.2 * rng.random(n) * (1 + 0.1 * latent[:, 0])).astype(
        np.float32)

    arrays = {"redshift": redshift, "label": label}
    t_lc_total = n_max_lc * nband

    if "lightcurve" in modalities:
        x = np.zeros((n, t_lc_total), np.float32)
        t = np.zeros((n, t_lc_total), np.float32)
        m = np.zeros((n, t_lc_total), bool)
        e = np.zeros((n, t_lc_total), np.float32)
        for i in range(n):
            for b in range(nband):
                n_obs = rng.integers(n_max_lc // 2, n_max_lc + 1)
                tt = np.sort(rng.random(n_obs).astype(np.float32)) * 100
                tt -= tt.min()
                # latent-driven rise/decline light curve + class offset
                peak = 10 + latent[i, 0] + 0.5 * label[i] + 0.3 * b
                width = 20 + 5 * abs(latent[i, 1])
                vals = peak * np.exp(-((tt - 30) ** 2) / (2 * width**2))
                sl = slice(b * n_max_lc, b * n_max_lc + n_obs)
                x[i, sl] = vals
                t[i, sl] = tt
                m[i, sl] = True
                e[i, sl] = 0.05 * np.abs(rng.normal(size=n_obs))
        arrays.update(x_lc=x, t_lc=t, mask_lc=m, err_lc=e)

    if "spectral" in modalities:
        wl = np.linspace(3000, 9000, n_max_sp, dtype=np.float32)
        x = np.zeros((n, n_max_sp), np.float32)
        t = np.tile(wl, (n, 1))
        m = np.ones((n, n_max_sp), bool)
        e = np.zeros((n, n_max_sp), np.float32)
        for i in range(n):
            center = 5000 + 500 * latent[i, 2] + 100 * label[i]
            depth = 0.5 + 0.2 * latent[i, 3]
            cont = 1.0 + 0.1 * latent[i, 0]
            x[i] = cont - depth * np.exp(-((wl - center) ** 2) / (2 * 300**2))
            e[i] = 0.02 * np.abs(rng.normal(size=n_max_sp))
            # ragged tails on some spectra
            if rng.random() < 0.3:
                cut = rng.integers(n_max_sp // 2, n_max_sp)
                m[i, cut:] = False
                x[i, cut:] = 0.0
                t[i, cut:] = 0.0
        arrays.update(x_sp=x, t_sp=t, mask_sp=m, err_sp=e)

    if "host_galaxy" in modalities:
        imgs = np.zeros((n, image_size, image_size, 3), np.float32)
        yy, xx = np.mgrid[0:image_size, 0:image_size]
        for i in range(n):
            cx = image_size / 2 + latent[i, 0]
            cy = image_size / 2 + latent[i, 1]
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            base = np.exp(-r2 / (2 * (2 + abs(latent[i, 2])) ** 2))
            for c in range(3):
                imgs[i, :, :, c] = np.clip(
                    base * (0.5 + 0.2 * latent[i, 3] + 0.1 * c)
                    + 0.05 * rng.random((image_size, image_size)), 0, 1)
        arrays["x_img"] = imgs

    return arrays


def make_synthetic_dataset(n: int = 64, **kw) -> ArrayDataset:
    """``make_synthetic_arrays`` as an ``ArrayDataset`` named ZTFSYN000000..."""
    return ArrayDataset(make_synthetic_arrays(n=n, **kw),
                        [f"ZTFSYN{i:06d}" for i in range(n)])
