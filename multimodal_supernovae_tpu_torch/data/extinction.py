"""Milky-Way dust extinction (CCM89) and the flat-LCDM distance modulus, in
numpy (port of multimodal_supernovae_tpu/data/extinction.py).

The reference corrects observed magnitudes for galactic extinction with the
Cardelli, Clayton & Mathis (1989) law through the third-party ``extinction``
package (src/dataloader.py:504-509, :1000-1007); here the closed-form CCM89
polynomials are evaluated directly.

Formulae from Cardelli, Clayton & Mathis (1989), ApJ 345, 245:
``A(lambda)/A_V = a(x) + b(x)/R_V`` with ``x = 1e4 / lambda_angstrom``
(inverse microns), in four regimes: infrared (0.3 <= x < 1.1), optical/NIR
(1.1 <= x < 3.3), UV (3.3 <= x <= 8.0) and far-UV (8.0 < x <= 10.0).

Both ZTF effective wavelengths used by the reference (g: 1196.25 A, i.e.
x ~= 8.36 far-UV branch; R: 6366.38 A, x ~= 1.57 optical branch) are
covered.
"""

from __future__ import annotations

import numpy as np

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _ccm89_ab(x):
    """Return (a, b) CCM89 coefficients for x in inverse microns.

    Elementwise only: the branch select is a where-chain.
    """
    xp = np
    x = xp.asarray(x, dtype=np.float64) if isinstance(x, np.ndarray) or np.isscalar(x) else x

    # --- infrared: 0.3 <= x < 1.1
    a_ir = 0.574 * x ** 1.61
    b_ir = -0.527 * x ** 1.61

    # --- optical/NIR: 1.1 <= x < 3.3
    y = x - 1.82
    a_opt = (
        1.0
        + 0.17699 * y
        - 0.50447 * y ** 2
        - 0.02427 * y ** 3
        + 0.72085 * y ** 4
        + 0.01979 * y ** 5
        - 0.77530 * y ** 6
        + 0.32999 * y ** 7
    )
    b_opt = (
        1.41338 * y
        + 2.28305 * y ** 2
        + 1.07233 * y ** 3
        - 5.38434 * y ** 4
        - 0.62251 * y ** 5
        + 5.30260 * y ** 6
        - 2.09002 * y ** 7
    )

    # --- UV: 3.3 <= x <= 8.0 (with the x >= 5.9 correction terms)
    z = x - 5.9
    fa = (-0.04473 * z ** 2 - 0.009779 * z ** 3) * (x >= 5.9)
    fb = (0.2130 * z ** 2 + 0.1207 * z ** 3) * (x >= 5.9)
    a_uv = 1.752 - 0.316 * x - 0.104 / ((x - 4.67) ** 2 + 0.341) + fa
    b_uv = -3.090 + 1.825 * x + 1.206 / ((x - 4.62) ** 2 + 0.263) + fb

    # --- far-UV: 8.0 < x <= 10.0
    w = x - 8.0
    a_fuv = -1.073 - 0.628 * w + 0.137 * w ** 2 - 0.070 * w ** 3
    b_fuv = 13.670 + 4.257 * w - 0.420 * w ** 2 + 0.374 * w ** 3

    a = xp.where(x < 1.1, a_ir, xp.where(x < 3.3, a_opt, xp.where(x <= 8.0, a_uv, a_fuv)))
    b = xp.where(x < 1.1, b_ir, xp.where(x < 3.3, b_opt, xp.where(x <= 8.0, b_uv, b_fuv)))
    return a, b


def ccm89(wave_angstrom, a_v: float, r_v: float = 3.1):
    """CCM89 extinction A(lambda) in magnitudes.

    Args:
      wave_angstrom: wavelength(s) in Angstroms (scalar or array).
      a_v: V-band extinction in magnitudes (= E(B-V) * r_v).
      r_v: ratio of total to selective extinction (3.1 for the diffuse MW ISM).

    Returns:
      A(lambda) with the same shape as ``wave_angstrom``.

    Matches the semantics of ``extinction.ccm89(wave, a_v, r_v)`` used by the
    reference at src/dataloader.py:508.
    """
    wave = np.asarray(wave_angstrom, dtype=np.float64)
    x = 1e4 / wave
    a, b = _ccm89_ab(x)
    return a_v * (a + b / r_v)


# Effective wavelengths (Angstrom) of the ZTF g and R filters as used by the
# reference (src/dataloader.py:475, :948). NOTE: the g value is the
# reference's own constant (kept verbatim for output parity); the SVO filter
# service lists ZTF g closer to 4746.48 A.
ZTF_WAVE_EFF = {"g": 1196.25, "R": 6366.38}

# Precomputed per-unit-A_V extinction for the two ZTF bands at R_V = 3.1.
CCM89_UNIT_AV_RV31 = {
    band: float(ccm89(np.array([wave]), 1.0, 3.1)[0])
    for band, wave in ZTF_WAVE_EFF.items()
}


def flat_lcdm_distmod(z, h0: float = 67.74, om0: float = 0.3089, n_grid: int = 2048):
    """Distance modulus mu(z) = 5 log10(d_L / 10 pc) for a flat LCDM cosmology.

    Replaces the reference's ``astropy.cosmology.Planck15.distmod`` dependency
    (src/dataloader.py:16, :566) with a trapezoid-integrated comoving
    distance. Planck15 parameter values (H0=67.74, Om0=0.3089); radiation and
    massive-neutrino terms are neglected (relative error < 1e-3 for z < 10,
    far below photometric uncertainty).

    Args:
      z: redshift(s), scalar or array, must be > 0 for a finite result.
    Returns:
      distance modulus in magnitudes, same shape as ``z``.
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    c_km_s = 299792.458
    hubble_dist_mpc = c_km_s / h0

    def e_inv(zz):
        return 1.0 / np.sqrt(om0 * (1.0 + zz) ** 3 + (1.0 - om0))

    # Comoving distance via trapezoid rule on a shared grid per element.
    zgrid = np.linspace(0.0, 1.0, n_grid)[None, :] * z[:, None]  # (N, n_grid)
    integrand = e_inv(zgrid)
    dc = hubble_dist_mpc * _trapezoid(integrand, zgrid, axis=1)
    dl_mpc = (1.0 + z) * dc
    mu = 5.0 * np.log10(np.maximum(dl_mpc, 1e-30) * 1e5)  # 10 pc = 1e-5 Mpc
    return mu if mu.shape != (1,) else mu[0]
