"""On-device data augmentation (port of the light-curve and spectral part of
multimodal_supernovae_tpu/data/augment.py).

Sequence noise is ``x + N(0, 1) * err * level``, the standard-normal draw
coming from an explicit ``torch.Generator`` on the batch's device, or
handed in as a tensor (tests give both stacks the same numbers that way).
Image noise and rotation wait for the image tower (ROADMAP.md queue 1,
item 11) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

_NO_IMAGES = ("image augmentation is not ported yet (ROADMAP.md queue 1, "
              "item 11: image and meta towers)")


def noise_from_error(x: torch.Tensor, err: torch.Tensor, level,
                     generator: Optional[torch.Generator] = None,
                     normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian noise scaled by the per-point measurement error. ``normal``
    is the standard-normal draw; without it one is drawn from
    ``generator``."""
    if normal is None:
        if generator is None:
            raise ValueError("noise_from_error needs a generator or a normal draw")
        normal = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                             device=x.device)
    return x + normal * err * level


def augment_batch(
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    noise_level_mag: float = 0.0,
    normals: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Magnitude/flux noise on ``x_lc`` and ``x_sp`` at ``noise_level_mag``
    (a zero level leaves the batch as it is). ``normals`` may give the
    standard-normal draw per field (``x_lc``, ``x_sp``); the rest are drawn
    from ``generator``, light curve first. A batch with images raises."""
    if "x_img" in batch:
        raise NotImplementedError(_NO_IMAGES)
    out = dict(batch)
    if not noise_level_mag:
        return out
    normals = normals or {}
    for x, err in (("x_lc", "err_lc"), ("x_sp", "err_sp")):
        if x in batch:
            out[x] = noise_from_error(batch[x], batch[err], noise_level_mag,
                                      generator, normals.get(x))
    return out
