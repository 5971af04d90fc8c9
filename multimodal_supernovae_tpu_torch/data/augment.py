"""On-device data augmentation (port of the augmentation half of
multimodal_supernovae_tpu/data/augment.py).

  * sequence noise: ``x + N(0, 1) * err * level`` on ``x_lc`` and ``x_sp``;
  * image noise: uniform in ``+- level * std(batch)``, the standard
    deviation being the biased one over the WHOLE batch, as in the JAX
    package and the reference;
  * image rotation: each NHWC image by its own random multiple of 90
    degrees (square images);
  * the masked-pretraining masks: a uniform random subset of each sample's
    valid positions (``random_subset_mask``) or one contiguous span per
    band (``contiguous_span_mask``).

Every draw comes from an explicit ``torch.Generator`` on the batch's device
or is handed in as a tensor (tests give both stacks the same numbers that
way).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..utils.draws import DrawSource, RankRows


def _need(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} needs a generator or a handed-in draw")
    if isinstance(generator, DrawSource):
        generator.refuse(what)
    return generator


def _draw(generator, what: str, fn, shape, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=..., **kwargs)``, or this rank's rows of the
    global draw under data parallelism (``utils.draws.RankRows``)."""
    if isinstance(generator, RankRows):
        return generator.draw(fn, shape, **kwargs)
    return fn(shape, generator=_need(generator, what), **kwargs)


def _randint4(shape, **kwargs) -> torch.Tensor:
    return torch.randint(0, 4, shape, **kwargs)


def batch_std(img: torch.Tensor, generator=None) -> torch.Tensor:
    """The biased standard deviation of the whole batch; under data
    parallelism (a ``RankRows`` generator) the GLOBAL batch's, from the
    all-reduced sum and sum of squared deviations."""
    if not isinstance(generator, RankRows) or generator.mesh.group is None:
        return torch.std(img, correction=0)
    mesh = generator.mesh
    n = img.numel() * mesh.size
    mean = mesh.all_reduce(img.sum()) / n
    return torch.sqrt(mesh.all_reduce(((img - mean) ** 2).sum()) / n)


def noise_from_error(x: torch.Tensor, err: torch.Tensor, level,
                     generator: Optional[torch.Generator] = None,
                     normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian noise scaled by the per-point measurement error. ``normal``
    is the standard-normal draw; without it one is drawn from
    ``generator``."""
    if normal is None:
        normal = _draw(generator, "noise_from_error", torch.randn, x.shape,
                       dtype=x.dtype, device=x.device)
    return x + normal * err * level


def image_uniform_noise(img: torch.Tensor, level,
                        generator: Optional[torch.Generator] = None,
                        uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``img + u * level * std(img)`` with u uniform in [-1, 1) per element
    and the biased standard deviation of the whole batch (``jnp.std``).
    ``uniform`` is u; without it one is drawn from ``generator``."""
    noise_range = level * batch_std(img, generator)
    if uniform is None:
        uniform = _draw(generator, "image noise", torch.rand, img.shape,
                        dtype=img.dtype, device=img.device) * 2.0 - 1.0
    return img + uniform * noise_range


def random_rot90(img: torch.Tensor, generator: Optional[torch.Generator] = None,
                 k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate each NHWC image by ``k[i]`` quarter turns (``jnp.rot90(im, k,
    axes=(0, 1))`` on one HWC image). ``k`` (B,) in {0..3}; without it one
    is drawn from ``generator``. H == W (host cutouts are square), so the
    four rotations share a shape and each image takes its own from a stack
    without leaving the device."""
    b = img.shape[0]
    if k is None:
        k = _draw(generator, "image rotation", _randint4, (b,), device=img.device)
    turns = torch.stack([torch.rot90(img, i, dims=(1, 2)) for i in range(4)])
    return turns[k.to(img.device).long(), torch.arange(b, device=img.device)]


def augment_batch(
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    noise_level_mag: float = 0.0,
    normals: Optional[Mapping[str, torch.Tensor]] = None,
    noise_level_img: float = 0.0,
    rotate_images: bool = True,
    img_uniform: Optional[torch.Tensor] = None,
    img_k: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """The JAX package's recipe on whatever modalities are present: image
    noise at ``noise_level_img`` then rotation (``rotate_images``), and
    magnitude/flux noise on ``x_lc`` and ``x_sp`` at ``noise_level_mag``. A
    zero level leaves its fields as they are.

    ``rotate_images`` defaults to True and rotates even at noise level 0:
    the reference's loader rotates images whenever they are present, and
    the JAX package keeps that (pass False for deterministic batches).

    ``normals`` may give the standard-normal draw per field (``x_lc``,
    ``x_sp``), ``img_uniform`` the image noise's u and ``img_k`` the
    quarter turns; the rest are drawn from ``generator`` in the order image
    noise, rotation, light curve, spectrum."""
    out = dict(batch)
    if "x_img" in batch:
        img = batch["x_img"]
        if noise_level_img:
            img = image_uniform_noise(img, noise_level_img, generator, img_uniform)
        if rotate_images:
            img = random_rot90(img, generator, img_k)
        out["x_img"] = img
    if not noise_level_mag:
        return out
    normals = normals or {}
    for x, err in (("x_lc", "err_lc"), ("x_sp", "err_sp")):
        if x in batch:
            out[x] = noise_from_error(batch[x], batch[err], noise_level_mag,
                                      generator, normals.get(x))
    return out


# -- masked-pretraining masks (the JAX package's data/augment.py:98-151) ------


def random_subset_mask(padding_mask: torch.Tensor, f_mask: float,
                       generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hide ``int(n_obs * f_mask)`` of each sample's valid positions, chosen
    uniformly without replacement: the positions of the smallest uniforms,
    padding ranked last (+inf). ``uniform`` (B, T) is the draw; without it
    one is drawn from ``generator``. Returns (mask_keep, mask_pred): the
    valid positions the model sees and the ones it predicts."""
    pm = padding_mask.bool()
    n_obs = pm.sum(dim=1)
    n_mask = (n_obs.float() * f_mask).int()  # float32, truncated, as JAX's
    if uniform is None:
        uniform = _draw(generator, "random_subset_mask", torch.rand, pm.shape,
                        device=pm.device)
    u = torch.where(pm, uniform, torch.full_like(uniform, float("inf")))
    # the rank of each entry: JAX's argsort of argsort, both stable
    ranks = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    pred = (ranks < n_mask[:, None]) & pm
    return pm & ~pred, pred


def contiguous_span_mask(padding_mask: torch.Tensor, nband: int, f_mask: float,
                         generator: Optional[torch.Generator] = None,
                         uniform: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hide one contiguous span per band of the band-blocked layout, whose
    valid observations are a prefix of each band block: the span holds
    ``int(n_obs * f_mask)`` observations and starts at ``floor(u * (n_obs -
    span + 1))``, both in float32 as in the JAX package. ``uniform``
    (B, nband) is u; without it one is drawn from ``generator``. Returns
    (mask_keep, mask_pred)."""
    pm = padding_mask.bool()
    b, t = pm.shape
    bands = pm.reshape(b, nband, t // nband)
    n_obs = bands.sum(dim=2)
    span = (n_obs.float() * f_mask).int()
    if uniform is None:
        uniform = _draw(generator, "contiguous_span_mask", torch.rand, (b, nband),
                        device=pm.device)
    start = torch.floor(uniform * (n_obs - span + 1).float()).int()
    pos = torch.arange(t // nband, device=pm.device)[None, None, :]
    in_span = (pos >= start[..., None]) & (pos < (start + span)[..., None])
    pred = (in_span & bands).reshape(b, t)
    return pm & ~pred, pred
