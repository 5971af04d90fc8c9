"""Sweep configs: the W&B sweep-YAML schema of ``configs/*.yaml``, read
without PyYAML (port of multimodal_supernovae_tpu/config/config.py, the
reader, the grid and the builders).

A sweep file holds ``parameters.<name>.values`` lists (one per swept
hyperparameter), an un-swept ``extra_args`` block, and ``method``
(``grid`` or ``random``). ``expand_grid`` flattens it into per-run configs;
``build_clip_config`` and ``build_trainer_config`` map one run config and
the extra args to a ``CLIPConfig`` and a ``TrainerConfig``, with the JAX
package's key conventions and defaults. ``SweepScheduler`` gives the sweep
runner one suggest/observe protocol over the grid, random and ``bayes``
methods (``BayesSearch``: a local TPE over the value lists), and suggests
what the JAX package's suggests for the same observations.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .yaml_subset import load as load_yaml


@dataclasses.dataclass
class SweepConfig:
    parameters: Dict[str, List[Any]]
    extra_args: Dict[str, Any]
    method: str = "grid"
    metric: Optional[Dict[str, Any]] = None
    raw: Optional[Dict[str, Any]] = None

    @property
    def n_points(self) -> int:
        n = 1
        for v in self.parameters.values():
            n *= len(v)
        return n


def load_sweep(path: str) -> SweepConfig:
    raw = load_yaml(path)
    params = {}
    for k, spec in (raw.get("parameters") or {}).items():
        if isinstance(spec, dict) and "values" in spec:
            params[k] = list(spec["values"])
        elif isinstance(spec, dict) and "value" in spec:
            params[k] = [spec["value"]]
        else:
            params[k] = [spec]
    return SweepConfig(
        parameters=params,
        extra_args=raw.get("extra_args") or {},
        method=raw.get("method", "grid"),
        metric=raw.get("metric"),
        raw=raw,
    )


def expand_grid(sweep: SweepConfig) -> Iterator[Dict[str, Any]]:
    """Flattened per-run configs: ``method: grid`` walks the cartesian
    product in key order; ``method: random`` draws ``extra_args.nruns``
    (default 32) configs uniformly from each value list, seeded by
    ``extra_args.sweep_seed`` (default 0)."""
    keys = list(sweep.parameters)
    if sweep.method == "random":
        rng = np.random.default_rng(int(sweep.extra_args.get("sweep_seed", 0)))
        for _ in range(int(sweep.extra_args.get("nruns", 32))):
            yield {k: sweep.parameters[k][rng.integers(len(sweep.parameters[k]))]
                   for k in keys}
        return
    for combo in itertools.product(*(sweep.parameters[k] for k in keys)):
        yield dict(zip(keys, combo))


class BayesSearch:
    """W&B ``method: bayes`` equivalent over discrete value lists, local and
    dependency-free (the reference delegates to the W&B service,
    wandb_utils.py:7-42; no shipped config uses it, but the schema allows it).

    TPE-style categorical model: after ``n_startup`` random runs, observed
    configs are split at the ``gamma`` quantile of the objective into good
    and bad sets; each candidate is scored by the sum over parameters of
    ``log P(value | good) - log P(value | bad)`` with add-one smoothing, and
    the best-scoring unseen config is suggested next.

    Protocol: ``suggest() -> config | None`` (None = grid exhausted), then
    ``observe(config, value)`` with the run's objective value. Unobserved
    suggestions don't advance the model.
    """

    def __init__(self, sweep: SweepConfig, seed: int = 0, n_startup: int = 5,
                 gamma: float = 0.25, n_candidates: int = 256):
        self.keys = list(sweep.parameters)
        self.values = {k: list(sweep.parameters[k]) for k in self.keys}
        self.minimize = (
            (sweep.metric or {}).get("goal", "minimize") != "maximize"
        )
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = np.random.default_rng(
            int(sweep.extra_args.get("sweep_seed", seed))
        )
        self._obs: List[tuple] = []  # (key_tuple, value)
        self._seen = set()
        self._n_points = sweep.n_points

    def _key(self, cfg: Dict[str, Any]):
        return tuple(self.values[k].index(cfg[k]) for k in self.keys)

    def _cfg(self, key) -> Dict[str, Any]:
        return {k: self.values[k][i] for k, i in zip(self.keys, key)}

    def _random_unseen(self):
        for _ in range(10000):
            key = tuple(
                int(self._rng.integers(len(self.values[k]))) for k in self.keys
            )
            if key not in self._seen:
                return key
        # dense grids: fall back to scanning
        for key in itertools.product(*(range(len(self.values[k])) for k in self.keys)):
            if key not in self._seen:
                return key
        return None

    def suggest(self) -> Optional[Dict[str, Any]]:
        if len(self._seen) >= self._n_points:
            return None
        if len(self._obs) < self.n_startup:
            key = self._random_unseen()
        else:
            key = self._tpe_pick()
        if key is None:
            return None
        self._seen.add(key)
        return self._cfg(key)

    def observe(self, cfg: Dict[str, Any], value: float) -> None:
        self._seen.add(self._key(cfg))
        self._obs.append((self._key(cfg), float(value)))

    def _tpe_pick(self):
        obs = sorted(self._obs, key=lambda o: o[1], reverse=not self.minimize)
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good = [k for k, _ in obs[:n_good]]
        bad = [k for k, _ in obs[n_good:]] or good

        def dist(group):
            out = {}
            for j, k in enumerate(self.keys):
                counts = [1.0] * len(self.values[k])  # add-one smoothing
                for key in group:
                    counts[key[j]] += 1.0
                s = sum(counts)
                out[k] = [c / s for c in counts]
            return out

        pg, pb = dist(good), dist(bad)
        best_key, best_score = None, -float("inf")
        for _ in range(self.n_candidates):
            key = self._random_unseen()
            if key is None:
                break
            score = sum(
                math.log(pg[k][key[j]]) - math.log(pb[k][key[j]])
                for j, k in enumerate(self.keys)
            )
            if score > best_score:
                best_key, best_score = key, score
        return best_key


class SweepScheduler:
    """Uniform suggest/observe protocol over grid, random, and bayes
    methods; grid/random ignore observations."""

    def __init__(self, sweep: SweepConfig, max_runs: Optional[int] = None):
        self.sweep = sweep
        extra = sweep.extra_args
        if sweep.method in ("random", "bayes"):
            budget = max_runs or int(extra.get("nruns", 32))
        else:
            budget = sweep.n_points if max_runs is None else min(
                max_runs, sweep.n_points
            )
        self.n_runs = budget
        self._bayes = BayesSearch(sweep) if sweep.method == "bayes" else None
        self._iter = None if self._bayes else expand_grid(sweep)
        self._count = 0

    def suggest(self) -> Optional[Dict[str, Any]]:
        if self._count >= self.n_runs:
            return None
        self._count += 1
        if self._bayes:
            return self._bayes.suggest()
        return next(self._iter, None)

    def observe(self, cfg: Dict[str, Any], value: Optional[float]) -> None:
        if self._bayes and value is not None:
            self._bayes.observe(cfg, value)


def build_clip_config(run_cfg: Dict[str, Any], extra: Dict[str, Any], nband: int = 2):
    """Flattened run config + extra_args -> ``CLIPConfig``, field for field
    as the JAX package builds it (the reference's ``initialize_model`` key
    conventions, spectral keys falling back to the light-curve ones)."""
    from ..models.clip import CLIPConfig

    g = run_cfg.get
    transformer_kwargs = {
        "n_out": run_cfg["n_out"],
        "emb": run_cfg["emb"],
        "heads": run_cfg["heads"],
        "depth": run_cfg["transformer_depth"],
        "dropout": g("dropout", 0.0),
        "time_norm": g("time_norm", 10000.0),
        "agg": g("agg", "mean"),
    }
    transformer_spectral_kwargs = {
        "n_out": run_cfg["n_out"],
        "emb": g("emb_spectral", run_cfg["emb"]),
        "heads": g("heads_spectral", run_cfg["heads"]),
        "depth": g("transformer_depth_spectral", run_cfg["transformer_depth"]),
        "dropout": g("dropout", 0.0),
        "time_norm": g("time_norm_spectral", g("time_norm", 10000.0)),
        "agg": g("agg_spectral", "mean"),
    }
    conv_kwargs = {
        "dim": g("cnn_dim", 32),
        "depth": g("cnn_depth", 2),
        "channels": g("cnn_channels", 3),
        "kernel_size": g("cnn_kernel_size", 5),
        "patch_size": g("cnn_patch_size", 10),
        "n_out": run_cfg["n_out"],
        "dropout_prob": g("dropout", 0.0),
    }
    meta_kwargs = {
        "input_dim": g("meta_input_dim", 128),
        "hidden_dim": g("meta_hidden_dim", 128),
        "num_layers": g("meta_num_layers", 2),
        "dropout": g("dropout", 0.0),
    }
    vit_kwargs = {
        "emb": g("vit_emb", 128),
        "depth": g("vit_depth", 6),
        "heads": g("vit_heads", 4),
        "patch_size": g("vit_patch_size", g("cnn_patch_size", 10)),
        "mlp_mult": g("vit_mlp_mult", 4),
        "n_out": run_cfg["n_out"],
        "dropout_prob": g("dropout", 0.0),
    }
    if "vit_use_pallas" in extra:
        vit_kwargs["use_pallas"] = extra["vit_use_pallas"]
    return CLIPConfig.create(
        combinations=tuple(extra["combinations"]),
        # the reference's shared space is 128 wide unless enc_dim is given
        enc_dim=int(g("enc_dim", extra.get("enc_dim", 128))),
        logit_scale_init=g("logit_scale", 10.0),
        nband=nband,
        transformer_kwargs=transformer_kwargs,
        transformer_spectral_kwargs=transformer_spectral_kwargs,
        conv_kwargs=conv_kwargs,
        meta_kwargs=meta_kwargs,
        vit_kwargs=vit_kwargs,
        image_encoder=extra.get("image_encoder", "convmixer"),
        loss=extra.get("loss", "softmax"),
        regression=bool(extra.get("regression", False)),
        classification=bool(extra.get("classification", False)),
        n_classes=int(extra.get("n_classes", 5)),
        compute_dtype=extra.get("compute_dtype"),
        use_pallas=extra.get("use_pallas"),
    )


def build_trainer_config(run_cfg: Dict[str, Any], extra: Dict[str, Any]):
    """Flattened run config + extra_args -> ``TrainerConfig``."""
    from ..training.trainer import TrainerConfig

    g = run_cfg.get
    return TrainerConfig(
        epochs=int(g("epochs", 10)),
        batch_size=int(g("batchsize", g("batch_size", 32))),
        lr=float(g("lr", 1e-4)),
        weight_decay=float(g("weight_decay", 0.0)),
        patience=int(g("patience", 10**9)),
        seed=int(g("seed", 0)),
        noise_level_img=float(extra.get("noise_level_img", 1.0)),
        noise_level_mag=float(extra.get("noise_level_mag", 1.0)),
        step_size=g("step_size"),
        gamma=g("gamma"),
    )
