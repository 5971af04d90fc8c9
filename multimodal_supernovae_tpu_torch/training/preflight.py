"""Preflight (``--check``) validation for the training CLIs (port of
multimodal_supernovae_tpu/training/preflight.py).

Validates a sweep without data, without the card and without allocating:
every grid point's model is built on torch's ``meta`` device and takes one
full train step there (augment, ``loss_fn``, backward, ``optimizer.step``)
on a batch of meta tensors, which is shape work only. The attention,
fused-block and fused-QKV wrappers give meta tensors their plain versions
(``ops/attention.py:PLAIN_DEVICES``); a CUDA tensor never takes them.

Per grid point the report carries the parameter count and bytes (the
parameters that take gradients: those of the JAX package's tree), the
optimizer state's bytes (the port's torch RAdam: ``exp_avg`` and
``exp_avg_sq`` of each trained parameter and a float32 ``step`` tensor a
parameter, which differs from optax's state in the JAX report), the static
train-memory floor (2 x params + optimizer state), the flash-attention
routes each sequence tower and a ViT image tower take on the card
(``ops/flash_attention.py:_route``, forward and backward; a head dim above
the kernels' 64 fails the check, as training on the card would) and the
fused-block and fused-QKV routes where those opt-ins are on, and,
with a pretrained checkpoint, how many of the model's state_dict entries it
fills (``merge_params_nonstrict``; 0 raises: the wrong checkpoint). Errors
name the grid point and the key. With ``--mesh`` or ``--tp`` and
``--check-devices N`` (the devices the run will have) the batch's
divisibility by the data axis is checked, and the feed-forward widths'
by the model axis noted, in the JAX preflight's words.

The one concrete allocation is RAdam's 0-dim ``step`` counters, which torch
keeps on the host; every parameter, gradient, moment and the loss are meta.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

META = torch.device("meta")
ROUTE_NAMES = {
    "flash": {"tf32": "3xTF32 tensor cores", "mma": "bf16 tensor cores", "simt": "CUDA cores"},
    "fused block": {"mma": "3xTF32 tensor cores", "simt": "CUDA cores"},
    "fused QKV": {"mma": "bf16 tensor cores", "simt": "CUDA cores"},
}
OPTIMIZER_NOTE = ("optimizer state: torch RAdam (exp_avg, exp_avg_sq, a float32 step a "
                  "parameter), not the JAX report's optax state")


def abstract_batch(combinations, batch_size: int, lc_len: int, sp_len: int,
                   image_size: int = 60, channels: int = 3) -> Dict[str, torch.Tensor]:
    """A batch of meta tensors with the shapes ingest would produce
    (``lc_len`` is the band-blocked TOTAL light-curve length, nband *
    max_lightcurve_data_len)."""

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=META)

    fields = {"redshift": t(batch_size), "label": t(batch_size, dtype=torch.int32)}
    if "lightcurve" in combinations:
        fields.update(x_lc=t(batch_size, lc_len), t_lc=t(batch_size, lc_len),
                      mask_lc=t(batch_size, lc_len, dtype=torch.bool),
                      err_lc=t(batch_size, lc_len))
    if "spectral" in combinations:
        fields.update(x_sp=t(batch_size, sp_len), t_sp=t(batch_size, sp_len),
                      mask_sp=t(batch_size, sp_len, dtype=torch.bool),
                      err_sp=t(batch_size, sp_len))
    if "host_galaxy" in combinations:
        fields["x_img"] = t(batch_size, image_size, image_size, channels)
    return fields


def _count_bytes(tensors) -> Tuple[int, int]:
    """(elements, bytes) over tensors."""
    tensors = list(tensors)
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def _towers(model) -> Dict[str, Any]:
    """{"lightcurve"/"spectral": the model's SequenceEncoder of that tower}
    (a masked pretrainer's ``net`` is its light-curve tower)."""
    from ..models.transformer import SequenceEncoder

    out = {}
    for name, module in model.named_modules():
        if isinstance(module, SequenceEncoder):
            leaf = name.rsplit(".", 1)[-1]
            out["spectral" if leaf == "spectral_encoder" else "lightcurve"] = module
    return out


def _flash_note(what: str, dtype: torch.dtype, head_dim: int) -> str:
    """The flash route of ``head_dim`` on the card (``ops/flash_attention.py:
    _route``, 16-byte rows), one rule for the forward and the backward: the
    tensor cores at head dims 8, 16, 32 and 64, the CUDA cores at the rest.
    Raises above the kernels' limit, naming it and ``what``."""
    from ..ops import flash_attention as flash

    if not 1 <= head_dim <= flash.MAX_HEAD_DIM:
        raise ValueError(f"{what}: the flash kernels take head dims 1 to {flash.MAX_HEAD_DIM}")
    route = flash._route(dtype, head_dim, ())
    return f"flash {route} ({ROUTE_NAMES['flash'][route]})"


def _dispatch_note(tower: str, t: int, encoder, device_type: str = "cuda") -> str:
    """The routes this tower's layers take on ``device_type``: on the card
    the flash-attention routes of ``ops/flash_attention.py:_route`` for its
    dtype and head dim, and the fused block's and fused QKV's when their
    opt-ins are on (raises on a head dim above the flash kernels' 64);
    elsewhere the plain versions."""
    from ..ops import fused_block, qkv_attention

    block = encoder.transformer.tblocks[0]
    sa = block.attention
    emb, heads = sa.emb, sa.heads
    head_dim = emb // heads
    dtype = sa.dtype or torch.float32
    head = f"{tower}: T={t} emb={emb} heads={heads} {str(dtype).replace('torch.', '')} -> "
    if device_type != "cuda":
        return head + f"plain versions ({device_type})"
    parts = [_flash_note(f"{tower}: head dim {emb} / {heads} = {head_dim}", dtype, head_dim)]
    env = os.environ.get("MMSN_FUSED_BLOCK")
    fused = block.use_fused_block if env != "0" else False
    if fused is None:
        fused = env == "1"
    if fused and block.dropout == 0.0 and fused_block.supports(emb, heads, block.ff_hidden_mult):
        r = fused_block._route(dtype, emb, block.ff_hidden_mult * emb)
        parts.append(f"fused block {r} ({ROUTE_NAMES['fused block'][r]})")
    if os.environ.get("MMSN_FUSED_QKV") == "1" and qkv_attention.supports(t, emb, heads):
        r = qkv_attention._route(dtype, head_dim)
        parts.append(f"fused QKV {r} ({ROUTE_NAMES['fused QKV'][r]})")
    return head + ", ".join(parts)


def _vit_note(model, image_size: int, device_type: str) -> Optional[str]:
    """The ViT image tower's attention route on ``device_type``, or None
    without a ViT. Its blocks attend over (image_size / patch)^2 tokens at
    head dim vit_emb / vit_heads with no mask; training on the card needs a
    head dim the flash kernels take, 1 to 64 (raises otherwise, naming it)."""
    from ..models.vit import ViT

    vit = next((m for m in model.modules() if isinstance(m, ViT)), None)
    if vit is None:
        return None
    head_dim = vit.emb // vit.heads
    t = (image_size // vit.patch_size) ** 2
    dtype = vit.dtype or torch.float32
    head = (f"image (ViT): T={t} emb={vit.emb} heads={vit.heads} "
            f"{str(dtype).replace('torch.', '')} -> ")
    if device_type != "cuda":
        return head + f"plain versions ({device_type})"
    # the tower's q/k/v are views of separate projections: 16-byte rows
    return head + _flash_note(f"image (ViT): head dim {vit.emb} / {vit.heads} = {head_dim}",
                              dtype, head_dim)


def preflight_run(
    run_cfg: Dict[str, Any],
    extra: Dict[str, Any],
    nband: int,
    lc_len: int,
    sp_len: int,
    image_size: int = 60,
    model_builder: Optional[Callable] = None,
    epochs_override: Optional[int] = None,
    combinations: Optional[Tuple[str, ...]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Shape-check ONE grid point: build the model on the meta device, then
    the optimizer and one train step there. Raises on any config or shape
    error; returns the report dict otherwise. ``combinations`` overrides
    ``extra_args.combinations`` for the batch (the masked trainer consumes
    light curves only, whatever the YAML sweeps). ``device`` is where the
    run would train, which the notes' routes are for."""
    from .experiment import _build_run
    from .optim import build_optimizer
    from .state import TrainState
    from .step import make_train_step

    with torch.device(META):
        model, task, freeze, params_override, tcfg = _build_run(
            run_cfg, extra, nband, model_builder, epochs_override, image_size=image_size)
    model.to(META)  # buffers made from numpy (the class weights) start on the host
    if combinations is None:
        combinations = tuple(extra["combinations"])
    batch = abstract_batch(combinations, tcfg.batch_size, lc_len, sp_len, image_size)
    opt, sched = build_optimizer(
        model.named_parameters(), lr=tcfg.lr, weight_decay=tcfg.weight_decay,
        step_size=tcfg.step_size, gamma=tcfg.gamma, freeze=freeze)
    step = make_train_step(model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img)
    # the draws are meta tensors too; the generator only has to exist
    _, loss = step(TrainState(model, opt, sched), batch, torch.Generator())

    # the parameters of the JAX package's tree: not the masked encoder's dead
    # projection, a zero constant kept only for the state_dict's layout
    n_params, param_bytes = _count_bytes(p for p in model.parameters() if p.requires_grad)
    _, opt_bytes = _count_bytes(v for s in opt.state.values() for v in s.values()
                                if torch.is_tensor(v))
    report: Dict[str, Any] = {
        "task": task,
        "batch_size": tcfg.batch_size,
        "epochs": tcfg.epochs,
        "lr": tcfg.lr,
        "n_params": n_params,
        "param_bytes": param_bytes,
        "opt_state_bytes": opt_bytes,
        # params + grads + optimizer state; activations are shape- and
        # schedule-dependent, so this is the static floor, not a ceiling
        "train_state_bytes": 2 * param_bytes + opt_bytes,
        "loss_dtype": str(loss.dtype).replace("torch.", ""),
        "notes": [],
    }
    towers = _towers(model)
    for tower, t in (("lightcurve", lc_len), ("spectral", sp_len)):
        if tower in combinations and tower in towers:
            report["notes"].append(_dispatch_note(tower, t, towers[tower],
                                                  torch.device(device).type))
    if "host_galaxy" in combinations:
        note = _vit_note(model, image_size, torch.device(device).type)
        if note is not None:
            report["notes"].append(note)
    report["notes"].append(OPTIMIZER_NOTE)

    # The surgery on the meta state_dict: merge_params_nonstrict copies
    # only the checkpoint's shape-matching entries, so the entries that
    # became concrete count how much of it lands; 0 means the wrong
    # checkpoint, which the reference's strict=False load trains through.
    if params_override is not None:
        merged = params_override(model.state_dict())
        concrete = sum(not v.is_meta for v in merged.values())
        report["pretrain_leaves_matched"] = (concrete, len(merged))
        if concrete == 0:
            raise ValueError("pretrained checkpoint matches 0 parameter leaves "
                             "(wrong architecture or wrong path?)")
    return report


def preflight_sweep(
    sweep,
    nband: int,
    lc_len: int,
    sp_len: int,
    image_size: int = 60,
    model_builder: Optional[Callable] = None,
    epochs_override: Optional[int] = None,
    max_runs: Optional[int] = None,
    combinations: Optional[Tuple[str, ...]] = None,
    device="cuda",
    mesh_shape: Optional[Dict[str, int]] = None,
) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Validate every grid point of a sweep. Returns (reports, errors); an
    empty error list means the sweep is safe to submit. ``mesh_shape`` is
    the requested {'data': N, 'model': M} layout, checked for the JAX
    preflight's batch divisibility without joining a process group."""
    from ..config.config import SweepScheduler

    extra = sweep.extra_args
    scheduler = SweepScheduler(sweep, max_runs=max_runs)
    reports: List[Dict[str, Any]] = []
    errors: List[str] = []

    for key in ("pretrain_lc_path", "pretrain_path"):
        p = extra.get(key)
        if p and not os.path.exists(p):
            errors.append(f"extra_args.{key}: {p} does not exist")

    k = -1
    while True:
        run_cfg = scheduler.suggest()
        if run_cfg is None:
            break
        k += 1
        name = f"run-{k}"
        try:
            rep = preflight_run(
                run_cfg, extra, nband, lc_len, sp_len, image_size,
                model_builder=model_builder, epochs_override=epochs_override,
                combinations=combinations, device=device)
        except Exception as e:  # noqa: BLE001 — report, don't crash the scan
            errors.append(f"{name} {dict(run_cfg)}: {type(e).__name__}: {e}")
            continue
        rep["name"] = name
        rep["run_cfg"] = dict(run_cfg)
        if mesh_shape:
            errors.extend(_mesh_problems(name, rep, run_cfg, mesh_shape))
        reports.append(rep)
        scheduler.observe(run_cfg, None)
    return reports, errors


def _mesh_problems(name: str, rep: Dict[str, Any], run_cfg: Dict[str, Any],
                   mesh_shape: Dict[str, int]) -> List[str]:
    """The JAX preflight's mesh checks of one grid point: an error when the
    data axis does not divide the batch, a note on ``rep`` for each
    feed-forward width the model axis does not divide."""
    errors = []
    n_data = int(mesh_shape.get("data", 1))
    n_model = int(mesh_shape.get("model", 1))
    if rep["batch_size"] % max(n_data, 1) != 0:
        errors.append(f"{name}: batch_size {rep['batch_size']} not divisible "
                      f"by the data mesh axis ({n_data})")
    if n_model > 1 and "emb" in run_cfg:
        for tower, emb in (("lightcurve", int(run_cfg["emb"])),
                           ("spectral", int(run_cfg.get("emb_spectral", run_cfg["emb"])))):
            if (4 * emb) % n_model != 0:
                rep["notes"].append(
                    f"tp={n_model}: {tower} FF hidden {4 * emb} not "
                    f"divisible — those kernels replicate "
                    f"(parallel/sharding.py falls back silently)")
    return errors


def add_check_args(ap) -> None:
    """Attach the shared --check CLI flags to an argparse parser."""
    ap.add_argument("--check", action="store_true",
                    help="validate the sweep without training: build every grid point's "
                         "model and run one full train step on the meta device (no data, "
                         "no card, no allocation). Exits non-zero on any error")
    ap.add_argument("--check-devices", type=int, default=None,
                    help="with --check and --mesh/--tp: the device count the run will "
                         "have, so mesh divisibility is validated too")


def run_cli_check(
    sweep,
    nband: int,
    lc_len: int,
    sp_len: int,
    args,
    model_builder: Optional[Callable] = None,
    combinations: Optional[Tuple[str, ...]] = None,
    image_size: int = 60,
) -> int:
    """The CLIs' --check entry: preflight the sweep and return the exit
    code (0 = every grid point validated)."""
    mesh_shape = None
    tp = int(getattr(args, "tp", 1) or 1)
    want_mesh = bool(getattr(args, "mesh", False)) or tp > 1
    n_devices = getattr(args, "check_devices", None)
    if want_mesh and n_devices:
        mesh_shape = {"data": max(1, n_devices // max(tp, 1)), "model": tp}
    elif want_mesh:
        print(
            "--check: pass --check-devices N (the pod's device count) to "
            "also validate mesh divisibility for --mesh/--tp"
        )
    reports, errors = preflight_sweep(
        sweep, nband=nband, lc_len=lc_len, sp_len=sp_len, image_size=image_size,
        model_builder=model_builder, epochs_override=getattr(args, "epochs", None),
        max_runs=getattr(args, "max_runs", None) or sweep.extra_args.get("nruns"),
        combinations=combinations, device=getattr(args, "device", "cuda"),
        mesh_shape=mesh_shape)
    print(format_report(reports, errors))
    return 1 if errors else 0


def format_report(reports: List[Dict[str, Any]], errors: List[str]) -> str:
    """Human-readable summary for the CLIs."""
    lines = []
    for r in reports:
        mb = r["train_state_bytes"] / 2**20
        lines.append(
            f"{r['name']}: {r['task']} B={r['batch_size']} "
            f"epochs={r['epochs']} lr={r['lr']:g} | "
            f"{r['n_params']:,} params, train state ~{mb:.1f} MiB"
        )
        if "pretrain_leaves_matched" in r:
            c, n = r["pretrain_leaves_matched"]
            lines.append(f"  pretrained checkpoint: {c}/{n} leaves matched")
        for note in r["notes"]:
            lines.append(f"  {note}")
    for e in errors:
        lines.append(f"ERROR: {e}")
    lines.append(f"preflight: {len(reports)} run(s) OK, {len(errors)} error(s)")
    return "\n".join(lines)
