"""Command-line entry points of the port (port of
multimodal_supernovae_tpu/cli/__init__.py).

Every CLI is a submodule with a ``main()``, run on its own as
``python -m multimodal_supernovae_tpu_torch.cli.<name>`` or behind one
umbrella command with the JAX package's command names::

  python -m multimodal_supernovae_tpu_torch train configs/maven-lite.yaml
  torchrun --nproc-per-node 8 -m multimodal_supernovae_tpu_torch train \\
      configs/maven_pretrain.yaml --mesh

The pyproject's ``mmsn`` console scripts stay the JAX package's. One
command refuses: ``export-torch`` (the port writes torch checkpoints
already; a JAX run dir reaches it through the JAX package's
``mmsn-export-torch``). ``export-model`` writes the port's serving artifact
through ``torch.export`` in place of the JAX package's StableHLO. The usage
text and exit codes are the JAX command's: 0 for help, 2 for an unknown (or
refused) command.
"""

from __future__ import annotations

import importlib
import sys
from typing import List, Optional

PROG = "python -m multimodal_supernovae_tpu_torch"

# command name -> (submodule, one-line help)
COMMANDS = {
    "train": ("train", "sweep/train on real data (script_wandb.py)"),
    "pretrain-sim": ("pretrain_sim",
                     "CLIP pretraining on simulations "
                     "(pretraining_clip_wandb.py)"),
    "finetune-clip": ("finetune_clip",
                      "CLIP fine-tuning from a pretrained run "
                      "(finetune_clip.py)"),
    "pretrain-masked": ("pretrain_masked",
                        "masked (MAE) light-curve pretraining "
                        "(retraining_wandb.py)"),
    "evaluate": ("evaluate", "batch-evaluate finished runs "
                             "(evaluate_models.py)"),
    "infer": ("infer", "batch inference / embedding export over a run dir"),
    "serve": ("serve", "HTTP embedding service with dynamic micro-batching"),
    "export-model": ("export_model",
                     "export a trained encoder to a torch.export serving artifact"),
    "export-embeddings": ("export_embeddings",
                          "embed a dataset with a finished run"),
    "export-torch": (None, "not needed: the port writes torch checkpoints"),
    "fetch-data": ("fetch_data",
                   "fetch + validate the ZTF BTS / simulation corpora"),
    "supervise": ("supervise",
                  "auto-restarting launcher for preemption-safe training"),
}

REFUSALS = {
    "export-torch": (
        "export-torch is not needed here: the port's run dirs hold torch checkpoints "
        "already (last.ckpt, epoch=E-step=S.ckpt); a JAX run dir reaches the port "
        "through the JAX package's mmsn-export-torch"),
}


def _usage() -> str:
    width = max(len(k) for k in COMMANDS)
    lines = [f"  {k.ljust(width)}  {h}" for k, (_, h) in COMMANDS.items()]
    return (
        f"usage: {PROG} <command> [args...]\n\ncommands:\n"
        + "\n".join(lines)
        + f"\n\n`{PROG} <command> --help` shows that command's arguments."
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"mmsn: unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    if cmd in REFUSALS:
        print(f"mmsn: {REFUSALS[cmd]}", file=sys.stderr)
        return 2
    module = importlib.import_module(f".{COMMANDS[cmd][0]}", __package__)
    # the submodules' main() functions read sys.argv via argparse
    saved_argv = sys.argv
    sys.argv = [f"{PROG} {cmd}"] + argv[1:]
    try:
        rc = module.main()
    finally:
        sys.argv = saved_argv
    return int(rc) if rc is not None else 0
