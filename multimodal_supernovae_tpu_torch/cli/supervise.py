#!/usr/bin/env python
"""Preemption-safe supervisor: restart a training command with --resume
(port of multimodal_supernovae_tpu/cli/supervise.py; a subprocess loop with
no device code).

Wraps any of the port's training CLIs (train, finetune_clip,
pretrain_masked, pretrain_sim), all of which accept ``--resume`` (continue
each unfinished run from its ``last.ckpt``, or under ``pretrain_sim
--streaming`` from the shard after its ``StreamCursor``; skip grid points
that completed)::

  python -m multimodal_supernovae_tpu_torch.cli.supervise [options] -- \
      python -m multimodal_supernovae_tpu_torch.cli.train cfg.yaml --data-dir ZTFBTS/

Behaviour: run the command; exit 0 ends supervision with 0. Any other exit
(including signals: a killed child returns negative) relaunches the command
after ``--backoff`` seconds with ``--resume`` appended (once), up to
``--max-restarts`` times. The resumed run redoes at most the epoch in
flight when the child died (a streaming run, at most the shard).

``--check`` preflights the supervised sweep instead: the command runs once
with ``--check`` appended (the training CLIs' meta-device preflight, no
restart) and supervision exits with its code.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def build_restart_cmd(cmd: list, resume_flag: str) -> list:
    """The relaunch command: ``resume_flag`` appended exactly once."""
    if resume_flag in cmd:
        return list(cmd)
    return list(cmd) + [resume_flag]


def supervise(cmd: list, max_restarts: int = 10, backoff: float = 5.0,
              resume_flag: str = "--resume") -> int:
    """Run ``cmd`` under restart supervision; returns the final exit code."""
    restarts = 0
    current = list(cmd)
    while True:
        t0 = time.time()
        proc = subprocess.Popen(current)
        code = proc.wait()
        if code == 0:
            if restarts:
                print(f"[supervise] completed after {restarts} restart(s)",
                      flush=True)
            return 0
        if restarts >= max_restarts:
            print(f"[supervise] giving up: exit {code} after "
                  f"{restarts} restart(s)", flush=True)
            return code if code > 0 else 128 - code
        restarts += 1
        print(f"[supervise] child exited {code} after {time.time()-t0:.1f}s; "
              f"restart {restarts}/{max_restarts} with {resume_flag} "
              f"in {backoff:.1f}s", flush=True)
        time.sleep(backoff)
        current = build_restart_cmd(cmd, resume_flag)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--backoff", type=float, default=5.0,
                    help="seconds between death and relaunch")
    ap.add_argument("--resume-flag", default="--resume",
                    help="flag appended to the command on relaunch")
    ap.add_argument("--check", action="store_true",
                    help="run the command once with --check appended (its preflight) "
                         "and exit with its code")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to supervise")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use: supervise.py [options] -- cmd ...)")
    if args.check:
        sys.exit(subprocess.call(build_restart_cmd(cmd, "--check")))
    sys.exit(supervise(cmd, args.max_restarts, args.backoff, args.resume_flag))


if __name__ == "__main__":
    main()
