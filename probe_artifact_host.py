#!/usr/bin/env python3
"""The host cost of the serving artifact and of the kernels' registered ops,
on one CUDA GPU.

  python3 probe_artifact_host.py [--parent DIR]   # from the repository root

Prints the card's name and power limit first; exits non-zero without CUDA.
Three measurements, each at chip_smoke.py's serving shapes (B = 256, LC 2 x
100, SP 1024, maven-lite widths):

1. The flash forward a call, bf16, at LC (256, 8, 200, 8) and SP (256, 2,
   1024, 16), in turns: the direct launcher (``_flash_fwd``), the port's
   registered op (``mmsn_torch::flash_attention_fwd``, a plain
   ``torch.library.Library`` definition) and the same body registered here
   by ``torch.library.custom_op``, under ``inference_mode`` (as served)
   and ``no_grad`` (as evaluated in a fit): host ms a call (each call on an
   idle card, median of 50) and CUDA-event ms (median of 25), chip_smoke.py's
   ``_host_ms`` and ``_time_ms``.
2. Each of chip_smoke.py's EXPORT_CASES run dirs (bf16, MMSN_FUSED_BLOCK=1,
   MMSN_FUSED_QKV=1, float32), exported by ``cli.export_model``: a served
   call (copies in and out included) of ``exported.module()`` as
   ``torch.export`` gives it, of ``load_artifact`` (its
   ``serving_module``: the module without its ``_assert_tensor_metadata``
   nodes) and of ``load_live``, host clock in rounds of 10 consecutive
   calls (raw, artifact, live, live, artifact, raw; medians of 20), device
   time and idle share by chip_smoke.py's ``_trace``; the graph's nodes and
   assert nodes; and one call of each under a CPU-side torch.profiler: the
   ops it ran, its ``aten::_assert_tensor_metadata`` calls and their self
   CPU time.
3. With ``--parent DIR`` (an unpacked checkout of another commit, e.g. the
   parent): ``load_live``'s served call on the bf16 run dir in a fresh
   process of each checkout, in turns parent, this, this, parent (host
   clock, median of 20 in rounds of 10 after 10 warm-up calls; each checkout
   builds its own kernels first); where the checkout's flash forward is a
   registered op, also with its no-grad call sent straight to the
   launcher, in turns with the op within the same process.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# a fresh process timing load_live's served call in the checkout argv[1] (its
# package first on sys.path): run dir argv[2], feed .npz argv[3], JSON out argv[4],
# lc_len and sp_len argv[5:7]
LIVE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from multimodal_supernovae_tpu_torch.serving import load_live
with np.load(sys.argv[3]) as z:
    feed = {k: z[k] for k in z.files}
b = len(feed["x_lc"])
live = load_live(sys.argv[2], b, device="cuda", lc_len=int(sys.argv[5]),
                 sp_len=int(sys.argv[6]))
for _ in range(10):
    live.fn(feed)
from multimodal_supernovae_tpu_torch.ops import flash_attention as fa
op = getattr(fa, "flash_attention_fwd", None)
launcher = lambda *a: fa._flash_fwd(*a, with_stats=False)[0]
times = {"as loaded": [], "flash op -> launcher": []}
arms = ["as loaded"] if op is None else ["as loaded", "flash op -> launcher"] * 2
for arm in arms + arms[::-1]:
    if op is not None:
        fa.flash_attention_fwd = op if arm == "as loaded" else launcher
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live.fn(feed)
        times[arm].append((time.perf_counter() - t0) * 1e3)
import multimodal_supernovae_tpu_torch as pkg
with open(sys.argv[4], "w") as f:
    json.dump({"package": pkg.__file__,
               "host_ms": {k: float(np.median(v)) for k, v in times.items() if v},
               "min_ms": {k: float(np.min(v)) for k, v in times.items() if v}}, f)
"""


def _custom_op():
    """The flash forward's body registered by ``torch.library.custom_op``
    under this probe's own namespace."""
    from multimodal_supernovae_tpu_torch.ops import flash_attention as fa

    @torch.library.custom_op("mmsn_probe::flash_attention_fwd", mutates_args=(),
                             device_types="cuda",
                             schema="(Tensor q, Tensor k, Tensor v, Tensor? key_mask, "
                                    "int emb) -> Tensor")
    def op(q, k, v, key_mask, emb):
        return fa._flash_fwd(q, k, v, key_mask, emb, with_stats=False)[0]

    op.register_fake(fa._flash_attention_fwd_fake)
    return op


def dispatch(cs):
    fa = cs.flash_mod
    custom = _custom_op()
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, (b, h, t, s) in (("LC", (cs.BATCH, 8, cs.NBAND * cs.LC_LEN, 8)),
                               ("SP", (cs.BATCH, 2, cs.SP_LEN, 16))):
        x = torch.randn(b, t, 3 * h * s, device="cuda", generator=g).to(torch.bfloat16)
        q, k, v = (a.view(b, t, h, s).transpose(1, 2) for a in x.split(h * s, dim=-1))
        mask = torch.rand(b, t, device="cuda", generator=g) > 0.2
        fns = {"launcher": lambda: fa._flash_fwd(q, k, v, mask, h * s, with_stats=False)[0],
               "library op": lambda: fa.flash_attention_fwd(q, k, v, mask, h * s),
               "custom_op": lambda: custom(q, k, v, mask, h * s)}
        want = fns["launcher"]()
        for tag, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"probe dispatch {name}: {tag} differs from the launcher")
        for mode, ctx in (("inference_mode", torch.inference_mode), ("no_grad", torch.no_grad)):
            host, events = collections.defaultdict(list), collections.defaultdict(list)
            with ctx():
                for _ in range(2):  # in turns
                    for tag, fn in fns.items():
                        host[tag].append(cs._host_ms(fn) * 1e3)
                        events[tag].append(cs._time_ms(fn))
            cs.log(f"probe dispatch {name} {(b, h, t, s)} bf16, {mode}: " + "; ".join(
                f"{tag} host {np.median(host[tag]):.1f} us a call, events "
                f"{np.median(events[tag]):.4f} ms" for tag in fns) + " (medians of two rounds)")


def _raw_fn(data):
    """The served call of ``exported.module()`` as ``torch.export`` gives it."""
    from multimodal_supernovae_tpu_torch.evaluation.export import _device_of, _tensor
    from multimodal_supernovae_tpu_torch.serving.server import _host_outputs

    exported = torch.export.load(io.BytesIO(data))
    target, module = _device_of(exported), exported.module()

    def fn(d):
        with torch.inference_mode():
            return tuple(module({k: _tensor(v).to(target) for k, v in d.items()}))

    return _host_outputs(fn), exported


def _cpu_profile(fn, full, n=5):
    """``n`` calls under a CPU-side torch.profiler: a call's wall, its ops,
    their self CPU ms, its assert ops and their CPU ms, and each op's self
    CPU ms a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(full)
        wall = (time.perf_counter() - t0) * 1e3 / n
    ka = prof.key_averages()
    asserts = [e for e in ka if e.key == "aten::_assert_tensor_metadata"]
    return {"wall_ms": round(wall, 3), "ops": sum(e.count for e in ka) // n,
            "self_cpu_ms": round(sum(e.self_cpu_time_total for e in ka) / 1e3 / n, 3),
            "asserts": sum(e.count for e in asserts) // n,
            "assert_ms": round(sum(e.cpu_time_total for e in asserts) / 1e3 / n, 3)}, \
        {e.key: e.self_cpu_time_total / 1e3 / n for e in ka}


def artifacts(cs, tmp, full):
    from multimodal_supernovae_tpu_torch.serving import load_artifact, load_live

    for tag, dtype, env in cs.EXPORT_CASES:
        run_dir, art = os.path.join(tmp, tag), os.path.join(tmp, f"{tag}.pt2")
        os.makedirs(run_dir)
        cs._run_dir(run_dir, compute_dtype=dtype)
        with mock.patch.dict(os.environ, env):
            live = load_live(run_dir, cs.BATCH, device="cuda", lc_len=cs.LC_LEN,
                             sp_len=cs.SP_LEN)
            cs.cli_export_model.main([run_dir, "--out", art, "--batch-size", str(cs.BATCH),
                                      "--lc-len", str(cs.LC_LEN), "--sp-len", str(cs.SP_LEN)])
            with open(art, "rb") as f:
                raw, exported = _raw_fn(f.read())
            fns = {"raw module": raw, "artifact": load_artifact(art).fn, "load_live": live.fn}
            want = live.fn(full)
            for name, fn in fns.items():
                if not all(np.array_equal(a, b) for a, b in zip(fn(full), want)):
                    raise AssertionError(f"probe {tag}: {name} is not bitwise load_live")
            host = collections.defaultdict(list)
            for name in ("raw module", "artifact", "load_live", "load_live", "artifact",
                         "raw module"):
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fns[name](full)
                    host[name].append((time.perf_counter() - t0) * 1e3)
            traced = {name: cs._trace(lambda fn=fn: fn(full), cs.PROFILED_STEPS)
                      for name, fn in fns.items()}
            cpu = {name: _cpu_profile(fn, full) for name, fn in fns.items()}
        nodes = collections.Counter(str(n.target) for n in exported.graph.nodes
                                    if n.op == "call_function")
        cs.log(f"probe artifact {tag}: graph {sum(nodes.values())} op nodes, "
               f"{nodes['aten._assert_tensor_metadata.default']} of them "
               f"_assert_tensor_metadata, {nodes['aten.to.dtype']} to.dtype")
        for name in fns:
            t = traced[name]
            cs.log(f"probe artifact {tag} {name}: host clock {np.median(host[name]):.3f} ms "
                   f"(median of 20, min {np.min(host[name]):.3f}); device {t[0]:.3f} ms, idle "
                   f"share {t[3]:.3f}, {t[4]:.0f} device ops; a call under the CPU profiler "
                   f"(5 calls) {cpu[name][0]}")
        art, live_ops = cpu["artifact"][1], cpu["load_live"][1]
        diff = sorted(((art.get(k, 0.0) - live_ops.get(k, 0.0), k)
                       for k in set(art) | set(live_ops)), reverse=True)
        cs.log(f"probe artifact {tag}: self CPU ms a call, artifact minus load_live, the "
               f"largest: {[(k, round(d, 3)) for d, k in diff[:6]]}; the smallest: "
               f"{[(k, round(d, 3)) for d, k in diff[-3:]]}")


def parent_live(cs, tmp, full, parent):
    run_dir, feed = os.path.join(tmp, "live-bf16"), os.path.join(tmp, "feed.npz")
    os.makedirs(run_dir)
    cs._run_dir(run_dir)
    np.savez(feed, **full)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("MMSN_FUSED")}
    env.pop("PYTHONPATH", None)
    res = collections.defaultdict(list)
    for tag, root in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        out = os.path.join(tmp, "live.json")
        proc = subprocess.run([sys.executable, "-c", LIVE, os.path.abspath(root), run_dir,
                               feed, out, str(cs.LC_LEN), str(cs.SP_LEN)],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"probe live {tag}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        with open(out) as f:
            got = json.load(f)
        if not got["package"].startswith(os.path.abspath(root)):
            raise AssertionError(f"probe live {tag}: imported {got['package']}")
        res[tag].append(round(got["host_ms"]["as loaded"], 3))
        cs.log(f"probe live {tag}: load_live's served call at B={cs.BATCH} bf16, host clock "
               f"medians {got['host_ms']} ms (mins {got['min_ms']}) in a fresh process of "
               f"{root}")
    cs.log(f"probe live: parent {res['parent']} ms, this {res['this']} ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked checkout to time load_live against")
    args = ap.parse_args()
    import chip_smoke as cs

    card, _ = cs.phase_device()
    cs.phase_build()
    syn, _ = cs._serve_feeds()
    full = {k: syn[k][:cs.BATCH] for k in cs.SERVE_FIELDS}
    dispatch(cs)
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out", prefix="probe-") as tmp:
        artifacts(cs, tmp, full)
        if args.parent:
            parent_live(cs, tmp, full, args.parent)
    cs.log(f"probe: done; card {card}")


if __name__ == "__main__":
    main()
