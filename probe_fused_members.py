#!/usr/bin/env python3
"""The fused kernels' one-member launch (M = 1) of a source tree, timed on
one CUDA GPU: forward and backward of kernels 3-6 at the light-curve shapes
((51200, 64, 256) rows for the fused block, (256, 200, 64) with 8 heads for
the fused QKV), each route in its own dtype (float32: 3b/4b and 5a/6a;
bf16: 3a/4a and 5b/6b). Device ms a call: torch.profiler, the sum of the
call's device ops over 50 calls, median of 3 rounds.

  python3 probe_fused_members.py TREE    # TREE: a checkout, e.g. of the parent

Compare two commits in one call by unpacking each (``git archive``) under
``.checkouts/`` and running them in turns (parent, change, change,
parent); each builds its own kernels into its own ``.kernel_build/``.
Prints one JSON line {"tree": TREE, "device_ms": {...}, "rounds": {...}}.
"""
import json, os, sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from multimodal_supernovae_tpu_torch.ops import fused_block as fb, qkv_attention as qa

assert fb.__file__.startswith(tree), fb.__file__
torch.backends.cuda.matmul.allow_tf32 = False


def device_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


gen = torch.Generator().manual_seed(0)


def r(*shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).cuda()


out = {}
n, e, f = 256 * 200, 64, 256
params = [r(e, e, scale=e ** -0.5), r(e, scale=0.1), r(e, scale=0.1, shift=1.0), r(e, scale=0.1),
          r(f, e, scale=e ** -0.5), r(f, scale=0.1), r(e, f, scale=f ** -0.5), r(e, scale=0.1),
          r(e, scale=0.1, shift=1.0), r(e, scale=0.1)]
for dtype in (torch.float32, torch.bfloat16):
    att, x, g = (r(n, e).to(dtype) for _ in range(3))
    route = fb._route(dtype, e, f)
    for way, fn in (("fwd", lambda: fb._ffn_fwd(att, x, *params, eps=1e-6)),
                    ("bwd", lambda: fb.fused_ffn_block_bwd(att, x, *params, g))):
        out[f"ffn_{way}_{route}_{str(dtype)[6:]}"] = [device_ms(fn) for _ in range(3)]
b, t, e, h = 256, 200, 64, 8
wqkv, wu, bu = r(3 * e, e, scale=e ** -0.5), r(e, e, scale=e ** -0.5), r(e, scale=0.1)
mask = torch.rand((b, t), generator=gen).cuda() > 0.3
mask[:, 0] = True
for dtype in (torch.float32, torch.bfloat16):
    x, g = r(b, t, e).to(dtype), r(b, t, e).to(dtype)
    route = qa._route(dtype, e // h)
    for way, fn in (("fwd", lambda: qa._qkv_fwd(x, mask, wqkv, wu, bu, h)),
                    ("bwd", lambda: qa.fused_qkv_attention_bwd(x, mask, wqkv, wu, g, h))):
        out[f"qkv_{way}_{route}_{str(dtype)[6:]}"] = [device_ms(fn) for _ in range(3)]
print(json.dumps({"tree": sys.argv[1], "device_ms": {k: float(np.median(v)) for k, v in out.items()},
                  "rounds": out}), flush=True)
