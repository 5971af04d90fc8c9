"""The port's utils/{flops,profiling,platform}.py against the JAX package's
on the CPU: the model FLOPs of every shipped config, the H100 peak by
device name and compute type, the Throughput meter on a fake clock, the
profiler trace, the device barrier and the device selection."""

import itertools
import json
import os
from pathlib import Path

import pytest
import torch

from multimodal_supernovae_tpu.config import build_clip_config as jax_build_clip_config
from multimodal_supernovae_tpu.config import expand_grid as jax_expand_grid
from multimodal_supernovae_tpu.config import load_sweep as jax_load_sweep
from multimodal_supernovae_tpu.utils import flops as jax_flops
from multimodal_supernovae_tpu.utils import profiling as jax_profiling
from multimodal_supernovae_tpu_torch.config import build_clip_config, expand_grid, load_sweep
from multimodal_supernovae_tpu_torch.utils import flops, profiling
from multimodal_supernovae_tpu_torch.utils.platform import select_device

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p) for p in (REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_clip_train_step_flops_equals_jax_on_every_shipped_config(path):
    sweep, jsweep = load_sweep(path), jax_load_sweep(path)
    extra = sweep.extra_args
    t_lc = 2 * int(extra.get("max_lightcurve_data_len", 100))
    t_sp = int(extra.get("max_spectral_data_len", 1000))
    points = list(itertools.islice(expand_grid(sweep), 4))
    assert points == list(itertools.islice(jax_expand_grid(jsweep), 4))
    for point in points:
        cfg = build_clip_config(point, extra, nband=2)
        jcfg = jax_build_clip_config(point, jsweep.extra_args, nband=2)
        b = int(point.get("batchsize", 32))
        got = flops.clip_train_step_flops(cfg, b, t_lc, t_sp)
        assert got == jax_flops.clip_train_step_flops(jcfg, b, t_lc, t_sp) and got > 0
        tk = dict(cfg.transformer_kwargs)
        assert flops.transformer_tower_flops(t_lc, tk["emb"], tk["depth"], 4, tk["n_out"]) == \
            jax_flops.transformer_tower_flops(t_lc, tk["emb"], tk["depth"], 4, tk["n_out"])


@pytest.mark.parametrize("name,tf32,dtype,want", [
    ("NVIDIA H100 80GB HBM3", False, torch.float32, 67e12),
    ("NVIDIA H100 80GB HBM3", True, torch.float32, 495e12),
    ("NVIDIA H100 80GB HBM3", False, torch.bfloat16, 989e12),
    ("NVIDIA H100 PCIe", False, torch.float32, 51e12),
    ("NVIDIA H100 PCIe", True, torch.float32, 378e12),
    ("NVIDIA H100 PCIe", False, torch.bfloat16, 756e12),
    ("cpu", False, torch.float32, 1e11),
])
def test_chip_peak_flops_by_device_name_and_compute_type(monkeypatch, name, tf32, dtype, want):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    assert flops.chip_peak_flops(dtype, device_name=name) == want
    assert flops.compute_type(dtype) == ("bf16" if dtype == torch.bfloat16
                                         else "tf32" if tf32 else "fp32")


def test_chip_peak_flops_refuses_an_unknown_card_and_mfu_keys(monkeypatch):
    with pytest.raises(ValueError, match="no peak FLOP/s"):
        flops.chip_peak_flops(device_name="NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peak FLOP/s"):
        flops.chip_peak_flops(device_name="NVIDIA H100 NVL")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = flops.mfu(2e11, 4.0)  # the CPU nominal 1e11
    assert sorted(got) == sorted(jax_flops.mfu(2e11, 4.0))
    assert got == {"model_tflops_per_s": 0.05, "peak_tflops_per_s": 0.1, "mfu_pct": 50.0}
    assert flops.mfu(2e11, 4.0, n_chips=2)["mfu_pct"] == 25.0


def test_throughput_matches_jax_on_a_fake_clock(monkeypatch):
    ticks = [0.0, 1.0, 1.5, 3.5, 4.0, 4.25, 10.0, 12.0]
    summaries = []
    for module in (jax_profiling, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        meter = module.Throughput(warmup=1)
        stops = []
        for _ in range(len(ticks) // 2):
            meter.start()
            stops.append(meter.stop())
        summaries.append((stops, meter.summary(items_per_call=32)))
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[1][1]["calls"] == 3 and summaries[1][1]["min_s"] == 0.25
    assert profiling.Throughput().summary() == jax_profiling.Throughput().summary() == {}


def test_fetch_barrier_waits_only_for_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    profiling.fetch_barrier({"a": [torch.ones(2)], "b": (torch.zeros(1),)})
    profiling.fetch_barrier(None)
    assert calls == []


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.startswith("trace-rank0-") and trace.endswith(".json")
    events = json.loads((tmp_path / "prof" / trace).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_select_device(monkeypatch):
    assert select_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            select_device(device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert select_device(None) == torch.device("cuda")
