"""The port's ``--check`` preflight (``training/preflight.py``) against the
JAX package's: for every shipped config the port builds, the report's task,
batch size, epochs, lr, parameter count and bytes equal JAX
``preflight_run``'s, the optimizer state's bytes equal a real port
optimizer's after one CPU step, and the notes name the port's routes; the
CLIs' ``--check`` exits 0, a broken config names its grid point and key,
the mesh flags are refused; meta tensors take the plain attention, a CUDA
tensor never does, and nothing but RAdam's step counters is concrete."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_supernovae_tpu.config import load_sweep as jax_load_sweep
from multimodal_supernovae_tpu.models import factory as jax_factory
from multimodal_supernovae_tpu.training import preflight as jax_preflight
from multimodal_supernovae_tpu_torch.cli import finetune_clip, pretrain_masked, supervise, train
from multimodal_supernovae_tpu_torch.config import expand_grid, load_sweep
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump as dump_yaml
from multimodal_supernovae_tpu_torch.data import make_synthetic_dataset, take
from multimodal_supernovae_tpu_torch.models import factory
from multimodal_supernovae_tpu_torch.ops import flash_attention as flash_mod
from multimodal_supernovae_tpu_torch.ops import fused_block as ffn_mod
from multimodal_supernovae_tpu_torch.ops import qkv_attention as qkv_mod
from multimodal_supernovae_tpu_torch.training import Trainer, TrainerConfig, preflight
from multimodal_supernovae_tpu_torch.training.experiment import _build_run
from multimodal_supernovae_tpu_torch.training.optim import build_optimizer
from multimodal_supernovae_tpu_torch.training.state import TrainState
from multimodal_supernovae_tpu_torch.training.step import make_train_step

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {name: str(REPO / "configs" / f"{name}.yaml") for name in (
    "smoke", "maven-lite", "trimodal", "maven_pretrain", "config_grid")}
COMPARED = ("task", "batch_size", "epochs", "lr", "n_params", "param_bytes")


def _shapes(extra, sp_default):
    return (2 * int(extra.get("max_lightcurve_data_len", 100)),
            int(extra.get("max_spectral_data_len", sp_default)))


def _cases():
    """(name, config path, port builder factory, JAX builder factory,
    combinations, spectral default) of every shipped config the port
    trains: cli.train's five and config_grid under the masked builder."""
    out = [(n, p, None, None, None, 1000) for n, p in CONFIGS.items()]
    out.append(("config_grid-masked", CONFIGS["config_grid"], factory.masked_model_builder,
                jax_factory.masked_model_builder, ("lightcurve",), 220))
    return out


@pytest.mark.parametrize("name,path,builder,jax_builder,combos,sp_default", _cases(),
                         ids=[c[0] for c in _cases()])
def test_preflight_run_matches_jax(name, path, builder, jax_builder, combos, sp_default):
    sweep, jsweep = load_sweep(path), jax_load_sweep(path)
    extra = sweep.extra_args
    run_cfg = next(iter(expand_grid(sweep)))
    lc_len, sp_len = _shapes(extra, sp_default)
    nband = 2 if "lightcurve" in extra["combinations"] else 1
    device = "cuda"  # smoke's head dim 4 trains on the card's CUDA-core flash kernels
    got = preflight.preflight_run(run_cfg, extra, nband, lc_len, sp_len,
                                  model_builder=builder and builder(extra),
                                  combinations=combos, device=device)
    want = jax_preflight.preflight_run(dict(run_cfg), jsweep.extra_args, nband, lc_len, sp_len,
                                       model_builder=jax_builder and jax_builder(
                                           jsweep.extra_args), combinations=combos)
    assert {k: got[k] for k in COMPARED} == {k: want[k] for k in COMPARED}
    assert got["loss_dtype"] == want["loss_dtype"] == "float32"
    assert got["train_state_bytes"] == 2 * got["param_bytes"] + got["opt_state_bytes"]
    towers = [t for t in ("lightcurve", "spectral") if t in (combos or extra["combinations"])]
    assert [n.split(":")[0] for n in got["notes"][:-1]] == towers
    assert got["notes"][-1] == preflight.OPTIMIZER_NOTE
    for note in got["notes"][:-1]:
        assert note.endswith("flash simt (CUDA cores)" if name == "smoke"
                             else "flash tf32 (3xTF32 tensor cores)"), note


def _real_opt_state_bytes(path, builder, combos, sp_default):
    """The bytes of a real port optimizer's state after one train step on the
    CPU, on a small synthetic batch of the config's shapes."""
    sweep = load_sweep(path)
    extra = sweep.extra_args
    run_cfg = next(iter(expand_grid(sweep)))
    model, _, freeze, _, tcfg = _build_run(run_cfg, extra, 2, builder and builder(extra), None)
    lc_len, sp_len = _shapes(extra, sp_default)
    modalities = combos or tuple(extra["combinations"])
    ds = make_synthetic_dataset(n=4, n_max_lc=lc_len // 2, nband=2, n_max_sp=sp_len,
                                modalities=modalities, image_size=60)
    opt, sched = build_optimizer(model.named_parameters(), lr=tcfg.lr,
                                 weight_decay=tcfg.weight_decay, step_size=tcfg.step_size,
                                 gamma=tcfg.gamma, freeze=freeze)
    step = make_train_step(model, tcfg.noise_level_mag, noise_level_img=tcfg.noise_level_img)
    batch = take(ds.to_device("cpu"), torch.arange(4))
    step(TrainState(model, opt, sched), batch, torch.Generator().manual_seed(0))
    return sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v)), sum(p.numel() for p in model.parameters()
                                           if p.requires_grad)


@pytest.mark.parametrize("name", ["maven-lite", "trimodal", "config_grid-masked"])
def test_opt_state_bytes_equal_a_real_optimizers(name):
    case = next(c for c in _cases() if c[0] == name)
    _, path, builder, _, combos, sp_default = case
    sweep = load_sweep(path)
    extra = sweep.extra_args
    lc_len, sp_len = _shapes(extra, sp_default)
    rep = preflight.preflight_run(next(iter(expand_grid(sweep))), extra, 2, lc_len, sp_len,
                                  model_builder=builder and builder(extra),
                                  combinations=combos)
    want_bytes, want_params = _real_opt_state_bytes(path, builder, combos, sp_default)
    assert rep["opt_state_bytes"] == want_bytes
    assert rep["n_params"] == want_params


@pytest.mark.parametrize("env,dtype,want", [
    ({"MMSN_FUSED_BLOCK": "1"}, None,
     ("flash tf32 (3xTF32 tensor cores), fused block mma (3xTF32 tensor cores)",
      "flash tf32 (3xTF32 tensor cores)")),
    ({"MMSN_FUSED_QKV": "1"}, None,
     ("flash tf32 (3xTF32 tensor cores), fused QKV simt (CUDA cores)",
      "flash tf32 (3xTF32 tensor cores)")),
    ({"MMSN_FUSED_QKV": "1", "MMSN_FUSED_BLOCK": "0"}, "bfloat16",
     ("flash mma (bf16 tensor cores), fused QKV mma (bf16 tensor cores)",
      "flash mma (bf16 tensor cores)")),
])
def test_notes_name_the_opt_in_routes(monkeypatch, env, dtype, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sweep = load_sweep(CONFIGS["maven-lite"])
    extra = dict(sweep.extra_args, compute_dtype=dtype) if dtype else sweep.extra_args
    run_cfg = dict(next(iter(expand_grid(sweep))), dropout=0.0)
    rep = preflight.preflight_run(run_cfg, extra, 2, 200, 1024)
    kind = dtype or "float32"
    assert rep["notes"][:2] == [f"lightcurve: T=200 emb=64 heads=8 {kind} -> {want[0]}",
                                f"spectral: T=1024 emb=32 heads=2 {kind} -> {want[1]}"]


def _check(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return exc.value.code, capsys.readouterr().out


@pytest.mark.parametrize("main,config,runs", [
    (train.main, "maven-lite", 5), (train.main, "config_grid", 2),
    (pretrain_masked.main, "config_grid", 2)])
def test_cli_check_exits_zero_without_a_card(main, config, runs, capsys):
    argv = [CONFIGS[config], "--check", "--max-runs", str(runs)]
    if main is pretrain_masked.main:
        argv += ["--source", "sim"]  # the preflight reads no data at all
    code, out = _check(main, argv, capsys)
    assert code == 0, out
    lines = out.splitlines()
    assert lines[-1] == f"preflight: {runs} run(s) OK, 0 error(s)"
    assert sum(line.startswith("run-") for line in lines) == runs


def test_a_broken_config_names_its_grid_point_and_key(tmp_path, capsys):
    raw = load_sweep(CONFIGS["maven-lite"]).raw
    path = tmp_path / "broken.yaml"
    path.write_text(dump_yaml(dict(raw, parameters=dict(raw["parameters"],
                                                        heads={"values": [3]}))))
    code, out = _check(train.main, [str(path), "--check", "--max-runs", "1"], capsys)
    assert code == 1
    error = next(line for line in out.splitlines() if line.startswith("ERROR: "))
    assert error.startswith("ERROR: run-0 {") and "'heads': 3" in error
    assert "emb 64 is not a multiple of heads 3" in error
    assert out.splitlines()[-1] == "preflight: 0 run(s) OK, 1 error(s)"


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--mesh"], ["--check-devices", "8"]])
def test_mesh_flags_are_refused(argv, capsys, monkeypatch):
    """Under --check every mesh flag is taken as the JAX preflight takes it
    (maven-lite's B = 32 divides every data axis here); training with --tp 2
    in one process raises the JAX package's indivisibility error (a model
    axis of 2 needs 2 ranks)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "MMSN_COORDINATOR",
              "MMSN_NUM_PROCESSES", "MMSN_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    code, out = _check(train.main, [CONFIGS["maven-lite"], "--check", "--max-runs", "1",
                                    *argv], capsys)
    assert code == 0 and "ERROR" not in out
    with pytest.raises(ValueError, match="1 global devices not divisible by model=2"):
        train.main([CONFIGS["maven-lite"], *argv, "--tp", "2", "--device", "cpu"])


def test_format_report_lines_match_jax():
    reports = [{"name": "run-0", "task": "contrastive", "batch_size": 32, "epochs": 1000,
                "lr": 3.716367614864064e-05, "n_params": 441474, "train_state_bytes": 7063588,
                "notes": ["lightcurve: T=200 -> a", "spectral: T=1024 -> b"]},
               {"name": "run-1", "task": "regression", "batch_size": 256, "epochs": 3,
                "lr": 5e-4, "n_params": 12, "train_state_bytes": 10,
                "pretrain_leaves_matched": (7, 40), "notes": []}]
    errors = ["run-2 {'heads': 3}: ValueError: emb 64 is not a multiple of heads 3"]
    for r, e in ((reports, errors), ([], [])):
        assert preflight.format_report(r, e) == jax_preflight.format_report(r, e)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A one-epoch port CLIP run dir of maven_pretrain's towers, cut to 1
    block each: what finetune_clip's pretrain_path names."""
    run_dir = str(tmp_path_factory.mktemp("pre") / "run-0")
    sweep = load_sweep(str(REPO / "configs/maven_pretrain.yaml"))
    run_cfg = dict(next(iter(expand_grid(sweep))), transformer_depth=1,
                   transformer_depth_spectral=1)
    model = _build_run(run_cfg, sweep.extra_args, 2, None, None)[0]
    ds = make_synthetic_dataset(n=16, n_max_lc=10, nband=2, n_max_sp=20)
    Trainer(model, "contrastive", TrainerConfig(epochs=1, batch_size=8, lr=1e-3),
            run_dir=run_dir).fit(ds.subset(np.arange(8)), ds.subset(
                np.arange(8, 16)))
    return run_dir


@pytest.mark.parametrize("head", [False, True])
def test_finetune_check_counts_the_pretrained_entries(pretrained, tmp_path, capsys, head):
    raw = load_sweep(str(REPO / "configs/maven_finetune.yaml")).raw
    extra = dict(raw["extra_args"], pretrain_path=pretrained,
                 **({"classification": True} if head else {}))
    path = tmp_path / "ft.yaml"
    path.write_text(dump_yaml(dict(raw, extra_args=extra)))
    code, out = _check(finetune_clip.main, [str(path), "--check", "--max-runs", "1"], capsys)
    assert code == 0, out
    sweep = load_sweep(str(path))
    model, _, _, override = factory.finetune_model_builder(sweep.extra_args)(
        next(iter(expand_grid(sweep))), sweep.extra_args, 2)
    sd = model.state_dict()
    matched = sum(a is not b for a, b in zip(override(sd).values(), sd.values()))
    assert f"{sum(p.numel() for p in model.parameters() if p.requires_grad):,} params" in out
    assert f"pretrained checkpoint: {matched}/{len(sd)} leaves matched" in out
    assert matched >= 20


def test_a_checkpoint_that_matches_nothing_raises(tmp_path):
    path = tmp_path / "other.ckpt"
    torch.save({"state_dict": {"net.unrelated.weight": torch.zeros(3)}}, path)
    sweep = load_sweep(CONFIGS["maven-lite"])
    extra = dict(sweep.extra_args, pretrain_path=str(path))
    with pytest.raises(ValueError, match="matches 0 parameter leaves"):
        preflight.preflight_run(next(iter(expand_grid(sweep))), extra, 2, 200, 1024)


def test_supervise_check_runs_the_command_once_with_check(tmp_path):
    marker = tmp_path / "argv"
    code = "import sys, pathlib; pathlib.Path(sys.argv[1]).write_text(' '.join(sys.argv[2:]))"
    with pytest.raises(SystemExit) as exc:
        supervise.main(["--check", "--", sys.executable, "-c", code + "; sys.exit(3)",
                        str(marker), "a"])
    assert exc.value.code == 3 and marker.read_text() == "a --check"
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_supernovae_tpu_torch.cli.supervise", "--check", "--",
         sys.executable, "-m", "multimodal_supernovae_tpu_torch.cli.train",
         CONFIGS["config_grid"], "--max-runs", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "preflight: 1 run(s) OK, 0 error(s)"


def test_meta_tensors_take_the_plain_attention_and_stay_meta(monkeypatch):
    """Every attention call of the meta step goes to dense_attention (18
    forward layers of maven-lite, each with its autograd backward); no
    kernel entry is reached; parameters, gradients, moments and the loss are
    meta, and the only concrete tensors are RAdam's 0-dim step counters."""
    calls = []
    real_dense = flash_mod.dense_attention

    def counted(*a, **kw):
        calls.append(a[0].device.type)
        return real_dense(*a, **kw)

    monkeypatch.setattr(flash_mod, "dense_attention", counted)
    monkeypatch.setattr(flash_mod, "_flash_fwd", None)  # any kernel call would fail
    seen = {}
    real_step = make_train_step

    def capture(model, *a, **kw):
        step = real_step(model, *a, **kw)

        def wrapped(state, batch, gen):
            out = step(state, batch, gen)
            seen.update(state=state, loss=out[1])
            return out

        return wrapped

    monkeypatch.setattr("multimodal_supernovae_tpu_torch.training.step.make_train_step", capture)
    sweep = load_sweep(CONFIGS["maven-lite"])
    preflight.preflight_run(next(iter(expand_grid(sweep))), sweep.extra_args, 2, 200, 1024)
    assert calls == ["meta"] * 18
    state = seen["state"]
    assert seen["loss"].is_meta
    params = list(state.model.parameters())
    assert all(p.is_meta for p in params)
    assert all(p.grad is None or p.grad.is_meta for p in params)
    for s in state.optimizer.state.values():
        assert s["exp_avg"].is_meta and s["exp_avg_sq"].is_meta
        assert s["step"].device.type == "cpu" and s["step"].dim() == 0
    assert all(b.is_meta for b in state.model.buffers())


class _Reached(Exception):
    pass


def _cuda_stub():
    return types.SimpleNamespace(device=torch.device("cuda"), shape=(2, 4), requires_grad=False,
                                 dtype=torch.float32)


@pytest.mark.parametrize("module,call", [
    (flash_mod, lambda s: flash_mod.flash_attention(s, s, s, None, 8)),
    (flash_mod, lambda s: flash_mod.flash_attention_bwd(s, s, s, None, s, s, s, 8)),
    (ffn_mod, lambda s: ffn_mod._ffn_fwd(s, s, *([s] * 10), eps=1e-6)),
    (ffn_mod, lambda s: ffn_mod.fused_ffn_block_bwd(s, s, *([s] * 10), s)),
    (qkv_mod, lambda s: qkv_mod._qkv_fwd(s, None, s, s, s, 2)),
    (qkv_mod, lambda s: qkv_mod.fused_qkv_attention_bwd(s, None, s, s, s, 2)),
])
def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch, module, call):
    """The wrappers' dispatch: a tensor on the card goes to the kernel path
    (here its argument check, stubbed to stop there), never to the plain
    version, which the meta device shares with the CPU."""
    def reached(*a, **kw):
        raise _Reached

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(module, "_check", reached)
    monkeypatch.setattr(module, "_flash_fwd" if module is flash_mod else "_check", reached)
    if module is flash_mod:  # a no-grad CUDA call enters the kernel path at its registered op
        monkeypatch.setattr(module, "flash_attention_fwd", reached)
    for name in ("dense_attention", "dense_attention_bwd", "fused_ffn_block_plain",
                 "fused_ffn_block_bwd_plain", "fused_qkv_attention_plain",
                 "fused_qkv_attention_bwd_plain"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, plain)
    assert "cuda" not in flash_mod.PLAIN_DEVICES
    with pytest.raises(_Reached):
        call(_cuda_stub())
