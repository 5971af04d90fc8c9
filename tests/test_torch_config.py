"""The port's config reader and builders against PyYAML and the JAX
package, on CPU: ``safe_load`` equals ``yaml.safe_load`` on every file of
configs/ and on every scalar form listed here, and raises on what it does
not know; ``dump`` writes JSON that both read back; ``load_sweep`` +
``expand_grid`` give the JAX grid; ``build_clip_config`` and
``build_trainer_config`` give the JAX configs field by field; the port's new
modules import no jax and no yaml."""

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys

import pytest
import yaml

from multimodal_supernovae_tpu.config import config as jax_config
from multimodal_supernovae_tpu_torch.config import (
    YAMLSubsetError,
    build_clip_config,
    build_trainer_config,
    expand_grid,
    load_sweep,
    safe_load,
)
from multimodal_supernovae_tpu_torch.config.yaml_subset import dump

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_there_are_six_configs():
    assert [os.path.basename(c) for c in CONFIGS] == [
        "config_grid.yaml", "maven-lite.yaml", "maven_finetune.yaml",
        "maven_pretrain.yaml", "smoke.yaml", "trimodal.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_pyyaml_on_the_configs(path):
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    got = safe_load(text)
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)  # types too


SCALARS = [
    "1", "-1", "+1", "0", "-0", "07", "0_7", "09", "0x1F", "-0b101", "1_000", "1.0", "1.",
    ".5", "+.5", "-.5e+3", "1e-4", "1.0e-4", "1.0e+4", "5.0e-05", "3.716367614864064e-05",
    "1.0e14", "1.e5", "12e3", "0o17", ".inf", "-.inf", "+.INF", ".NaN", "yes", "No", "ON",
    "off", "true", "FALSE", "y", "n", "null", "~", "Null", "", "abc", "a b c", "mean",
    "analysis/maven_pretrain/run-0", "ZTF_Pretrain_5Class.hdf5", "-x", "a:b", "x#c",
    "x # comment", "'quoted'", "'it''s'", '"tab\\tand \\u00e9"', "[1, 2.5, a, 'b', \"c\"]",
    "[[1, 2], [], {a: 1}]", "{a: [1, 2], b: {c: d}}",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_reader_types_values_as_pyyaml(scalar):
    doc = f"key: {scalar}\n"
    want, got = yaml.safe_load(doc), safe_load(doc)
    if isinstance(want["key"], float) and math.isnan(want["key"]):
        assert math.isnan(got["key"])
        return
    assert got == want
    assert type(got["key"]) is type(want["key"])


DOCS = [
    "a:\n- 1\n- 2\nb: x\n",                  # a sequence at its key's indent
    "a:\n  - 1\n  - [2, 3]\n",
    "a:\n  b:\n    c: 1\n  d: 2\n",
    "a:\n-\n  b: 1\n",
    '{\n "a": 1.0e-05,\n "b": [1, "x"]\n}\n',  # JSON
    "a: [1,\n  2, # two\n  3]\n",
    "- a\n- b\n",
    "# nothing\n",
    "",
    '"k k": 1\n1: a\nnull: b\n',
    "a: 1 # one\nb: 2 # two\n",
    "a:\r\n  b: 1\r\n",
]


@pytest.mark.parametrize("doc", DOCS)
def test_reader_equals_pyyaml_on_block_and_flow_forms(doc):
    assert safe_load(doc) == yaml.safe_load(doc)


UNKNOWN = [
    "a: &x 1\n", "a: *x\n", "a: |\n  text\n", "a: >\n  text\n", "a: !!str 1\n",
    "- a: 1\n", "- - 1\n", "a: 1\na: 2\n", "---\na: 1\n", "%YAML 1.1\na: 1\n",
    "a: 2001-12-14\n", "a: 1:20\n", "? a\n: b\n", "a: x\n  y\n", "a: [a\n  b]\n",
    "a: {x: 1, y: }\n", "a: [x: 1]\n", "a: 'open\n", "a: \"\\x41\"\n", "<<: 1\n",
    "a: =\n", "a: b: c\n", "a:\tb\n", "a: 1\n  b: 2\n", "\ta: 1\n", "a: [1, 2\n",
    "a: [1] x\n", "a: @x\n",
]


@pytest.mark.parametrize("doc", UNKNOWN)
def test_reader_raises_on_what_it_does_not_know(doc):
    with pytest.raises(YAMLSubsetError, match="line"):
        safe_load(doc)


def test_dump_reads_back_in_both_readers():
    config = {"lr": 5e-05, "tiny": 1e-05, "huge": 1e20, "n": 3, "s": "a b: c # d",
              "l": [1, 2.0, "x"], "t": (1, 2), "flag": True, "none": None,
              "u": "\u00e9\"\n", "nested": {"a": [1.5e-07]}}
    text = dump(config)
    want = dict(config, t=[1, 2])
    assert yaml.safe_load(text) == want
    assert safe_load(text) == want
    assert isinstance(yaml.safe_load(text)["tiny"], float)
    for bad in (math.inf, -math.inf, math.nan):
        with pytest.raises(ValueError, match="non-finite"):
            dump({"x": bad})
    with pytest.raises(TypeError):
        dump({1: "x"})


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_sweep_and_grid_equal_jax(path):
    want, got = jax_config.load_sweep(path), load_sweep(path)
    for field in ("parameters", "extra_args", "method", "metric", "raw"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.n_points == want.n_points
    assert list(expand_grid(got)) == list(jax_config.expand_grid(want))


def test_random_grid_equals_jax(tmp_path):
    path = str(tmp_path / "random.yaml")
    with open(path, "w") as f:
        f.write("method: random\nparameters:\n  lr:\n    values: [1.0e-3, 1.0e-4, 5.0e-5]\n"
                "  emb:\n    values: [16, 32]\n  agg:\n    value: mean\n"
                "extra_args:\n  nruns: 7\n  sweep_seed: 3\n")
    want = list(jax_config.expand_grid(jax_config.load_sweep(path)))
    got = list(expand_grid(load_sweep(path)))
    assert got == want and len(got) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_builders_equal_jax_field_by_field(path):
    sweep, jax_sweep = load_sweep(path), jax_config.load_sweep(path)
    point, jax_point = next(expand_grid(sweep)), next(jax_config.expand_grid(jax_sweep))
    clip = dataclasses.asdict(build_clip_config(point, sweep.extra_args, nband=2))
    jax_clip = dataclasses.asdict(jax_config.build_clip_config(
        jax_point, jax_sweep.extra_args, nband=2))
    assert sorted(clip) == sorted(jax_clip)
    for name in jax_clip:
        assert clip[name] == jax_clip[name], name

    trainer = dataclasses.asdict(build_trainer_config(point, sweep.extra_args))
    jax_trainer = dataclasses.asdict(jax_config.build_trainer_config(
        jax_point, jax_sweep.extra_args))
    # the one JAX field the port leaves out: nothing reads it
    assert set(jax_trainer) - set(trainer) == {"log_every_epochs"}
    assert set(trainer) <= set(jax_trainer)
    for name in trainer:
        assert trainer[name] == jax_trainer[name], name
        assert type(trainer[name]) is type(jax_trainer[name]), name


def test_new_modules_import_no_jax_and_no_yaml():
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                 "multimodal_supernovae_tpu")
    code = (
        "import sys, json\n"
        "import multimodal_supernovae_tpu_torch.config\n"
        "import multimodal_supernovae_tpu_torch.config.yaml_subset\n"
        "import multimodal_supernovae_tpu_torch.training.checkpoint\n"
        "import multimodal_supernovae_tpu_torch.utils.logging\n"
        "import multimodal_supernovae_tpu_torch.evaluation.embeddings\n"
        "import multimodal_supernovae_tpu_torch.models.factory\n"
        f"print(json.dumps(sorted(m for m in {forbidden!r} if m in sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
