"""The port's data axis (parallel/) on the CPU: the sharded CLIP and SigLIP
losses on 2 gloo ranks against the global loss (the port's and the JAX
package's), each rank's gradients against the global ones, the autograd
all-gather and all-reduce, and the process-group and CLI glue without a
cluster. The ranks are subprocesses of tests/torch_dp_worker.py (no jax),
each with a timeout, rendezvous through a FileStore.

Tolerances: float32 1e-6 (one loss, summed in another order)."""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from multimodal_supernovae_tpu.ops.losses import clip_loss_multimodal as jax_clip_loss
from multimodal_supernovae_tpu.ops.losses import sigmoid_loss_multimodal as jax_sigmoid_loss
from multimodal_supernovae_tpu_torch.ops import losses as L
from multimodal_supernovae_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    add_mesh_args,
    initialize_distributed,
    make_mesh,
    mesh_from_args,
)

RANKS = 2
SCALE, BIAS = [2.0, 1.5, 2.5], -1.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    W.spawn(out, ["losses", "autograd"], world=RANKS)
    return {name: [W.load(out, name, r) for r in range(RANKS)]
            for name in ("losses", "autograd")}


def _global(kind):
    """The one-process loss and gradients of the global batch."""
    embs = [e.clone().requires_grad_(True) for e in W.global_embeddings()]
    scale = torch.tensor(SCALE, requires_grad=True)
    bias = torch.tensor(BIAS, requires_grad=True)
    fn = {"clip": L.clip_loss_multimodal, "sigmoid": L.sigmoid_loss_multimodal}[kind]
    loss = fn(embs, scale, bias)
    loss.backward()
    return loss.item(), [e.grad for e in embs], scale.grad, bias.grad


@pytest.mark.parametrize("kind", ["clip", "sigmoid"])
def test_sharded_loss_equals_the_global_loss(ranks, kind):
    want, _, _, _ = _global(kind)
    jax_fn = {"clip": jax_clip_loss, "sigmoid": jax_sigmoid_loss}[kind]
    jax_want = float(jax_fn([jnp.asarray(e.numpy()) for e in W.global_embeddings()],
                            jnp.asarray(SCALE), jnp.float32(BIAS)))
    for r in range(RANKS):
        got = ranks["losses"][r][kind]["loss"]
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
        assert got == pytest.approx(jax_want, rel=1e-5)


@pytest.mark.parametrize("kind", ["clip", "sigmoid"])
def test_each_rank_gets_its_rows_of_the_global_gradient(ranks, kind):
    """Every rank computes the same global loss, so the gather's backward
    hands each rank n times its rows of the global embedding gradient (the
    mean over ranks brings a tower back to 1x); the logit scale and bias,
    used after the gather, get the global gradient on every rank."""
    _, grads, scale_grad, bias_grad = _global(kind)
    for r in range(RANKS):
        got = ranks["losses"][r][kind]
        rows = slice(r * W.GLOBAL_B // RANKS, (r + 1) * W.GLOBAL_B // RANKS)
        for g, want in zip(got["grads"], grads):
            torch.testing.assert_close(g / RANKS, want[rows], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["scale"], scale_grad, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["bias"], bias_grad, rtol=1e-5, atol=1e-6)


def test_averaged_tower_gradient_equals_the_one_process_gradient(ranks):
    torch.manual_seed(0)
    tower = torch.nn.Linear(W.DIM, W.DIM)
    x = W.global_embeddings(2)
    L.clip_loss_multimodal([tower(x[0]), x[1]], torch.tensor(2.0),
                           torch.tensor(-1.0)).backward()
    for r in range(RANKS):
        for name, p in tower.named_parameters():
            torch.testing.assert_close(ranks["losses"][r]["tower"][name], p.grad,
                                       rtol=1e-5, atol=1e-6)


def test_autograd_all_gather_and_all_reduce(ranks):
    """all_gather: the ranks' rows in rank order; its backward all-reduces
    the gathered gradient and keeps this rank's rows. all_reduce: the sum;
    its backward the sum of the ranks' gradients."""
    b = W.GLOBAL_B // RANKS
    w = torch.arange(W.GLOBAL_B * 2, dtype=torch.float32).reshape(W.GLOBAL_B, 2)
    xs = [torch.arange(b * 2, dtype=torch.float32).reshape(-1, 2) + 100.0 * r
          for r in range(RANKS)]
    for r in range(RANKS):
        got = ranks["autograd"][r]
        rows = slice(r * b, (r + 1) * b)
        torch.testing.assert_close(got["gathered"], torch.cat(xs))
        torch.testing.assert_close(got["gather_grad"], RANKS * w[rows])
        torch.testing.assert_close(got["reduced"], sum(xs))
        torch.testing.assert_close(got["reduce_grad"],
                                   sum(w[q * b:(q + 1) * b] for q in range(RANKS)))
        assert got["labels"].tolist() == [0, 7, 1, 7]


CLUSTER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "MMSN_COORDINATOR", "MMSN_NUM_PROCESSES", "MMSN_PROCESS_ID")


@pytest.fixture
def no_cluster(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)


def test_initialize_noop_without_cluster_env(no_cluster):
    assert initialize_distributed() is False
    assert initialize_distributed(device="cpu") is False


def test_initialize_needs_the_whole_address(no_cluster, monkeypatch):
    monkeypatch.setenv("MMSN_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="process count"):
        initialize_distributed(device="cpu")


def _args(*argv):
    ap = argparse.ArgumentParser()
    add_mesh_args(ap)
    return ap.parse_args(list(argv))


def test_mesh_from_args_cli_glue(no_cluster, monkeypatch):
    assert mesh_from_args(_args(), device="cpu") is None
    mesh = mesh_from_args(_args("--mesh"), device="cpu")
    assert isinstance(mesh, DataMesh) and mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert mesh.group is None and mesh.is_main and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="1 global devices not divisible by model=2"):
        mesh_from_args(_args("--tp", "2"), device="cpu")  # a model axis of 2 over 1 process
    # one process that sees several cards: --mesh must come from torchrun
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_from_args(_args("--mesh"), device="cuda")


def test_mesh_shape_rows_and_refusals():
    mesh = DataMesh(1, 4)
    assert mesh.local(32) == 8 and mesh.block(32) == slice(8, 16) and not mesh.is_main
    with pytest.raises(ValueError, match="not divisible by the data mesh axis"):
        mesh.local(30)
    with pytest.raises(ValueError, match="1 devices not divisible by model axis 2"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(n_data=2)
    assert make_mesh().size == 1
    x = torch.ones(3, 2)  # without a process group, every collective is the identity
    assert make_mesh().all_gather(x) is x and make_mesh().all_reduce(x) is x
