"""Multi-GPU training's in-process parts (myrtle_vision_tpu_torch/parallel/,
the ``res_scale`` form of the block halves, the loader's process blocks)
against the JAX package, on the CPU.  The runs over several processes
are in tests/test_torch_multiprocess.py.

- Both block halves with ``res_scale`` 0.5 and 0.25 on one model rank's
  local heads and hidden columns: the port's plain chains against the JAX
  ``fused_attention_block`` / ``fused_mlp_block`` (Pallas in interpret
  mode), forward within 3e-5 and every gradient within 2e-4.
- ``fused_gate`` decides as the JAX gate does, over formats, dropout,
  divisibility, the training length, a distiller and ``MVT_NO_FUSE``.
- ``dist_config`` validation, and the (data, model) grid of ranks in
  ``make_mesh``'s device order; the data-parallel step over a gloo group
  of one equal to the step without a group, bit for bit.
- The loader's per-process blocks are the JAX loader's ``process_shard``
  blocks, for ``accum_steps`` 1 and 2, with its errors.
- The form each Block takes where the gate says no (it refused once), and
  the refusal of nccl with ``--device cpu``.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.data.loader import DataLoader as JaxLoader
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.models.vit import (
    vit_kwargs_from_config as jax_vit_kwargs,
)
from myrtle_vision_tpu.ops.fused_attention_block import (
    fused_attention_block as jax_attention,
)
from myrtle_vision_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from myrtle_vision_tpu.parallel import mesh as jax_mesh
from myrtle_vision_tpu.parallel import tp as jax_tp
from myrtle_vision_tpu_torch.classification import train as train_cli
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block_plain,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block_plain
from myrtle_vision_tpu_torch.parallel import mesh as port_mesh
from myrtle_vision_tpu_torch.parallel import tp as port_tp

C, LOCAL_HEADS, D, HID_LOCAL, B, N = 64, 1, 32, 64, 3, 17
CL = LOCAL_HEADS * D


# ------------------------------------------------------- res_scale halves

def local_inputs(op, seed):
    """fp32 numpy x, one model rank's parameters in the JAX (in, out)
    layout (wqkv (C, 3 cl), wp (cl, C); w1 (C, H/n), w2 (H/n, C)) and an
    upstream gradient."""
    rng = np.random.RandomState(seed)

    def r(*shape, std=1.0):
        return (rng.randn(*shape) * std).astype(np.float32)

    wide, narrow = (3 * CL, CL) if op == "attention" else (HID_LOCAL,
                                                          HID_LOCAL)
    return ([r(B, N, C, std=0.5), 1 + r(C, std=0.1), r(C, std=0.1),
             r(C, wide, std=0.1), r(wide, std=0.05), r(narrow, C, std=0.1),
             r(C, std=0.05)], r(B, N, C))


@pytest.mark.parametrize("res_scale", [0.5, 0.25])
@pytest.mark.parametrize("op", ["attention", "mlp"])
def test_res_scale_half_matches_jax(op, res_scale):
    args, g = local_inputs(op, seed=int(res_scale * 8) + len(op))
    if op == "attention":
        jfn = lambda *a: jax_attention(  # noqa: E731
            *a, LOCAL_HEADS, D ** -0.5, None, res_scale)
        pfn = lambda *a: fused_attention_block_plain(  # noqa: E731
            *a, LOCAL_HEADS, D ** -0.5, res_scale=res_scale)
    else:
        jfn = lambda *a: jax_mlp(*a, None, res_scale)  # noqa: E731
        pfn = lambda *a: fused_mlp_block_plain(  # noqa: E731
            *a, res_scale=res_scale)
    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    ref_grads = vjp(jnp.asarray(g))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    out = pfn(*tensors)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=3e-5, atol=3e-5)
    for t, r_, name in zip(tensors, ref_grads, range(len(args))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r_),
                                   rtol=2e-4, atol=2e-4, err_msg=str(name))


def test_res_scale_one_is_the_plain_residual():
    """res_scale 1 leaves every plain kernel's output as it was, bit for
    bit (the scale multiplies exactly)."""
    rng = np.random.RandomState(0)
    a, w, bias, res = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                       for s in ((6, 8), (8, 16), (16,), (6, 16)))
    assert torch.equal(
        K.gemm_bf16_epilogue_plain(a, w, bias, "bias_residual", res,
                                   res_scale=1.0),
        K.gemm_bf16_epilogue_plain(a, w, bias, "bias_residual", res))
    x, dxn, do = (torch.from_numpy(rng.randn(6, 16).astype(np.float32))
                  for _ in range(3))
    for t, u in zip(K.layernorm_rows_bwd_plain(x, bias, dxn, do,
                                               res_scale=1.0),
                    K.layernorm_rows_bwd_plain(x, bias, dxn, do)):
        assert torch.equal(t, u)


@pytest.mark.parametrize("bad,err", [("0.5", TypeError), (True, TypeError),
                                     (float("nan"), ValueError),
                                     (float("inf"), ValueError)])
def test_res_scale_refuses_what_is_not_a_finite_number(bad, err):
    args, _ = local_inputs("mlp", 0)
    with pytest.raises(err):
        fused_mlp_block_plain(*(torch.from_numpy(a) for a in args),
                              res_scale=bad)


@pytest.mark.parametrize("sections", [1, 3])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shards_are_the_jax_shards(sections, n_shards):
    """``shard_cols`` / ``shard_rows`` of a torch (out, in) weight are
    the transposes of the JAX ones of its (in, out) layout, every index;
    ``shard_cols`` of a bias is the JAX one."""
    rng = np.random.RandomState(sections + n_shards)
    w = rng.randn(12 * sections, 8).astype(np.float32)
    bias = rng.randn(12 * sections).astype(np.float32)
    for idx in range(n_shards):
        want = jax_tp.shard_cols(jnp.asarray(w.T), idx, n_shards, sections)
        got = port_tp.shard_cols(torch.from_numpy(w), idx, n_shards,
                                 sections)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
        np.testing.assert_array_equal(
            port_tp.shard_cols(torch.from_numpy(bias), idx, n_shards,
                               sections).numpy(),
            np.asarray(jax_tp.shard_cols(jnp.asarray(bias), idx, n_shards,
                                         sections)))
        want = jax_tp.shard_rows(jnp.asarray(w), idx, n_shards)
        got = port_tp.shard_rows(torch.from_numpy(w.T.copy()), idx,
                                 n_shards)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


# ------------------------------------------------------------ fused gate

def gate_config(**vit):
    config = {"vit_config": {"decoder": "classification", "image_size": 80,
                             "patch_size": 16, "embed_dim": 64, "depth": 1,
                             "heads": 2, "mlp_dim": 128, "dropout": 0.0,
                             "emb_dropout": 0.0, "q_format": "FP32"}}
    config["vit_config"].update(vit)
    return config


GATE_CASES = [
    ({}, 2, True, None), ({}, 1, True, None), ({}, 2, False, None),
    ({"q_format": "FP16_32"}, 2, True, None),
    ({"q_format": "PyTorchINT8"}, 2, True, None),
    ({"dropout": 0.1}, 2, True, None),
    ({"heads": 4, "embed_dim": 128}, 4, True, None),
    ({"heads": 3, "embed_dim": 96, "mlp_dim": 192}, 2, True, None),
    ({"mlp_dim": 130}, 2, True, None),
    ({"image_size": 640}, 2, True, None),
    ({"decoder": "detection", "num_det_tokens": 4}, 2, True, None),
    ({}, 2, True, "1"),
]


@pytest.mark.parametrize("vit,n_tp,extra_ok,no_fuse", GATE_CASES)
def test_fused_gate_decides_as_jax(vit, n_tp, extra_ok, no_fuse,
                                   monkeypatch):
    """The port's gate against the JAX trainer's, and where it holds the
    port's own Block gate at the training length agrees."""
    if no_fuse:
        monkeypatch.setenv("MVT_NO_FUSE", no_fuse)
    config = gate_config(**vit)
    data_config = {"number_of_classes": 5}
    jvit = JaxViT(**jax_vit_kwargs(config, data_config))
    fake_mesh = types.SimpleNamespace(devices=np.empty((1, n_tp)))
    want, _ = jax_tp.fused_gate(jvit, fake_mesh, extra_ok=extra_ok)
    pvit = ViT(**vit_kwargs_from_config(config, data_config))
    got = port_tp.fused_gate(pvit, n_tp, extra_ok=extra_ok)
    assert got == want
    if got:
        x = torch.zeros(1, port_tp.train_sequence(pvit), pvit.dim)
        assert pvit.transformer.layers[0].fuses(x)


# ------------------------------------------------------- mesh and config

@pytest.mark.parametrize("n,tp", [(8, 1), (8, 2), (8, 4), (4, 2), (2, 2),
                                  (6, 4)])
def test_rank_grid_is_make_mesh_order(n, tp):
    try:
        want = np.vectorize(lambda d: d.id)(
            jax_mesh.make_mesh(num_devices=n, tensor_parallel=tp).devices)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            port_mesh.rank_grid(n, tp)
        assert "not divisible" in str(e)
        return
    grid = port_mesh.rank_grid(n, tp)
    np.testing.assert_array_equal(grid, want)
    for rank in range(n):
        m = port_mesh.Mesh(rank=rank, world=n, tensor_parallel=tp)
        assert grid[m.data_index, m.model_index] == rank


def test_dist_config_is_validated_as_in_jax():
    good = {"dist_backend": "nccl", "dist_url": "tcp://localhost:54321",
            "group_name": "g", "tensor_parallel": 2}
    assert port_mesh.parse_dist_config(good) == {
        "backend": "nccl", "url": "tcp://localhost:54321",
        "tensor_parallel": 2}
    assert port_mesh.parse_dist_config(None)["tensor_parallel"] == 1
    bad = {**good, "world_size": 2}
    with pytest.raises(ValueError, match="unknown dist_config keys"):
        jax_mesh.mesh_from_dist_config(bad, num_devices=2)
    with pytest.raises(ValueError, match="unknown dist_config keys"):
        port_mesh.parse_dist_config(bad)
    with pytest.raises(ValueError, match="dist_backend"):
        port_mesh.parse_dist_config({"dist_backend": "mpi"})
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert port_mesh.backend_for({"backend": None}, cpu) == "gloo"
    assert port_mesh.backend_for({"backend": None}, cuda) == "nccl"
    assert port_mesh.backend_for({"backend": "gloo"}, cuda) == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        port_mesh.backend_for({"backend": "nccl"}, cpu)


def test_one_rank_has_no_groups():
    """Without a process group the mesh is one rank: no group, so the
    trainer wraps nothing; a tensor-parallel size above one refuses it,
    as make_mesh does on one device."""
    m = port_mesh.mesh_from_dist_config({"dist_backend": "nccl"})
    assert (m.world, m.data_group, m.model_group, m.distributed) == (
        1, None, None, False)
    with pytest.raises(ValueError, match="not divisible"):
        port_mesh.mesh_from_dist_config({"tensor_parallel": 2})


def test_one_rank_ddp_step_is_the_plain_step():
    """The trainer's data-parallel step over a gloo group of one (DDP,
    the first of two micro-batches under ``no_sync``) equals the step
    without a group bit for bit, in every parameter after two AdamW
    steps: the classifier's detection tokens, which DDP leaves out and
    weight decay alone moves, included."""
    import datetime

    import torch.distributed as dist

    from myrtle_vision_tpu_torch.parallel.launch import free_port
    from myrtle_vision_tpu_torch.training.classification import (
        make_loss_fn,
    )
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        data_parallel,
        make_train_step,
    )

    tc = {"optimizer": "adamw", "opt_eps": 1e-8, "weight_decay": 0.05,
          "lr": 1e-3}
    rng = np.random.RandomState(3)
    batches = [{"image": torch.from_numpy(rng.randn(2, 2, 40, 40, 3)
                                          .astype(np.float32)),
                "label": torch.from_numpy(rng.randint(0, 5, (2, 2)))}
               for _ in range(2)]
    init = ViT("classification", 40, 8, 5, C, 2, 2, 128, dim_head=D,
               compute_dtype=torch.float32).state_dict()

    def run(mesh):
        model = ViT("classification", 40, 8, 5, C, 2, 2, 128, dim_head=D,
                    compute_dtype=torch.float32)
        model.load_state_dict(init)
        module = data_parallel(model, mesh)
        state = TrainState(model, create_optimizer(tc, model))
        step = make_train_step(make_loss_fn(module), 2, mesh=mesh,
                               module=module)
        losses = [float(step(state, b, tc["lr"])["loss"]) for b in batches]
        return type(module).__name__, losses, dict(model.named_parameters())

    _, plain_losses, plain = run(None)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        wrapper, losses, params = run(
            port_mesh.Mesh(data_group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    assert wrapper == "DataParallel" and losses == plain_losses
    for name, p in plain.items():
        assert torch.equal(params[name], p), name
    assert not torch.equal(params["det_tokens"], init["det_tokens"])


# ------------------------------------------------------------ the loader

class Indices:
    """A dataset whose item is its own index."""

    def __len__(self):
        return 37

    def __getitem__(self, idx, rng=None):
        return {"i": np.asarray(idx, np.int64)}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("pcount", [2, 4])
def test_process_blocks_are_the_jax_loader_blocks(accum, pcount):
    batch = 8
    for pid in range(pcount):
        kw = dict(batch_size=batch, shuffle=True, seed=3, drop_last=True,
                  process_shard=(pid, pcount), accum_steps=accum)
        for epoch in (0, 1):
            want = [b["i"].tolist() for b in
                    JaxLoader(Indices(), **kw).epoch(epoch)]
            got = [b["i"].tolist() for b in
                   DataLoader(Indices(), device="cpu", **kw).epoch(epoch)]
            assert got == want and len(got) == 37 // batch
            assert all(len(b) == batch // pcount for b in got)


@pytest.mark.parametrize("kw,match", [
    (dict(drop_last=False), "requires drop_last"),
    (dict(pad_last=True), "pad_last is incompatible"),
    (dict(accum_steps=3), "must split"),
    (dict(batch_size=6, accum_steps=2), "must split"),
])
def test_process_shard_errors_are_the_jax_loader_errors(kw, match):
    kw = {"batch_size": 8, "process_shard": (0, 2), **kw}
    with pytest.raises(ValueError, match=match):
        JaxLoader(Indices(), **kw)
    with pytest.raises(ValueError, match=match):
        DataLoader(Indices(), device="cpu", **kw)


# ------------------------------------------------------------- refusals

def test_tensor_parallel_past_the_gate_raises():
    """Where fused_gate says no, a model group of two no longer refuses the
    model (the JAX GSPMD form, parallel/tp.py): each Block takes the form
    that what it would run alone gives.  A quantized format's fusing
    Block (FP16_32) runs whole on every rank; an FP32 model passes the
    gate, its fusing Blocks head-sharded, and under MVT_NO_FUSE=1 its
    discrete Blocks split; with 3 heads over 2 ranks a discrete Block
    runs whole.  (The name is the refusal this test held before.)"""
    mesh = port_mesh.Mesh(rank=0, world=2, tensor_parallel=2,
                          model_group=object())
    data_config = {"number_of_classes": 5}
    x = torch.zeros(1, 26, 64)
    vit = ViT(**vit_kwargs_from_config(gate_config(q_format="FP16_32"),
                                       data_config))
    assert port_tp.setup_tensor_parallel(vit, mesh)
    block = vit.transformer.layers[0]
    assert not block.tp.fused and block.fuses(x)
    assert block.tp_form(block.fuses(x)) == "whole"
    vit = ViT(**vit_kwargs_from_config(gate_config(), data_config))
    assert port_tp.setup_tensor_parallel(vit, mesh)
    block = vit.transformer.layers[0]
    assert block.tp.size == 2 and block.tp.index == 0 and block.tp.fused
    assert block.tp_form(block.fuses(x)) == "sharded"
    os.environ["MVT_NO_FUSE"] = "1"
    try:
        assert not block.fuses(x)
        assert block.tp_form(block.fuses(x)) == "split"
        vit = ViT(**vit_kwargs_from_config(
            gate_config(heads=3, embed_dim=96, mlp_dim=192), data_config))
        port_tp.setup_tensor_parallel(vit, mesh)
        assert vit.transformer.layers[0].tp_form(False) == "whole"
    finally:
        del os.environ["MVT_NO_FUSE"]


def test_nccl_on_the_cpu_raises(tmp_path, monkeypatch):
    """A rank launched with --device cpu under a dist_config naming nccl
    refuses before it joins any group: nothing switches backend."""
    config = {"train_config": {"output_directory": str(tmp_path / "o")},
              "dist_config": {"dist_backend": "nccl",
                              "dist_url": "tcp://localhost:54321"}}
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(config))
    monkeypatch.setenv("MVT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MVT_NUM_PROCESSES", "2")
    monkeypatch.setenv("MVT_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="nccl"):
        train_cli.main(["-c", str(cfg), "--device", "cpu"])
    assert not torch.distributed.is_initialized()
