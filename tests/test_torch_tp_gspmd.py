"""Tensor parallelism where the fused gate refuses (parallel/tp.py's
"split" and "whole" forms, the results of the JAX trainer's GSPMD
branch), on the CPU: two ranks of the port over gloo, one model group
(tests/torch_multiprocess_worker.py, launched as tests/
test_torch_multiprocess.py launches it), 3 steps of 2 micro-batches of 8
on tests/test_tensor_parallel.py's model (80 px, dim 128, depth 2, 2
heads, MLP 256, 5 classes), at that file's bars: the losses rtol 1e-4,
the held-out loss of the trained parameters rtol 5e-4; both ranks alike
(within 1e-6); and the first step's gradients, summed over the group,
within 1e-4 of each parameter's largest against the port's one process
(AdamW hides a gradient counted twice from the losses).

- Against the JAX GSPMD step on ``make_mesh(num_devices=2,
  tensor_parallel=2)`` with ``tp_fused`` False: FP32 under
  ``MVT_NO_FUSE=1`` (every Block split: Megatron's column and row
  products, the partial sums reduced over the group), FP16_32 (every
  Block fuses, and runs whole on each rank; micro-batches of 4, as the
  JAX step runs its Pallas kernels in interpret mode) and PyTorchINT8
  two-pass QAT (pass 1 split, its observers of the split activations
  reduced over the group before they snap; pass 2 whole), one step of
  one micro-batch of 8 there, held as tests/test_torch_multiprocess.py's
  ``test_int8_observers_reduce_as_jax`` holds its step: the observers up
  to the first snapped product's output within 1e-5 of the JAX step's,
  every observer within 1e-5 of the port's one process, the loss within
  1e-4 of the JAX loss op by op from the same observers.
- Against the port's one process on the same generator: dropout 0.1
  (split: each rank draws the whole mask and keeps its columns), 3 heads
  at n_tp 2 (whole) and an FP32 distilled student (whole: a distiller
  refuses the fused gate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.parallel.mesh import make_mesh
from myrtle_vision_tpu.quantize import QFormat as JaxQFormat
from myrtle_vision_tpu.training import optim as jax_optim
from myrtle_vision_tpu.training.classification import (
    make_loss_fn as jax_loss_fn,
)
from myrtle_vision_tpu.training.trainer import (
    init_train_state,
    make_train_step,
    state_shardings,
)
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

import torch_multiprocess_worker as worker
from test_torch_int8_long import EARLY_SITES
from test_torch_multiprocess import TRAIN_CONFIG, batches_of, run_worker

MODEL = {"decoder": "classification", "image_size": 80, "patch_size": 16,
         "num_classes": 5, "dim": 128, "depth": 2, "heads": 2,
         "mlp_dim": 256, "dim_head": 64}
STEPS, N_ACCUM, MICRO = 3, 2, 8


def jax_gspmd_train(q_format, batches, eval_batch, n_accum=N_ACCUM):
    """The JAX step's GSPMD branch (``tp_fused`` False) on two devices,
    data 1 x model 2, from PRNGKey(0): (the initial params and quant, the
    losses, the held-out loss, the final quant)."""
    mesh = make_mesh(num_devices=2, tensor_parallel=2)
    model = JaxViT(**MODEL, q_format=JaxQFormat[q_format], dtype=jnp.float32)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    state = init_train_state(model, tx, jax.random.PRNGKey(0),
                             jnp.zeros((1, 80, 80, 3)), mesh=mesh)
    init = jax.tree_util.tree_map(np.asarray, (state.params, state.quant))
    shard = {k: NamedSharding(mesh, P(None, "data"))
             for k in ("image", "label")}
    step = make_train_step(
        jax_loss_fn(model), tx, n_accum, mesh=mesh,
        state_sharding=state_shardings(state, mesh),
        batch_sharding=shard)
    losses = []
    for i, (img, lab) in enumerate(zip(batches["image"], batches["label"])):
        batch = jax.device_put({"image": jnp.asarray(img),
                                "label": jnp.asarray(lab)}, shard)
        state, metrics = step(state, batch, TRAIN_CONFIG["lr"],
                              jax.random.PRNGKey(100 + i))
        losses.append(float(metrics["loss"]))
    quant = jax.device_get(state.quant)
    held_out, _ = jax_loss_fn(model)(
        jax.device_get(state.params), quant,
        {"image": jnp.asarray(eval_batch[0]),
         "label": jnp.asarray(eval_batch[1])}, jax.random.PRNGKey(0))
    return init, losses, float(held_out), quant


def save_inputs(tmp_path, state_dict, batches, eval_batch):
    torch.save(state_dict, tmp_path / "init.pt")
    np.savez(tmp_path / "batches.npz", **batches, eval_image=eval_batch[0],
             eval_label=eval_batch[1])


def spec_of(vit, tensor_parallel, n_accum=N_ACCUM, **extra):
    return {"vit": vit, "tensor_parallel": tensor_parallel,
            "n_accum": n_accum, "train_config": TRAIN_CONFIG,
            "lr": TRAIN_CONFIG["lr"], "grads": True, **extra}


def jax_int8_loss(params, quant, observers, images, labels):
    """The JAX package's INT8 loss on ``images``, op by op, from the
    port's observers after the step: the JAX calibrating forward, whose
    re-update of observers that already hold the batch changes nothing
    (the JAX two-pass step's pass 2; as tests/test_torch_multiprocess.py's
    ``jax_loss_from``)."""
    q = jax.tree_util.tree_map(np.array, quant)
    for path, name in quant_site_names(MODEL["depth"]):
        node = q
        for key in path:
            node = node[key]
        for k in ("min", "max"):
            node[k] = np.float32(observers[f"{name}.{k}"])
    model = JaxViT(**MODEL, q_format=JaxQFormat.PyTorchINT8,
                   dtype=jnp.float32)
    logits, _ = model.apply({"params": params, "quant": q},
                            jnp.asarray(images), calibrating=True,
                            mutable=["quant"], deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
    return float(-logp[np.arange(len(labels)), labels].mean())


def one_process(tmp_path, spec):
    """The worker's train task in this process, without a process group
    (one rank: every Block alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return worker.train_task(tmp_path, 0, {**spec, "tensor_parallel": 1})
    finally:
        torch.set_num_threads(threads)


def check_gradients(tmp_path):
    """Rank 0's first-step gradients, every rank's part summed over the
    group, against the one process's, each parameter within 1e-4 of its
    largest magnitude: a part counted twice (a whole Block's gradient, or
    a bias added after the reduction, not scaled by 1/n_tp) or left out
    shows, which the losses alone would not show (AdamW's step does not
    see a gradient's scale)."""
    got = torch.load(tmp_path / "grads_tp2_rank0.pt", weights_only=True)
    ref = torch.load(tmp_path / "grads_tp1_rank0.pt", weights_only=True)
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = max(float(r.abs().max()), 1e-12)
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def check_ranks(outs, losses, held_out, what):
    print(f"{what}: losses port {outs[0]['losses']}, reference {losses}; "
          f"held out port {outs[0]['held_out']}, reference {held_out}")
    # alike: a Block that runs whole computes its forward on each rank
    # apart, so the CPU's own run-to-run noise may show between them
    for key in ("losses", "held_out"):
        np.testing.assert_allclose(outs[1][key], outs[0][key], rtol=1e-6)
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(outs[0]["held_out"], held_out, rtol=5e-4)


@pytest.mark.parametrize("case", ["FP32-MVT_NO_FUSE", "FP16_32",
                                  "PyTorchINT8"])
def test_tensor_parallel_matches_jax_gspmd(case, tmp_path, monkeypatch):
    """Two ranks of one model group against the JAX GSPMD step (the module
    docstring); FP16_32 at micro-batches of 4.  PyTorchINT8: one step of
    one micro-batch of 8 (a jitted
    JAX INT8 step and the port part by a rint flip that later steps
    compound, ROADMAP C6, in one process as here), held as
    ``test_int8_observers_reduce_as_jax`` holds it: the observers up to
    the first snapped product's output against the JAX step's, every
    observer against the port's one process (whose pass 1 sees the whole
    tensors), the loss against the JAX loss op by op from the same
    observers, and the losses against the one process."""
    q_format = case.split("-")[0]
    if case.endswith("MVT_NO_FUSE"):
        # read by the JAX Block as it traces, and by the ranks' Blocks
        monkeypatch.setenv("MVT_NO_FUSE", "1")
    int8 = q_format == "PyTorchINT8"
    # FP16_32's fused Blocks run the Pallas kernels in interpret mode in
    # the JAX step: 4 images a micro-batch keep its time
    steps, n_accum, micro = ((1, 1, MICRO) if int8 else
                             (STEPS, N_ACCUM, MICRO // 2)
                             if q_format == "FP16_32" else
                             (STEPS, N_ACCUM, MICRO))
    batches, eval_batch = batches_of(steps, n_accum, micro, seed=1)
    init, losses, held_out, quant = jax_gspmd_train(q_format, batches,
                                                    eval_batch, n_accum)
    params, quant0 = init
    save_inputs(tmp_path, state_dict_from_jax(
        params, quant=quant0 if quant0 else None), batches, eval_batch)
    spec = spec_of({**MODEL, "q_format": q_format}, 2, n_accum,
                   observers=int8)
    alone = one_process(tmp_path, spec)
    outs = run_worker("train", tmp_path, spec)
    check_gradients(tmp_path)
    if not int8:
        check_ranks(outs, losses, held_out, case)
        return
    print(f"{case}: the jitted JAX GSPMD step's loss {losses}, held out "
          f"{held_out}")
    check_ranks(outs, alone["losses"], alone["held_out"], case)
    ref = state_dict_from_jax(params, quant=quant)
    got = outs[0]["observers"]
    assert set(got) == set(alone["observers"]) == {
        k for k in ref if k.endswith((".min", ".max"))}
    for name, value in got.items():
        np.testing.assert_allclose(value, alone["observers"][name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        if name.rsplit(".", 1)[0] in EARLY_SITES:
            np.testing.assert_allclose(value, float(ref[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    jax_loss = jax_int8_loss(params, quant0, got, batches["image"][0][0],
                             batches["label"][0][0])
    print(f"{case}: loss port {outs[0]['losses'][0]}, JAX op by op from "
          f"the same observers {jax_loss}")
    np.testing.assert_allclose(outs[0]["losses"][0], jax_loss, rtol=1e-4)


def port_init(vit):
    """A fresh port model's state dict (the JAX initialisers, seed 0)."""
    model = ViT(**vit, compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    return model.state_dict()


@pytest.mark.parametrize("case", ["dropout", "three-heads", "distill"])
def test_tensor_parallel_matches_one_process(case, tmp_path):
    """Two ranks of one model group against the port's one process, the
    same steps from the same parameters and generator: active dropout
    (split), 3 heads at n_tp 2 (whole) and an FP32 distilled student
    (whole)."""
    vit, extra = dict(MODEL), {}
    if case == "dropout":
        vit["dropout"] = 0.1
        extra["seed"] = 5
    elif case == "three-heads":
        vit.update(dim=96, heads=3, dim_head=32)
    else:
        extra["distill"] = True
    batches, eval_batch = batches_of(STEPS, N_ACCUM, MICRO, seed=2)
    save_inputs(tmp_path, port_init(vit), batches, eval_batch)
    spec = spec_of(vit, 2, **extra)
    alone = one_process(tmp_path, spec)
    outs = run_worker("train", tmp_path, spec)
    check_gradients(tmp_path)
    check_ranks(outs, alone["losses"], alone["held_out"], case)
