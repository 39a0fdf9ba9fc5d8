"""Multi-GPU training's runs over several processes, on the CPU: two ranks
of the port over gloo (tests/torch_multiprocess_worker.py, or the train
CLI itself), each launched as a user launches one rank (MVT_COORDINATOR,
MVT_NUM_PROCESSES, MVT_PROCESS_ID) on a free port, each waited for with
its own timeout and killed past it, against the JAX package on two
virtual devices.

- ``reduce_dict`` / ``all_gather_host`` / ``merge_coco_evaluators`` over
  the two ranks;
- the classification train CLI on two data ranks against the JAX CLI on
  two devices, from one checkpoint: the per-step losses;
- tensor parallelism over two ranks against the JAX ``tp_fused`` path on
  ``make_mesh(num_devices=2, tensor_parallel=2)``, at the bars of
  tests/test_tensor_parallel.py (losses rtol 1e-4, the held-out loss of
  the trained parameters 5e-4);
- detection's ``num_boxes`` averaged over two ranks with unequal box
  counts against the JAX criterion's ``axis_name`` branch under
  ``shard_map``;
- a PyTorchINT8 QAT step's observers, MIN / MAX over the data ranks of
  each rank's own, those before any snapped product's output against the
  JAX step's ``pmin`` / ``pmax`` on two devices, and its loss against the
  JAX loss op by op from the same observers.
"""
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from myrtle_vision_tpu.models.detector import criterion as jax_criterion
from myrtle_vision_tpu.models.vit import ViT as JaxViT
from myrtle_vision_tpu.models.vit import (
    vit_kwargs_from_config as jax_vit_kwargs,
)
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
from myrtle_vision_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.training import optim
from myrtle_vision_tpu_torch.training.classification import (
    make_loss_fn as make_port_loss_fn,
)
from myrtle_vision_tpu_torch.training.trainer import TrainState
from myrtle_vision_tpu_torch.utils.checkpoint import save_checkpoint
from myrtle_vision_tpu_torch.utils.convert import (
    quant_site_names,
    state_dict_from_jax,
)

from test_torch_int8_long import EARLY_SITES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")
RANKS = 2
TIMEOUT_S = 120
TRAIN_CONFIG = {"optimizer": "adamw", "opt_eps": 1e-8, "opt_betas": None,
                "clip_grad": None, "momentum": 0.9, "weight_decay": 0.05,
                "lr": 1e-3}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cmd, cwd, extra_env=None):
    """Start ``cmd`` as each of the two ranks, wait for each with its own
    timeout, kill every rank past it; each rank's output."""
    port = free_port()
    procs = []
    for rank in range(RANKS):
        env = {**os.environ, "PYTHONPATH": REPO,
               "MVT_COORDINATOR": f"localhost:{port}",
               "MVT_NUM_PROCESSES": str(RANKS),
               "MVT_PROCESS_ID": str(rank), "MVT_DIST_TIMEOUT": "60",
               "OMP_NUM_THREADS": "2",
               **(extra_env or {})}
        procs.append(subprocess.Popen(
            cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return outs


def run_worker(task, work, spec):
    (work / "spec.json").write_text(json.dumps(spec))
    run_ranks([sys.executable, WORKER, task, str(work)], REPO)
    return [json.loads((work / f"out{r}.json").read_text())
            for r in range(RANKS)]


def test_reduce_dict_and_all_gather_host(tmp_path):
    outs = run_worker("collectives", tmp_path, {})
    for rank, out in enumerate(outs):
        assert out["reduce"] == {"a": 5.0, "b": 1.5}
        assert out["sum"] == {"a": 3.0}
        assert out["gather"] == [{"rank": r, "payload": "x" * (100 * r)}
                                 for r in range(RANKS)]
        assert out["main"] == (rank == 0) and out["count"] == RANKS
        assert out["merged"] == {"10": [0], "11": [1]}


# ----------------------------------------------------------- train steps

VIT = {"decoder": "classification", "image_size": 80, "patch_size": 16,
       "num_classes": 5, "dim": 64, "depth": 1, "heads": 2, "mlp_dim": 128,
       "dim_head": 32}


def jax_train(q_format, mesh, tp_fused, batches, eval_batch, n_accum):
    """The JAX step on ``mesh`` over ``batches``, from PRNGKey(0): (the
    initial state, the losses, the held-out loss of the trained
    parameters, the final state)."""
    model = JaxViT(**VIT, q_format=JaxQFormat[q_format], dtype=jnp.float32,
                   tp_axis="model" if tp_fused else None)
    tx = jax_optim.create_optimizer(TRAIN_CONFIG)
    state = init_train_state(model.clone(tp_axis=None), tx,
                             jax.random.PRNGKey(0),
                             jnp.zeros((1, 80, 80, 3)), mesh=mesh,
                             tp_fused=tp_fused)
    init = jax.tree_util.tree_map(np.asarray, (state.params, state.quant))
    shard = {k: NamedSharding(mesh, P(None, "data"))
             for k in ("image", "label")}
    step = make_train_step(
        jax_loss_fn(model), tx, n_accum, mesh=mesh,
        state_sharding=state_shardings(state, mesh, tp_fused=tp_fused),
        batch_sharding=shard, tp_fused=tp_fused)
    losses = []
    for i, (img, lab) in enumerate(zip(batches["image"], batches["label"])):
        batch = jax.device_put({"image": jnp.asarray(img),
                                "label": jnp.asarray(lab)}, shard)
        state, metrics = step(state, batch, TRAIN_CONFIG["lr"],
                              jax.random.PRNGKey(100 + i))
        losses.append(float(metrics["loss"]))
    params = jax.device_get(state.params)
    quant = jax.device_get(state.quant)
    held_out, _ = jax_loss_fn(model.clone(tp_axis=None))(
        params, quant, {"image": jnp.asarray(eval_batch[0]),
                        "label": jnp.asarray(eval_batch[1])},
        jax.random.PRNGKey(0))
    return init, losses, float(held_out), quant


def batches_of(steps, n_accum, micro, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(steps, n_accum, micro, 80, 80, 3).astype(np.float32)
    lab = rng.randint(0, 5, (steps, n_accum, micro)).astype(np.int32)
    return ({"image": img, "label": lab},
            (rng.randn(8, 80, 80, 3).astype(np.float32),
             rng.randint(0, 5, 8).astype(np.int32)))


def port_run(tmp_path, init, q_format, tensor_parallel, batches, eval_batch,
             n_accum, observers=False):
    params, quant = init
    sd = state_dict_from_jax(params, quant=quant if quant else None)
    torch.save(sd, tmp_path / "init.pt")
    np.savez(tmp_path / "batches.npz", **batches, eval_image=eval_batch[0],
             eval_label=eval_batch[1])
    return run_worker("train", tmp_path, {
        "vit": {**VIT, "q_format": q_format},
        "tensor_parallel": tensor_parallel, "n_accum": n_accum,
        "train_config": TRAIN_CONFIG, "lr": TRAIN_CONFIG["lr"],
        "observers": observers})


def test_tensor_parallel_matches_jax_tp_fused(tmp_path):
    """2-way head-sharded tensor parallelism, 2 steps of 2 micro-batches
    of 4, fp32 compute: the port's two ranks against the JAX tp_fused
    step on make_mesh(num_devices=2, tensor_parallel=2), losses rtol 1e-4
    and the held-out loss of the trained parameters rtol 5e-4
    (tests/test_tensor_parallel.py:113-125); both ranks alike."""
    mesh = make_mesh(num_devices=2, tensor_parallel=2)
    batches, eval_batch = batches_of(2, 2, 4)
    init, losses, held_out, _ = jax_train("FP32", mesh, True, batches,
                                          eval_batch, 2)
    outs = port_run(tmp_path, init, "FP32", 2, batches, eval_batch, 2)
    print(f"losses: port {outs[0]['losses']}, JAX {losses}; held out: "
          f"port {outs[0]['held_out']}, JAX {held_out}")
    assert outs[0] == outs[1]
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(outs[0]["held_out"], held_out, rtol=5e-4)


# The observers of layer 0's attention half up to its first snapped
# product's output: every one of them sees values that no INT8 snap of an
# earlier product has moved (tests/test_torch_int8_long.py's EARLY_SITES).
# Past it, a product element that the two packages' fp32 sums put on
# either side of a rint edge moves the context a grid step, and every
# later observer with it (ROADMAP C6): on rank 1's images an element of
# layer 0's to_qkv output lies on a rint tie in fp32 (x = -0.60584605, s
# = 0.015736261), so which way it rounds depends on the sum order of the
# host's BLAS; a host where it went the other way read layer 0's
# to_out.0.act_out.min 1.2e-3 apart from the JAX step.
SHARED_SITES = EARLY_SITES


def port_half_steps(init, batches):
    """Each rank's share of the step in this process, as the rank runs it
    (two threads, the two-pass loss on its 2 images from the initial
    state): [(loss, {observer: value})] by rank."""
    params, quant = init
    sd = state_dict_from_jax(params, quant=quant)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = []
        for r in range(RANKS):
            model = ViT(**VIT, q_format="PyTorchINT8",
                        compute_dtype=torch.float32)
            model.load_state_dict(sd, strict=True)
            model.train()
            block = slice(2 * r, 2 * r + 2)
            loss, _ = make_port_loss_fn(model)({
                "image": torch.from_numpy(batches["image"][0][0][block]),
                "label": torch.from_numpy(batches["label"][0][0][block])})
            out.append((float(loss.detach()),
                        {k: float(v) for k, v in model.state_dict().items()
                         if k.endswith((".min", ".max"))}))
    finally:
        torch.set_num_threads(threads)
    return out


def jax_loss_from(init, batches, r, observers):
    """The JAX package's INT8 loss on rank r's images, op by op, from the
    port's observers after that rank's calibrating pass: the JAX
    calibrating forward, whose re-update of observers that already hold
    the batch changes nothing (the JAX two-pass step's pass 2)."""
    params, quant = init
    q = jax.tree_util.tree_map(np.array, quant)
    for path, name in quant_site_names(VIT["depth"]):
        node = q
        for key in path:
            node = node[key]
        for k in ("min", "max"):
            node[k] = np.float32(observers[f"{name}.{k}"])
    model = JaxViT(**VIT, q_format=JaxQFormat.PyTorchINT8, dtype=jnp.float32)
    block = slice(2 * r, 2 * r + 2)
    logits, _ = model.apply({"params": params, "quant": q},
                            jnp.asarray(batches["image"][0][0][block]),
                            calibrating=True, mutable=["quant"],
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
    labels = batches["label"][0][0][block]
    return float(-logp[np.arange(len(labels)), labels].mean())


def test_int8_observers_reduce_as_jax(tmp_path):
    """One PyTorchINT8 QAT step on two data ranks (a micro-batch of 2
    each): every observer's min and max after the step is the MIN / MAX
    over the ranks of each rank's own, the same step run in this process
    on the rank's images (within 1e-5); the observers up to the first
    snapped product's output (SHARED_SITES) against the JAX step's pmin
    / pmax on two devices (within 1e-5, as the observers of
    tests/test_torch_int8_qat.py), the later ones printed (ROADMAP C6: a
    jitted JAX INT8 step is held op by op, from observers both packages
    share); the step's loss, the mean of the ranks' losses, within 1e-4
    of the JAX loss computed op by op from each rank's observers."""
    mesh = make_mesh(num_devices=2)
    batches, eval_batch = batches_of(1, 1, 4, seed=3)
    init, losses, _, quant = jax_train("PyTorchINT8", mesh, False, batches,
                                       eval_batch, 1)
    outs = port_run(tmp_path, init, "PyTorchINT8", 1, batches, eval_batch,
                    1, observers=True)
    assert outs[0]["observers"] == outs[1]["observers"]
    ref = state_dict_from_jax(init[0], quant=quant)
    got = outs[0]["observers"]
    assert set(got) == {k for k in ref if k.endswith((".min", ".max"))}
    halves = port_half_steps(init, batches)
    for name, value in got.items():
        reduce = min if name.endswith(".min") else max
        np.testing.assert_allclose(value, reduce(h[name] for _, h in halves),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        if name.rsplit(".", 1)[0] in SHARED_SITES:
            np.testing.assert_allclose(value, float(ref[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            print(f"{name}: port {value!r}, JAX step {float(ref[name])!r}")
    loss = outs[0]["losses"][0]
    np.testing.assert_allclose(loss, np.mean([h[0] for h in halves]),
                               rtol=1e-6)
    jax_loss = np.mean([jax_loss_from(init, batches, r, halves[r][1])
                        for r in range(RANKS)])
    print(f"loss: port {loss!r}, JAX from the same observers {jax_loss!r}, "
          f"the jitted JAX step {losses[0]!r}")
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)


# ------------------------------------------------------------- num_boxes

def test_num_boxes_averages_over_the_ranks(tmp_path):
    """Two ranks with 1 and 5 valid boxes: each rank's losses, normalised
    by the boxes averaged over the ranks (3), against the JAX criterion's
    axis_name branch under shard_map on two devices."""
    rng = np.random.RandomState(4)
    b, q, m, classes = 2, 6, 4, 3
    data = {"pred_logits": rng.randn(2 * b, q, classes + 1),
            "pred_boxes": rng.uniform(0.2, 0.6, (2 * b, q, 4)),
            "labels": rng.randint(0, classes, (2 * b, m)),
            "boxes": rng.uniform(0.2, 0.6, (2 * b, m, 4))}
    data = {k: v.astype(np.int64 if k == "labels" else np.float32)
            for k, v in data.items()}
    valid = np.zeros((2 * b, m), bool)
    valid[0, :1] = True           # rank 0: 1 box
    valid[2, :4] = valid[3, :1] = True  # rank 1: 5 boxes
    data["valid"] = valid
    weights = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    for r in range(RANKS):
        np.savez(tmp_path / f"boxes{r}.npz",
                 **{k: v[r * b:(r + 1) * b] for k, v in data.items()})
    outs = run_worker("num_boxes", tmp_path,
                      {"num_classes": classes, "weight_dict": weights})

    mesh = make_mesh(num_devices=2)

    def local(outputs, targets):
        losses = jax_criterion(outputs, targets, num_classes=classes,
                               weight_dict=weights, eos_coef=0.1,
                               axis_name="data")
        return {k: v[None] for k, v in losses.items()}

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=P("data"), check_vma=False)
    ref = jax.device_get(fn(
        {k: jnp.asarray(data[k]) for k in ("pred_logits", "pred_boxes")},
        {"labels": jnp.asarray(data["labels"], jnp.int32),
         "boxes": jnp.asarray(data["boxes"]),
         "valid": jnp.asarray(data["valid"])}))
    for r, out in enumerate(outs):
        for name in ("loss_bbox", "loss_giou", "loss_ce", "loss"):
            np.testing.assert_allclose(out[name], float(ref[name][r]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {name}")
    # the boxes were averaged: rank 0's box loss divides by 3, not 1
    assert outs[0]["loss_bbox"] < outs[1]["loss_bbox"] * 3


# ------------------------------------------------------------------ CLI

def cli_config(root, name, data_config):
    return {
        "train_config": {
            "output_directory": str(root / f"{name}_out"),
            "checkpoint_path": str(root / f"{name}_init"), "epochs": 1,
            "local_batch_size": 4, "global_batch_size": 8,
            "iters_per_checkpoint": 2, "iters_per_val": 2, "seed": 7,
            "drop_last_batch": True, **TRAIN_CONFIG, "scheduler": "cosine",
            "lr_noise": None, "warmup_lr": 1e-6, "min_lr": 1e-5,
            "warmup_epochs": 0, "pretrained_backbone": None,
            "distributed": True},
        "dist_config": {"dist_backend": "gloo",
                        "dist_url": "tcp://localhost:54321"},
        "data_config_path": str(data_config),
        "vit_config": {"decoder": "classification", "image_size": 80,
                       "patch_size": 16, "embed_dim": 64, "depth": 1,
                       "heads": 2, "mlp_dim": 128, "dropout": 0.0,
                       "emb_dropout": 0.0, "q_format": "FP32",
                       "compute_dtype": "float32"}}


def test_train_cli_two_ranks_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """The port's classification train CLI as two data ranks (4 images a
    rank and step, one micro-batch) against the JAX CLI on two virtual
    devices, both from one initial checkpoint: the same iteration lines
    to their printed digits (as tests/test_torch_int8_qat.py holds the
    CLIs), rank 0 alone printing them and writing the checkpoints."""
    from conftest import load_script_module

    subprocess.run([sys.executable, os.path.join(
        REPO, "classification", "prepare_synthetic.py"), "--out",
        str(tmp_path / "data"), "--per_class", "3", "--seed", "5"],
        check=True, capture_output=True)
    with open(os.path.join(REPO, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = str(tmp_path / "data")
    (tmp_path / "data_config.json").write_text(json.dumps(data_config))
    configs = {n: cli_config(tmp_path, n, tmp_path / "data_config.json")
               for n in ("jax", "port")}
    model = JaxViT(**jax_vit_kwargs(configs["jax"], data_config))
    state = init_train_state(model, jax_optim.create_optimizer(
        configs["jax"]["train_config"]), jax.random.PRNGKey(0),
        jnp.zeros((1, 80, 80, 3)))
    jax_save_checkpoint(state, str(tmp_path / "jax_init"))
    port = ViT(**{**VIT, "num_classes": data_config["number_of_classes"]},
               compute_dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)), strict=True)
    save_checkpoint(TrainState(port, optim.create_optimizer(
        configs["port"]["train_config"], port)), str(tmp_path / "port_init"))
    for name, config in configs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(config))

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
    monkeypatch.chdir(tmp_path)
    jax_cli = load_script_module(
        os.path.join(REPO, "classification", "train.py"),
        "cls_train_for_two_ranks")
    jax_cli.train(configs["jax"])
    jax_out = capsys.readouterr().out
    assert "devices: 2 (data=2, model=1), local_batch=4, n_accum=1" in jax_out
    outs = run_ranks([sys.executable, "-m",
                      "myrtle_vision_tpu_torch.classification.train", "-c",
                      str(tmp_path / "port.json"), "--device", "cpu"],
                     str(tmp_path))
    line = r"Iteration (\d+):\tloss=(\S+)\tacc=(\S+)"
    ours, ref = re.findall(line, outs[0]), re.findall(line, jax_out)
    print(f"iterations: port {ours}, JAX {ref}")
    assert [r[0] for r in ours] == [r[0] for r in ref] == ["1", "2"]
    assert "ranks: 2 (data=2, model=1), rank 0" in outs[0]
    assert "local_batch=4, n_accum=1" in outs[0]
    assert not re.findall(line, outs[1])
    np.testing.assert_allclose(np.asarray(ours, np.float64)[:, 1:],
                               np.asarray(ref, np.float64)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    run_dir = outs[0].split("output directory: ")[1].split("\n")[0]
    assert sorted(os.listdir(run_dir)) == ["vit_000000", "vit_000002"]
