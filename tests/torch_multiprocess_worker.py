"""One rank of the multi-process CPU tests (tests/test_torch_multiprocess.py):
joins the gloo group of MVT_COORDINATOR / MVT_NUM_PROCESSES /
MVT_PROCESS_ID, runs one task of the port on its share and writes what
it found as JSON.  It imports torch and the port only.

    python tests/torch_multiprocess_worker.py <task> <work dir>
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from myrtle_vision_tpu_torch.models.detector import criterion  # noqa: E402
from myrtle_vision_tpu_torch.models.distill import (  # noqa: E402
    DistillWrapper,
)
from myrtle_vision_tpu_torch.models.vit import ViT  # noqa: E402
from myrtle_vision_tpu_torch.parallel import collectives  # noqa: E402
from myrtle_vision_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from myrtle_vision_tpu_torch.parallel.tp import (  # noqa: E402
    setup_tensor_parallel,
)
from myrtle_vision_tpu_torch.training import optim  # noqa: E402
from myrtle_vision_tpu_torch.training.classification import (  # noqa: E402
    make_loss_fn,
)
from myrtle_vision_tpu_torch.training.optim import (  # noqa: E402
    cross_entropy_loss,
)
from myrtle_vision_tpu_torch.training.trainer import (  # noqa: E402
    TrainState,
    data_parallel,
    dropout_generator,
    make_train_step,
)


def model_from(work, spec):
    model = ViT(**spec["vit"], compute_dtype=torch.float32)
    model.load_state_dict(torch.load(os.path.join(work, "init.pt"),
                                     weights_only=True), strict=True)
    return model


class Predictions:
    """The part of a CocoEvaluator that ``merge_coco_evaluators`` uses."""

    def __init__(self, predictions):
        self.predictions = dict(predictions)

    def update(self, predictions):
        self.predictions.update(predictions)


def collectives_task(work, rank, spec):
    merged = collectives.merge_coco_evaluators(
        Predictions({str(10 + rank): [rank]}))
    return {"merged": merged.predictions,
            "reduce": collectives.reduce_dict(
                {"b": float(rank + 1), "a": float(10 * rank)}),
            "sum": collectives.reduce_dict({"a": float(rank + 1)},
                                           average=False),
            "gather": collectives.all_gather_host(
                {"rank": rank, "payload": "x" * (100 * rank)}),
            "main": collectives.is_main_process(),
            "count": collectives.process_count()}


def teacher_logits(img, num_classes):
    """A fixed stand-in for a distiller's frozen teacher: a linear map of
    each image's mean colour."""
    w = torch.linspace(-2.0, 2.0, 3 * num_classes).view(3, num_classes)
    return img.float().mean((1, 2)) @ w


def keep_first_gradients(optimizer, model, path):
    """Save the gradients that the optimizer's first step applies (after
    every reduction of the step), by parameter name, to ``path``."""
    step = optimizer.step

    def first(*args, **kwargs):
        if not os.path.exists(path):
            torch.save({n: p.grad.detach().clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}, path)
        return step(*args, **kwargs)

    optimizer.step = first


def train_task(work, rank, spec):
    """The steps of ``batches.npz`` (every rank the whole batch on a model
    group, its block on a data group), then the held-out loss.  Without
    torch.distributed initialised (``tensor_parallel`` 1), one process.
    ``spec["distill"]``: the model trains as the student of a
    ``DistillWrapper`` against :func:`teacher_logits`; a positive
    ``dropout`` trains with the generator of ``spec["seed"]``;
    ``spec["grads"]``: the first step's gradients are saved
    (:func:`keep_first_gradients`)."""
    mesh = make_mesh(spec["tensor_parallel"])
    model = model_from(work, spec)
    distiller = DistillWrapper(model) if spec.get("distill") else None
    setup_tensor_parallel(model, mesh, extra_ok=distiller is None)
    trained = model if distiller is None else distiller
    module = data_parallel(trained, mesh)
    state = TrainState(trained, optim.create_optimizer(spec["train_config"],
                                                       trained),
                       dropout=dropout_generator(trained, spec.get("seed", 0),
                                                 mesh.data_index))
    if spec.get("grads"):
        keep_first_gradients(state.optimizer, trained, os.path.join(
            work, f"grads_tp{spec['tensor_parallel']}_rank{rank}.pt"))
    if distiller is None:
        loss_fn = make_loss_fn(module)
    else:
        classes = spec["vit"]["num_classes"]
        loss_fn = make_loss_fn(model, distiller=module,
                               teacher_fn=lambda img: teacher_logits(
                                   img, classes))
    step = make_train_step(loss_fn, spec["n_accum"], mesh=mesh,
                           module=module)
    data = np.load(os.path.join(work, "batches.npz"))
    per = data["image"].shape[2] // mesh.n_data
    block = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    losses = []
    for i in range(data["image"].shape[0]):
        batch = {"image": torch.from_numpy(data["image"][i][:, block]),
                 "label": torch.from_numpy(data["label"][i][:, block])}
        losses.append(float(step(state, batch, spec["lr"])["loss"]))
    model.eval()
    with torch.no_grad():
        held_out = float(cross_entropy_loss(
            model(torch.from_numpy(data["eval_image"])),
            torch.from_numpy(data["eval_label"]).long()))
    out = {"losses": losses, "held_out": held_out}
    if spec.get("observers"):
        out["observers"] = {k: float(v) for k, v in model.state_dict().items()
                            if k.endswith((".min", ".max"))}
    return out


def num_boxes_task(work, rank, spec):
    data = np.load(os.path.join(work, f"boxes{rank}.npz"))
    outputs = {k: torch.from_numpy(data[k]) for k in ("pred_logits",
                                                      "pred_boxes")}
    targets = {k: torch.from_numpy(data[k]) for k in ("labels", "boxes",
                                                      "valid")}
    mesh = make_mesh()
    losses = criterion(outputs, targets, num_classes=spec["num_classes"],
                       weight_dict=spec["weight_dict"], eos_coef=0.1,
                       group=mesh.data_group)
    return {k: float(v) for k, v in losses.items()}


TASKS = {"collectives": collectives_task, "train": train_task,
         "num_boxes": num_boxes_task}


def main():
    task, work = sys.argv[1], sys.argv[2]
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    assert collectives.initialize_multihost("gloo")
    rank = collectives.process_index()
    try:
        out = TASKS[task](work, rank, spec)
    finally:
        collectives.shutdown()
    with open(os.path.join(work, f"out{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
