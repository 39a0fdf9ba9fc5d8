"""Multi-GPU training as a user runs it, on every visible card: the
classification train CLI on vit_small.json (full width, 2 steps of 64
synthetic images) spawning one rank per card over NCCL, as data parallel
over every card, as data x tensor parallel 2, the latter in float32
compute, and (PR 28) data x tensor parallel 2 under MVT_NO_FUSE=1, where
the fused gate refuses and every Block runs split over its model group,
each against the same CLI in one process on one card at the same steps
(the first step's loss within chip_smoke.py's LOSS_BAR).

    python3 tools/perf/torch_multi_gpu.py [layout ...]   # from the repo
                                                         # root, 4 cards

With layout names (dp4, dp2xtp2, dp2xtp2-fp32, dp2xtp2-nofuse), only
those run.

Prints one line a run and one verdict a layout; needs nvcc and the cards.
"""
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

print(S.power_line(), "count", torch.cuda.device_count())
S.phase_build()
data_config, _ = S.make_dataset()
base = S.vit_small_config()
tc = base["train_config"]
tc.update(checkpoint_path="", epochs=1, warmup_epochs=0,
          pretrained_backbone=None, iters_per_checkpoint=1000,
          iters_per_val=1000, local_batch_size=32, global_batch_size=64)
base["data_config_path"] = S.subset_data_config(data_config, 128, "four")


def run(name, changes, env=None):
    c = json.loads(json.dumps(base))
    c["train_config"]["output_directory"] = os.path.join(S.WORK, name)
    for key, value in changes.items():
        section, field = key.split("__")
        c[section][field] = value
    cfg = S.write_json(f"{name}.json", c)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "myrtle_vision_tpu_torch.classification.train",
         "-c", cfg, "--device", "cuda"], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, **(env or {})))
    took = time.perf_counter() - t0
    text = out.stdout + out.stderr
    losses = [float(v) for v in re.findall(r"Iteration \d+:\tloss=(\S+)\t",
                                           text)]
    layout = re.findall(r"ranks: .*|tensor parallel: .*", text)
    print(f"{name}: rc {out.returncode}, {took:.1f} s, {layout}, losses "
          f"{losses}")
    if out.returncode:
        print(text[-4000:])
    return losses


one = {"train_config__local_batch_size": 64,
       "train_config__distributed": False}
for tag, changes, env in (
        ("dp4", {}, None),
        ("dp2xtp2", {"dist_config__tensor_parallel": 2}, None),
        ("dp2xtp2-fp32", {"dist_config__tensor_parallel": 2,
                          "vit_config__compute_dtype": "float32"}, None),
        ("dp2xtp2-nofuse", {"dist_config__tensor_parallel": 2},
         {"MVT_NO_FUSE": "1"})):
    if sys.argv[1:] and tag not in sys.argv[1:]:
        continue
    ref_changes = dict(one)
    if "fp32" in tag:
        ref_changes["vit_config__compute_dtype"] = "float32"
    got = run(tag, changes, env)
    ref = run(tag + "-one", ref_changes, env)
    ok = len(got) == len(ref) == 2 and abs(got[0] - ref[0]) <= \
        S.LOSS_BAR * max(1.0, abs(ref[0]))
    print(f"four: {tag}: first-step |d| "
          f"{abs(got[0] - ref[0]) if got and ref else 'n/a'}, spread "
          f"{max((abs(a - b) for a, b in zip(got, ref)), default='n/a')}, "
          f"{'ok' if ok else 'FAILED'}")
