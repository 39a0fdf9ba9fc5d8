"""Probes and attribution tools of the port's kernels on the card.

The counterparts of the JAX package's TPU tools in tools/perf/, each a
module run as ``python -m myrtle_vision_tpu_torch.perf.<name>``:

- ``attn_microbench``      the attention-block forward variants (K12)
- ``mlp_microbench``       the MLP-block forward's GELU variants (K13)
- ``layout_probe``         transposed operands of the backward's
                           per-image products, read in place or
                           transposed as staged (K14)
- ``train_gap_bench``      the FP32 ViT-S/16 train step, part by part
- ``int8_component_bench`` the converted-INT8 forward, part by part

Each takes ``--device cuda|cpu`` (default cuda, which raises without a
card); on the CPU the plain versions run and every time is a host-clock
time, not a device one.  Importing them builds nothing and touches no
device.
"""
