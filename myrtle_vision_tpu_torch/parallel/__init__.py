"""Multi-GPU training: the (data, model) rank grid (mesh.py), the
process-level collectives (collectives.py) and head-sharded tensor
parallelism through the fused block-half kernels (tp.py)."""
