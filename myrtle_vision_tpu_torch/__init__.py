"""myrtle_vision_tpu_torch -- the PyTorch / CUDA (NVIDIA Hopper) port of
myrtle_vision_tpu.

The package mirrors the JAX package's layout (``models/vit.py`` here is
the counterpart of ``myrtle_vision_tpu/models/vit.py``).  It imports
torch, never jax, and nothing of the JAX package: what it needs of the
JAX package's jax-free modules (datasets, transforms, config, export and
pretrained helpers, the activation-saving policy) it keeps as copies
under the same relative paths.  The TPU package's
Pallas kernels become CUDA kernels written by hand in ``csrc/``, built
for ``sm_90a`` at first use (``ops/_build.py``); each sits beside a plain
PyTorch version that CPU tensors take.

Float32 matrix products and convolutions run in true fp32 in this
package: importing it sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (TF32 would keep only ~3
decimal digits of the fp32 patch embedding and decoder head).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
