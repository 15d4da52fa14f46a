"""gaussreg_tpu_torch: the PyTorch + CUDA (Hopper) port of gaussreg_tpu.

Mirrors gaussreg_tpu's layout (ops/, models/, data/, gs/, utils/, engine/,
api.py, config.py) and public names. It imports torch and numpy only —
never jax or the gaussreg_tpu package. The Pallas TPU kernels of the
coarse-registration path are hand-written CUDA kernels for sm_90a under
csrc/, built with nvcc at first use (ops/_cuda.py).

Float32 matmuls and convolutions run at full float32 precision: the JAX
reference runs its f32 matmuls at "float32" precision, and TF32 keeps only
about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
