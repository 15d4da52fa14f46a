"""The benchmark's plain references: plain PyTorch under portbench/, which
imports neither JAX nor the JAX package nor anything of the program, and
takes nothing the program made. `coarse.py` is the coarse registration call
written from its definition at the clouds' own sizes; `weights.py` reads the
configuration's checkpoint file with a decoder of its own."""


import contextlib


@contextlib.contextmanager
def precision(tf32: bool):
    """The references run float32 products in float32 (TF32 off), as the
    program does; the controls run them in TF32."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
