"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off, and NumPy.  It imports nothing of ``pkr_tpu_torch``, ``pkr_tpu`` or
JAX, takes the benchmark's own inputs (weights, cache codes, wavs, made
from the seed) and works out again whatever the program derived from them.
"""

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """f32 matmuls and convolutions in full f32 (TF32 off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
