"""PyTorch/CUDA port of the WFAgg reproduction.

Mirrors ``repro`` (the JAX/Pallas package, which stays the reference)
module for module.  Plain tensor code is PyTorch; every Pallas kernel on
a ported path is a CUDA kernel written by hand for Hopper (``sm_90a``)
under ``kernels/*/csrc/``.

The reference computes in float32 end to end.  A float32 convolution
through cuDNN (and, where enabled, a matmul) would otherwise run in TF32
on the card, so both flags are turned off here, at import.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
