"""vit_cnn_tpu_torch: the PyTorch + CUDA port of vit_cnn_tpu, for one
NVIDIA H100.

The JAX package ``vit_cnn_tpu`` is the reference; this package mirrors
its module layout (ops/, nn/, models/, pipeline/, train/, infer/, cli/)
and holds its numerics to it. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a CUDA kernel written for Hopper
(``csrc/``), built on first use by :mod:`vit_cnn_tpu_torch.ops._build`. Each kernel's wrapper
runs its plain PyTorch version on CPU tensors and the kernel on CUDA
tensors.

Ported so far: supervised training and full-scene serving of
``Multimodality_Mamba``; each kernel's autograd Function has a CUDA
adjoint where the JAX package has a Pallas one.
"""

__version__ = "0.1.0"
