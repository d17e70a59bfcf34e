"""Kernels of the port and their plain PyTorch versions (see
:mod:`vit_cnn_tpu_torch.ops._build` for how the CUDA sources are built)."""
