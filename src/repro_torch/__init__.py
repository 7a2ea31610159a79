"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

Mirrors `repro`'s module names (`repro_torch.models.attention` is the
counterpart of `repro.models.attention`), imports `torch` and numpy and
nothing of JAX or of `repro`.  Entry points take an explicit `device`
and default to ``"cuda"``; the bit-plane projection runs as a CUDA
kernel written for Hopper (`kernels/csrc/bitplane_matmul.cu`).
"""
