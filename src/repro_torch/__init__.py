"""PyTorch/CUDA port of the JAX package ``repro``.

Imports torch and numpy only.  Entry points run on the GPU unless the
caller passes ``device="cpu"`` (see ``repro_torch.kernels.protocol``).
"""
