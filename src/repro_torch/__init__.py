"""PyTorch/CUDA port of the CaWoSched reproduction (``repro``).

The package keeps ``repro``'s module layout and names; it imports torch
and numpy, never jax and nothing of ``repro``. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
