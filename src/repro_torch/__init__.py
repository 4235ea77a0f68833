"""PyTorch and CUDA port of the array-accelerator DSE system (``repro``).

It imports torch and numpy and nothing of JAX or of the ``repro`` package.
"""
