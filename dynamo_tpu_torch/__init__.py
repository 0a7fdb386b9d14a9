"""PyTorch/CUDA port of dynamo_tpu: the same serving stack on an NVIDIA GPU.

The JAX package `dynamo_tpu` is the reference; this package imports nothing of
it (the tests compare the two). See README.md, "The PyTorch/CUDA port".
"""
