"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout module for module. It imports
``torch`` and numpy, never ``jax`` and nothing of ``deeplearning4j_tpu``.
Entry points run on ``cuda`` unless the caller asks for the CPU, through
``get_environment().set_device("cpu")`` or a ``device=`` argument; with no
GPU and no such request they raise.
"""
