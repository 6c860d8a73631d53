"""The MoR kernels for Hopper (CUDA C++ in ``csrc/``, built on first
use), their plain PyTorch versions, and the padding wrappers
(``ops``)."""
