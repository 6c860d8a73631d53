"""The port's kernels for Hopper (CUDA C++ in ``csrc/``, built on first
use): the three MoR kernels with their padding wrappers (``ops``) and
the GQA paged flash attention, each beside its plain PyTorch version."""
