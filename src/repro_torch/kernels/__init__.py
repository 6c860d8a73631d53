"""The port's kernels for Hopper (CUDA C++ in ``csrc/``, built on first
use): the three MoR kernels, each also over an expert grid, with their
padding wrappers (``ops``), and the GQA and absorbed-MLA paged flash
attentions, each beside its plain PyTorch version."""
