"""PyTorch / CUDA port of the Mixture-of-Rookies reproduction.

Mirrors the layout and names of the JAX package ``repro`` (``configs/``,
``core/``, ``kernels/``, ``models/``, ``serving/``, ``launch/``) for the
slice it covers so far: the continuous-batching engine, on the paged
pool with prefix caching or the slotted cache, serving the dense family
(granite-3-2b) and the moe family with MLA (deepseek-v2-236b) in MoR
modes ``dense`` / ``exact`` / ``tiled`` / ``kernel``.
It imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
