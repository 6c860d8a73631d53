"""Synthetic Markov-chain token batches (a copy of
``repro.data.pipeline.synthetic_lm_batch``: host numpy, so both packages
draw the same tokens from the same seed)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig

_MARKOV_STATES = 64


def _markov_tables(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(_MARKOV_STATES, 0.3), _MARKOV_STATES)
    emit = rng.integers(0, vocab, size=(_MARKOV_STATES, 8))
    return trans, emit


def synthetic_lm_batch(cfg: ModelConfig, batch: int, seq: int, *,
                       seed: int, step: int, host: int = 0,
                       n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Markov-chain token stream: next-token prediction is learnable."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step * n_hosts + host]))
    trans, emit = _markov_tables(max(cfg.vocab_size, 8), seed)
    states = rng.integers(0, _MARKOV_STATES, size=batch)
    toks = np.empty((batch, seq + 1), np.int32)
    for t in range(seq + 1):
        toks[:, t] = emit[states, rng.integers(0, 8, size=batch)]
        cum = np.cumsum(trans[states], axis=1)
        states = (cum > rng.random((batch, 1))).argmax(1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
