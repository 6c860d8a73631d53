"""Synthetic batches, copies of ``repro.data.pipeline``'s host-numpy
generators, so that both packages draw the same data from the same
seed: Markov-chain tokens (``synthetic_lm_batch``), class-conditional
images (``synthetic_image_batch``) and formant-like audio frames
(``synthetic_frames_batch``), and the batch maker's choice among them
(``make_batch``)."""
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


def synthetic_image_batch(cfg: ModelConfig, batch: int, *, seed: int,
                          step: int, host: int = 0, n_hosts: int = 1
                          ) -> Dict[str, np.ndarray]:
    """Class-conditional frequency patterns + noise (CIFAR-like task),
    NHWC float32."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step * n_hosts + host]))
    n_cls = cfg.cnn_num_classes
    s = cfg.img_size
    labels = rng.integers(0, n_cls, size=batch).astype(np.int32)
    yy, xx = np.mgrid[0:s, 0:s] / s
    imgs = np.empty((batch, s, s, 3), np.float32)
    for c in range(3):
        freq = 1.0 + labels[:, None, None] * 0.7 + c
        phase = labels[:, None, None] * 1.3 + c * 2.1
        imgs[..., c] = np.sin(2 * np.pi * freq * (xx + yy)[None] + phase)
    imgs += 0.35 * rng.standard_normal(imgs.shape).astype(np.float32)
    return {"images": imgs, "labels": labels}


def synthetic_frames_batch(cfg: ModelConfig, batch: int, seq: int, *,
                           seed: int, step: int, host: int = 0,
                           n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Formant-like frame features (B, T, d) + piecewise-constant targets
    (TDS/ASR)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step * n_hosts + host]))
    d = cfg.d_model
    labels = np.repeat(rng.integers(0, cfg.vocab_size, (batch, seq // 4 + 1)),
                       4, axis=1)[:, :seq].astype(np.int32)
    t = np.arange(seq)[None, :, None]
    k = np.arange(d)[None, None, :]
    frames = np.sin(0.1 * (labels[..., None] + 1) * t / (1 + k % 7)) \
        + 0.3 * rng.standard_normal((batch, seq, d))
    return {"frames": frames.astype(np.float32), "labels": labels}


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    """``repro.data.pipeline.make_batch`` on one host, with the batch and
    sequence length given directly: images for the cnn family, frames
    for tds and the audio stub (hubert), tokens for every other family."""
    kw = dict(seed=seed, step=step)
    if cfg.family == "cnn":
        return synthetic_image_batch(cfg, batch, **kw)
    if cfg.family == "tds" or cfg.frontend == "audio_stub":
        return synthetic_frames_batch(cfg, batch, seq, **kw)
    return synthetic_lm_batch(cfg, batch, seq, **kw)
