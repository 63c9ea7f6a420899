"""Deterministic-by-step data pipeline (port of ``repro.data.pipeline``).

``DataConfig``, ``_pack_row``, ``batch_at_step`` and ``Pipeline`` are the
JAX package's, line for line (pure numpy): any step's batch is the same
array in both packages, bit for bit, so the two trainers see the same
data and a restart needs only the step counter.

- `batch_at_step(cfg, step)` is a pure function of (seed, step): any
  process can rematerialize any step's global batch, so restarts are
  bit-exact and there is no shuffle state to checkpoint.
- `Pipeline` prefetches the next batches on a background thread while a
  step runs (``prefetch_depth`` batches ahead).
- `to_device` puts one batch on the device the trainer runs on.

The synthetic stream mimics packed-document LM data: documents of
power-law length packed into fixed windows with EOS=0 boundaries; labels
are next-token with -100 on padding (masked by the loss).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    family: str = "dense"          # vlm/audio add stub modality inputs
    d_model: int = 0
    vision_tokens: int = 0
    encoder_seq: int = 0


def _pack_row(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    """One packed row of documents (EOS=0 separators)."""
    row = np.empty(cfg.seq_len + 1, np.int32)
    pos = 0
    while pos < cfg.seq_len + 1:
        n = int(rng.pareto(2.0) * cfg.mean_doc_len) + 8
        n = min(n, cfg.seq_len + 1 - pos)
        row[pos : pos + n] = rng.integers(1, cfg.vocab_size, size=n)
        pos += n
        if pos < cfg.seq_len + 1:
            row[pos] = 0
            pos += 1
    return row


def batch_at_step(cfg: DataConfig, step: int) -> dict:
    """Pure (seed, step) -> global batch. Recomputable by any host."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 0xDE17A]))
    rows = np.stack([_pack_row(rng, cfg) for _ in range(cfg.global_batch)])
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (cfg.global_batch, cfg.vision_tokens, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (cfg.global_batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32)
    return batch


class Pipeline:
    """Double-buffered prefetching iterator over `batch_at_step`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch_depth: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, batch_at_step(self.cfg, s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        s, b = self._q.get()
        self.step = s + 1
        return s, b

    def close(self):
        self._stop.set()


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: int32 ``tokens`` and
    ``labels``, float32 ``vision_embeds`` / ``frames``."""
    return {k: torch.as_tensor(
                v, dtype=(torch.float32 if k in ("vision_embeds", "frames")
                          else torch.int32)).to(device)
            for k, v in batch.items()}
