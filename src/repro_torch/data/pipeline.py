"""Tokenized data pipeline: synthetic + file-backed, shard-aware,
deterministically resumable.

A copy of the reference package's ``data/pipeline.py`` (numpy only),
kept here so that the port imports nothing of ``repro``;
``tests/test_torch_runtime.py`` holds it to the original batch for batch.

Design constraints from the runtime (DESIGN.md §2.4):
- **shard-aware** — every data-parallel replica draws a disjoint slice of
  each global batch; slicing is by (replica_id, n_replicas) so the same
  code runs 1-host CPU tests and 512-chip pods.
- **resumable** — batch t is a pure function of (seed, t): restarting from
  a checkpoint at step t replays the exact stream with no state file.
- **loss-masked LM format** — each item is (tokens, targets, loss_mask)
  with targets = tokens shifted left (next-token prediction).
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None         # None -> synthetic stream
    n_replicas: int = 1
    replica_id: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_replicas == 0, (
            self.global_batch, self.n_replicas)
        return self.global_batch // self.n_replicas


class TokenSource:
    """Source of raw token rows (global_batch, seq_len + 1)."""

    def global_rows(self, step: int, cfg: DataConfig) -> np.ndarray:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Deterministic synthetic LM stream: Zipf-ish unigram draw mixed with
    a copy pattern so models have something learnable."""

    def global_rows(self, step: int, cfg: DataConfig) -> np.ndarray:
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len + 1
        # Zipf-like unigram distribution (heavy head, long tail)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(cfg.vocab_size, size=(b, s), p=probs)
        # learnable structure: every 2nd half-row copies the 1st half
        half = s // 2
        toks[:, half:2 * half] = toks[:, :half]
        return toks.astype(np.int32)


class FileSource(TokenSource):
    """Memory-mapped flat int32 token file; rows are strided windows.

    The file is one long token stream (np.int32).  Batch t takes rows at
    deterministic offsets derived from (seed, t) — random access keeps
    resume O(1) regardless of corpus position.
    """

    def __init__(self, path: str | pathlib.Path):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def global_rows(self, step: int, cfg: DataConfig) -> np.ndarray:
        n = len(self.tokens)
        s = cfg.seq_len + 1
        assert n >= s, f"corpus ({n} tokens) shorter than seq_len+1 ({s})"
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n - s, size=cfg.global_batch)
        return np.stack([self.tokens[st:st + s] for st in starts]) \
            .astype(np.int32)


def write_token_file(path, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)


class Pipeline:
    """Shard-aware iterator of LM batches."""

    def __init__(self, cfg: DataConfig, source: TokenSource | None = None):
        self.cfg = cfg
        self.source = source or (
            FileSource(cfg.path) if cfg.path else SyntheticSource())

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rows = self.source.global_rows(step, cfg)      # (B, S+1)
        lo = cfg.replica_id * cfg.local_batch
        rows = rows[lo:lo + cfg.local_batch]
        return {
            "tokens": rows[:, :-1],
            "targets": rows[:, 1:].astype(np.int32),
            "loss_mask": np.ones((cfg.local_batch, cfg.seq_len),
                                 np.float32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
