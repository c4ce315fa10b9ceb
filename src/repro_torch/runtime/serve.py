"""Batched serving runtime with continuous batching.

The port of the reference package's ``runtime/serve.py`` on one device.
The server owns a fixed pool of B cache slots (the decode batch).  Each
request occupies one slot; prefill feeds prompt tokens through the decode
path at the slot's own position (per-row positions).  Slots complete
independently (EOS, ``max_new_tokens`` or the end of the cache) and are
immediately recycled for queued requests — iteration-level (continuous)
batching.  Admission, prefill, completion and recycling follow the
reference line for line; the reference's jitted step with donated caches
becomes ``decode_forward`` updating the caches in place.  One departure:
admission zeroes the slot's Mamba-2 conv and state rows, which the
reference leaves holding the previous request's state (ROADMAP queue 3);
KV rows need nothing, since ``kv_len`` masks them.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServerStats:
    admitted: int = 0
    completed: int = 0
    steps: int = 0
    tokens_generated: int = 0


class Server:
    """Continuous-batching server of ``model`` (a ``models.model.Model``)
    on ``device``.  The caches (``init_caches``: bf16 KV rows of
    ``cache_len(cfg, max_seq)`` slots per attention sublayer, conv and
    state rows per Mamba-2 sublayer, the encoder memory of an
    encoder-decoder) live on the device and every step updates them in
    place.  ``sampler`` maps the (pool, vocab) f32 logits of a step to
    next tokens (greedy argmax by default)."""

    def __init__(self, cfg: ArchConfig, model, *, pool: int = 4,
                 max_seq: int = 256, sampler: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.pool = pool
        self.max_seq = max_seq
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.caches = mdl.init_caches(cfg, pool, max_seq, device=self.device)
        self.pos = np.zeros(pool, np.int32)          # next cache slot/row
        self.active: list[Optional[Request]] = [None] * pool
        self.queue: deque[Request] = deque()
        self.stats = ServerStats()
        self._rid = 0
        self._pending: list[list[int]] = [[] for _ in range(pool)]

    # ---------------------------------------------------------- admission

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: int = -1) -> Request:
        r = Request(self._rid, np.asarray(prompt, np.int32),
                    max_new_tokens, eos_id)
        self._rid += 1
        self.queue.append(r)
        return r

    def _admit(self):
        for slot in range(self.pool):
            if self.active[slot] is None and self.queue:
                r = self.queue.popleft()
                self.active[slot] = r
                self.pos[slot] = 0
                for layer in self.caches["layers"].values():
                    for name in ("conv", "state"):
                        if name in layer:
                            layer[name][:, slot].zero_()
                self._pending[slot] = list(r.prompt)
                self.stats.admitted += 1

    # ------------------------------------------------------------- step

    def step(self) -> bool:
        """One pool-wide decode step. Returns True if any work was done."""
        self._admit()
        if not any(r is not None for r in self.active):
            return False
        tokens = np.zeros((self.pool, 1), np.int32)
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            if self._pending[slot]:
                tokens[slot, 0] = self._pending[slot][0]
            else:
                tokens[slot, 0] = r.out_tokens[-1]
        logits, self.caches = mdl.decode_forward(
            self.model.params, self.caches, torch.from_numpy(tokens).long(),
            self.pos, self.cfg, device=self.device)
        nxt = self.sampler(logits[:, 0, :])
        nxt = nxt.cpu().numpy() if torch.is_tensor(nxt) else np.asarray(nxt)
        self.stats.steps += 1
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            self.pos[slot] += 1
            if self._pending[slot]:
                self._pending[slot].pop(0)
                if self._pending[slot]:
                    continue                      # still prefilling
            # generating: the model's next-token prediction
            r.out_tokens.append(int(nxt[slot]))
            self.stats.tokens_generated += 1
            if (len(r.out_tokens) >= r.max_new_tokens
                    or r.out_tokens[-1] == r.eos_id
                    or self.pos[slot] >= self.max_seq - 1):
                r.done = True
                self.stats.completed += 1
                self.active[slot] = None          # recycle the slot
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> ServerStats:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.stats
