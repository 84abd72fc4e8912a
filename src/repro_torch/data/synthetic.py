"""Deterministic synthetic LM data (a copy of the JAX package's, in numpy).

Design constraints (1000-node operation):
  * stateless — ``batch_at(step)`` is a pure function of (seed, step,
    host_id), so resume-after-preemption is exact with no iterator state in
    checkpoints, and elastic re-sharding (changing host count) only changes
    which host materialises which rows, never the global batch content.
  * per-host sharding — each host generates only its slice.

The port keeps its own copy so that it never imports the JAX package;
``batch_at`` must give the reference's batches bit for bit (a parity test
holds it to that).

Tasks (the paper tested on random data only; these give the quality
benchmarks actual signal):
  * "bigram"  — a fixed random Markov chain over the vocab: learnable
    structure with a known entropy floor.
  * "copy"    — associative recall: random prefix, then a repeat of it;
    the second half is predictable only through attention (the classic
    probe separating real attention from degenerate mixing).
  * "uniform" — pure random tokens (the paper's own setting).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    kind: str
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        assert self.kind in ("bigram", "copy", "uniform")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def _transition(self) -> np.ndarray:
        """Fixed sparse-ish bigram transition matrix (seed-determined)."""
        rng = np.random.default_rng(self.seed + 7919)
        k = min(8, self.vocab)
        nxt = rng.integers(0, self.vocab, size=(self.vocab, k))
        return nxt

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """tokens/labels [host_batch, seq] int32; labels[t] = tokens[t+1]."""
        b, n, v = self.host_batch, self.seq, self.vocab
        # unique stream per (seed, step, host, row): SeedSequence spawning
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(step, self.host_id))
        )
        if self.kind == "uniform":
            toks = rng.integers(0, v, size=(b, n + 1), dtype=np.int64)
        elif self.kind == "copy":
            # associative recall: a random pattern of length `period` repeats;
            # tokens are predictable only by attending `period` back.
            period = min(16, (n + 1) // 2)
            prefix = rng.integers(0, v, size=(b, period), dtype=np.int64)
            reps = int(np.ceil((n + 1) / period))
            toks = np.tile(prefix, (1, reps))[:, : n + 1]
        else:  # bigram
            nxt = self._transition()
            k = nxt.shape[1]
            toks = np.empty((b, n + 1), dtype=np.int64)
            toks[:, 0] = rng.integers(0, v, size=b)
            choices = rng.integers(0, k, size=(b, n))
            for t in range(n):
                toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[:, :n].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def extras_at(self, step: int, cfg) -> Dict[str, np.ndarray]:
        """Stub modality frontends (vlm/encdec): deterministic embeddings."""
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed + 13, spawn_key=(step, self.host_id))
        )
        out = {}
        if cfg.family == "vlm":
            out["image_embeds"] = rng.normal(
                size=(self.host_batch, cfg.n_image_tokens, cfg.vision_dim)
            ).astype(np.float32)
        if cfg.family == "encdec":
            out["audio_frames"] = rng.normal(
                size=(self.host_batch, cfg.n_audio_ctx, cfg.d_model)
            ).astype(np.float32)
        return out


def make_task(kind: str, vocab: int, seq: int, global_batch: int, seed: int = 0,
              n_hosts: int = 1, host_id: int = 0) -> SyntheticTask:
    return SyntheticTask(kind, vocab, seq, global_batch, seed, n_hosts, host_id)
