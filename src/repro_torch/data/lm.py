"""Deterministic synthetic LM token pipeline (a copy of ``repro.data.lm``:
numpy only, so the same seed gives the same batches in both packages).

Offline container => no real corpus.  We synthesize a *learnable* stream from
a seeded order-1 Markov chain over a reduced alphabet embedded in the model's
vocab (sparse rows, Zipf-ish stationary mass), so cross-entropy has real
structure to learn: a model that learns the bigram statistics drops well
below the unigram entropy floor, which the training tests assert.

The stream is sharded by (host_id, n_hosts) for multi-host data loading and
is fully reproducible from (seed, step).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int  # per-host batch
    seed: int = 0
    alphabet: int = 256  # active symbols; rest of vocab unused (realistic tail)
    branching: int = 8  # successors per symbol (low entropy => learnable)
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        a = min(self.alphabet, self.vocab_size)
        rng = np.random.default_rng(self.seed)
        succ = np.stack(
            [rng.choice(a, size=self.branching, replace=True) for _ in range(a)]
        )  # (a, branching)
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, size=a)
        self._succ = succ
        self._probs = probs.astype(np.float64)
        self._a = a

    def _gen_batch(self, rng: np.random.Generator) -> dict[str, np.ndarray]:
        b, s = self.batch_size, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self._a, size=b)
        for t in range(s):
            cur = toks[:, t]
            choice = np.array(
                [rng.choice(self.branching, p=self._probs[c]) for c in cur]
            )
            toks[:, t + 1] = self._succ[cur, choice]
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, s), dtype=np.float32),
        }

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Reproducible batch for a global step (host-sharded)."""
        rng = np.random.default_rng(
            (self.seed, step, self.host_id, self.n_hosts)
        )
        return self._gen_batch(rng)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def bigram_entropy(self) -> float:
        """Entropy rate of the chain in nats — the achievable CE floor."""
        # stationary distribution via power iteration
        trans = np.zeros((self._a, self._a))
        for i in range(self._a):
            np.add.at(trans[i], self._succ[i], self._probs[i])
        pi = np.ones(self._a) / self._a
        for _ in range(200):
            pi = pi @ trans
        pi /= pi.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            h_rows = -np.nansum(trans * np.log(np.where(trans > 0, trans, 1.0)), axis=1)
        return float((pi * h_rows).sum())


def synthetic_lm_stream(
    vocab_size: int, seq_len: int, batch_size: int, *, seed: int = 0, **kw
) -> TokenStream:
    return TokenStream(vocab_size, seq_len, batch_size, seed=seed, **kw)
