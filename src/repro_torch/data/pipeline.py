"""Data pipeline: deterministic, host-sharded, prefetching.

The port's own copy of `repro.data.pipeline` (NumPy only; the port imports
nothing of `repro`): its batches equal JAX's bit for bit.

Sources:
  * SyntheticLM   — deterministic per-step synthetic token stream (Zipf-ish),
                    keyed by (seed, step, host) so restarts and elastic
                    re-sharding reproduce exactly the same global batches.
  * MemmapCorpus  — np.memmap token file; documents packed to seq_len with an
                    EOS separator; block-shuffled per epoch; disjoint per-host
                    shards.

Prefetcher overlaps host data preparation with device compute (one-deep
pipeline via a background thread), the host-side analogue of the paper's
compute/communication overlap.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM batches: batch[i] identical across runs."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0):
        assert global_batch % num_hosts == 0
        self.vocab, self.seq, self.gb = vocab, seq_len, global_batch
        self.seed, self.num_hosts, self.host_id = seed, num_hosts, host_id
        self.local_batch = global_batch // num_hosts

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        # Zipf-flavored marginal so CE starts near ln(V) but is learnable
        z = rng.zipf(1.3, size=(self.local_batch, self.seq + 1))
        tokens = (z - 1) % self.vocab
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pack_documents(docs, seq_len: int, eos: int) -> np.ndarray:
    """Pack variable-length docs into (n, seq_len+1) rows with EOS separators."""
    flat: list[int] = []
    for d in docs:
        flat.extend(int(t) for t in d)
        flat.append(eos)
    n = len(flat) // (seq_len + 1)
    if n == 0:
        raise ValueError("not enough tokens to pack a single row")
    arr = np.asarray(flat[: n * (seq_len + 1)], np.int32)
    return arr.reshape(n, seq_len + 1)


class MemmapCorpus:
    """Token-file corpus with deterministic block shuffling + host sharding."""

    def __init__(self, path: str, seq_len: int, global_batch: int, *, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0, dtype=np.int32):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq, self.gb = seq_len, global_batch
        self.seed, self.num_hosts, self.host_id = seed, num_hosts, host_id
        assert global_batch % num_hosts == 0
        self.local_batch = global_batch // num_hosts
        self.rows = len(self.tokens) // (seq_len + 1)
        if self.rows < global_batch:
            raise ValueError(f"corpus too small: {self.rows} rows < batch {global_batch}")

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(self.rows)

    def batch(self, step: int) -> dict:
        per_epoch = self.rows // self.gb
        epoch, within = divmod(step, per_epoch)
        perm = self._perm(epoch)
        base = within * self.gb + self.host_id * self.local_batch
        rows = perm[base : base + self.local_batch]
        L = self.seq + 1
        out = np.stack([self.tokens[r * L : (r + 1) * L] for r in rows]).astype(np.int32)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """One-deep background prefetch of an iterator."""

    _STOP = object()

    def __init__(self, it, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in it:
                    self.q.put(item)
            except Exception as e:  # surfaced on next()
                self._err = e
            finally:
                self.q.put(self._STOP)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._STOP:
            if self._err:
                raise self._err
            raise StopIteration
        return item
