"""Host data pipeline: deterministic synthetic LM stream; the port's own
copy of the JAX package's ``repro/data/pipeline.py`` (numpy only).

Learnable structure: a fixed random permutation f over the vocabulary;
sequences follow tok[t+1] = f(tok[t]) with jump probability eps, so a
model can drive the loss well below ln(V) by learning f.  Sharded across
hosts by process index (each host materializes only its slice of the
global batch) and double-buffered ahead of the step by a worker thread.
For the same arguments the batches equal the reference's bit for bit;
``close()`` stops the worker and joins it.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        jump_prob: float = 0.1,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        if global_batch % process_count:
            raise ValueError(f"global_batch {global_batch} is not a multiple of "
                             f"process_count {process_count}")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // process_count
        self.rng = np.random.default_rng(seed + 1000 * process_index)
        self.perm = np.random.default_rng(seed).permutation(vocab_size)
        self.jump = jump_prob
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self) -> dict:
        b, s = self.local_batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, b)
        jumps = self.rng.random((b, s)) < self.jump
        randoms = self.rng.integers(0, self.vocab, (b, s))
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(jumps[:, t], randoms[:, t], nxt)
        return {"tokens": toks}

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        """Stop the worker and wait for it (it checks every 0.1 s)."""
        self._stop.set()
        self._thread.join()
