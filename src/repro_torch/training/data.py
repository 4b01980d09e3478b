"""Deterministic synthetic data pipeline with background prefetch (carried
from ``repro/training/data.py``: numpy, so the tokens equal the reference's
seed for seed).

State (the step counter) is checkpointable, so restart resumes the exact
token stream.  Per-host sharding follows (host_id, num_hosts); batches carry
``tokens`` and next-token ``labels`` plus modality stubs per config.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokenPipeline:
    def __init__(self, cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        assert global_batch % num_hosts == 0
        self.cfg = cfg
        self.batch = global_batch // num_hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_id
        self.num_hosts = num_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, self.host, step))
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.batch, self.seq + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.cfg.rope_style == "mrope":
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32)[None, :, None],
                                  (self.batch, self.seq, 3))
            batch["positions"] = np.ascontiguousarray(pos)
        if self.cfg.encoder_layers > 0:
            batch["frame_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=np.float32) * 0.02
        if self.cfg.frontend == "vision_patches":
            batch["patch_embeds"] = rng.standard_normal(
                (self.batch, 256, self.cfg.d_model), dtype=np.float32) * 0.02
        return batch

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(( step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self):
        return self

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def close(self):
        self._stop.set()
