"""Deterministic synthetic data streams, reproducible from (seed, index):
no files, no global state. The port's copy of the reference's
``repro.data.pipeline`` (numpy only):

  * ``LmTokenStream`` — seeded synthetic LM batches (zipf-ish marginals,
    the second half of each row a copy of the first, so a model can
    reduce the loss below ln(V)): the training substrate, the reference's
    batches bit for bit for every (seed, step).
  * ``VideoRequestStream`` — the paper's workload: a "video" whose frames
    are independent inference units, for the detector testbed
    (``core.testbed``) and the serving example, as frames or as token
    prompts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class LmTokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        base = rng.zipf(1.3, size=(self.batch_size, self.seq_len))
        tokens = np.minimum(base - 1, self.vocab_size - 1).astype(np.int32)
        half = self.seq_len // 2
        tokens[:, half:half * 2] = tokens[:, :half]
        return {"tokens": tokens}

    def batches(self, start: int = 0) -> Iterator[dict]:
        step = start
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class VideoRequestStream:
    """A video = n_frames independent units (paper: 30 s of video)."""

    n_frames: int = 900           # 30 s @ 30 fps
    frame_shape: tuple = (128, 128, 3)
    seed: int = 0

    def frames(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.standard_normal(
            (self.n_frames, *self.frame_shape), dtype=np.float32)

    def prompt_requests(self, vocab_size: int, prompt_len: int = 64
                        ) -> list[np.ndarray]:
        """The LLM-serving analogue: independent prompt requests."""
        rng = np.random.default_rng(self.seed)
        return [rng.integers(0, vocab_size, size=(prompt_len,),
                             dtype=np.int32)
                for _ in range(self.n_frames)]
