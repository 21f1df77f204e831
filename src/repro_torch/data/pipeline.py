"""Deterministic synthetic data streams, reproducible from (seed, index):
no files, no global state. The port's copy of the reference's
``repro.data.pipeline`` (numpy only), so far its video stream:

  * ``VideoRequestStream`` — the paper's workload: a "video" whose frames
    are independent inference units, for the detector testbed
    (``core.testbed``) and the serving example, as frames or as token
    prompts.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
