"""The serving workload that ``chip_smoke.py`` drives and ``profile_serve``
profiles: yi-6b at full size with a luq_fp4 logits head on the ``cuda``
backend, 4 slots of 1024 positions, 8 greedy requests with prompts of
64-512 tokens and 32 new tokens each.  One definition, so the two read
the same run.
"""
from __future__ import annotations

import numpy as np

ARCH = "yi-6b"
QUANT_FMT = "luq_fp4"
SEED = 0
SLOTS, MAX_SEQ = 4, 1024
REQUESTS, NEW_TOKENS = 8, 32
PROMPT_MIN, PROMPT_MAX = 64, 512


def prompts(vocab: int, seed: int = SEED) -> list[np.ndarray]:
    """The ``REQUESTS`` prompts, lengths uniform over the prompt range."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]
