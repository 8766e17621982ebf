"""Slot pool: host-side bookkeeping for the fixed-size decode batch.

The counterpart of ``repro.serve.slots``.  The engine allocates one
``max_slots x max_seq`` KV cache when it starts and never reallocates; a
*slot* is one row of that cache.  ``SlotPool`` owns which slots are free,
which request occupies each busy slot and how many tokens it may still
generate; the cache tensors live in the engine's cache dict.

    FREE -> (admit: prefill writes the prompt KV) -> ACTIVE
         -> (retire: budget exhausted / EOS / cache full) -> FREE
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class SlotState:
    """Host-side record of one occupied slot."""

    request_id: int
    remaining: int          # generation budget left (tokens)
    prompt_len: int


class SlotPool:
    """Free-list allocator over the ``n_slots`` rows of the slot cache.

    ``admissions`` counts acquires per slot so tests can assert reuse.
    """

    def __init__(self, n_slots: int):
        """Create a pool with all ``n_slots`` slots free."""
        if n_slots < 1:
            raise ValueError("SlotPool needs at least one slot")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._busy: Dict[int, SlotState] = {}
        self.admissions = [0] * n_slots

    @property
    def n_free(self) -> int:
        """Number of currently free slots."""
        return len(self._free)

    @property
    def n_active(self) -> int:
        """Number of currently occupied slots."""
        return len(self._busy)

    def state(self, slot: int) -> SlotState:
        """Return the occupant record of a busy ``slot``."""
        return self._busy[slot]

    def acquire(self, request_id: int, prompt_len: int,
                budget: int) -> Optional[int]:
        """Claim a free slot for ``request_id``; None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._busy[slot] = SlotState(request_id=request_id,
                                     remaining=budget,
                                     prompt_len=prompt_len)
        self.admissions[slot] += 1
        return slot

    def release(self, slot: int) -> SlotState:
        """Retire ``slot`` back to the free list and return its record."""
        state = self._busy.pop(slot)
        self._free.append(slot)
        return state


def init_slot_cache(model, n_slots: int, max_seq: int, kv_fmt: str = "none"):
    """The zero-filled slot cache dict for ``model``.

    Every array goes on the model's device, the (n_slots,) positions
    ``pos`` too.  Zeros matter: masked attention over a zero-padded cache equals
    attention over a shorter one, and a zero scale dequantizes any code to
    exactly 0, the invariant the engine restores when a slot retires.
    """
    if model.slot_cache_spec is None:
        raise ValueError(
            f"model family {model.config.family!r} does not implement "
            "slot-pool decoding (decode_slots/slot_cache_spec)")
    if kv_fmt not in model.kv_formats:
        raise ValueError(
            f"model family {model.config.family!r} does not support "
            f"kv_fmt={kv_fmt!r} (supported: {model.kv_formats})")
    spec = model.slot_cache_spec(n_slots, max_seq, kv_fmt=kv_fmt)
    return {name: torch.zeros(shape, dtype=dtype, device=model.device)
            for name, (shape, dtype) in spec.items()}
