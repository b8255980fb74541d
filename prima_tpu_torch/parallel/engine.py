"""The slot record of the distributed engines.

Counterpart of the DSlot of prima_tpu/parallel/engine.py (:43). Only the
TCP ring (parallel/ring_tcp.py) uses it in the port: slot (m, b) is row b
of ubatch group m. The SPMD mesh engine of that module, over NCCL across
several cards, comes with the mesh slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..runtime.engine import SlotState
from ..sampling import Sampler


@dataclass
class DSlot:
    m: int
    b: int
    n_slots_b: int = 1  # rows per group (for the flat id)
    state: SlotState = SlotState.IDLE
    prompt: list[int] = field(default_factory=list)
    n_prompt_done: int = 0
    generated: list[int] = field(default_factory=list)
    sampler: Sampler | None = None
    n_predict: int = -1
    request_id: Any = None
    stop_reason: str | None = None
    n_probs: int = 0
    shifts: list = field(default_factory=list)
    # Self-Extend grouped attention (main.cpp:618-640)
    ga_i: int = 0
    pos_delta: int = 0  # logical (RoPE) position - physical write index
    pos_map: Any = None  # per-cell logical positions (lazy)

    @property
    def id(self) -> int:
        """Flat slot id (server-visible, like the reference's slot.id)."""
        return self.m * self.n_slots_b + self.b
