"""Retained low-energy spectrum (the reference's `state_list`).

Parity target: ED_EIGENSPACE.f90 (:17-39 sparse_espace, es_add_state
:250-308, trimming semantics in ED_DIAG post_diag :382-519). Linked lists
become a plain sorted Python list of :class:`EigenState`; eigenvectors stay
as device arrays (the reference keeps them MPI-distributed, :723-793).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class EigenState:
    energy: float
    sector: int            # sector index in the SectorTable
    vector: object         # device array (dim,) in the sector basis
    twin_of: Optional[int] = None  # sector this was reconstructed from


@dataclass
class StateList:
    states: List[EigenState] = field(default_factory=list)
    beta: float = 1000.0

    def add(self, st: EigenState) -> None:
        self.states.append(st)

    def sort(self) -> None:
        self.states.sort(key=lambda s: s.energy)

    @property
    def e0(self) -> float:
        return min(s.energy for s in self.states)

    def energies(self) -> np.ndarray:
        return np.array([s.energy for s in self.states])

    def partition_function(self) -> float:
        e0 = self.e0
        return float(np.exp(-self.beta * (self.energies() - e0)).sum())

    def boltzmann_weights(self) -> np.ndarray:
        """w_i = exp(-beta (E_i - E0)) / Z."""
        e0 = self.e0
        w = np.exp(-self.beta * (self.energies() - e0))
        return w / w.sum()

    def trim(self, finite_temp: bool, cutoff: float, gs_threshold: float,
             max_states: int) -> "StateList":
        """Reference post-diag trimming: at T=0 keep the ground multiplet
        (E - E0 <= gs_threshold); at finite T keep the lowest max_states with
        Boltzmann factor above cutoff (ED_DIAG_NORMAL.f90:382-519)."""
        self.sort()
        e0 = self.e0
        kept = []
        for i, s in enumerate(self.states):
            if not finite_temp:
                if s.energy - e0 <= gs_threshold:
                    kept.append(s)
            else:
                if i < max_states and np.exp(-self.beta * (s.energy - e0)) > cutoff:
                    kept.append(s)
        return StateList(kept, self.beta)

    def __len__(self):
        return len(self.states)

    def __iter__(self):
        return iter(self.states)
