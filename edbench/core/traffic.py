"""The one generator of traffic: the baths a DMFT driver hands to the
solver, one a solve, made from a configuration's default bath, a mix's
parameters and the run's seed.

Each bath is the default bath (the configuration's reference module
gives it: a dict of arrays) moved as a DMFT loop moves it between
iterations. The mix's ``bath_moves`` names, for each array, its move:
``{"abs": s}`` adds s times a standard normal draw to every entry,
``{"rel": s}`` scales every entry by 1 + s times one. An array the
default bath lacks is left out. Every solve's move is drawn afresh from
the default, so every seed gives solves of the same kind of work.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def baths(base: Dict[str, np.ndarray], mix: dict, seed: int, stream: int
          ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless baths of one stream (0: warm-up, 1: the window and the
    traced span) of ``seed``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])
    moves = [(k, mv) for k, mv in mix["bath_moves"].items() if k in base]
    while True:
        b = {k: np.array(v, float) for k, v in base.items()}
        for key, mv in moves:
            draw = rng.standard_normal(b[key].shape)
            if "abs" in mv:
                b[key] += mv["abs"] * draw
            else:
                b[key] *= 1.0 + mv["rel"] * draw
        yield b
