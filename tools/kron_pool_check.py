"""Peak device memory of config 3's blocked-Kron solve with the CUDA
graphs of each JointKronMatvec in one memory pool against one private pool
a graph, on a CUDA card. A measurement script, not part of the package:

    python3 tools/kron_pool_check.py

It first solves config 3 through the ELL and blocked-Kron routes and
config 4 through the ELL (chip_smoke.py's joint (b, c) solves, their
routes held to each other, config 4's GF rebuilt one chain at a time),
then config 3's Kron route three times in turns: private pools
(``torch.cuda.graph_pool_handle`` patched to give none, so each capture
takes its own), one pool an operator, private pools. Each line gives the
solve's peak allocated and reserved device memory.
"""
import contextlib
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from edipack_tpu_torch.profile_solve import (CONFIG3, CONFIG4,  # noqa: E402
                                             spin_mixing_hloc)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kron_pool_check: needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    h3, kron = np.zeros((1, 1, 2, 2)), dict(ed_joint_kron="always")
    t0 = time.perf_counter()
    ell = cs._joint_solve("config 3 superc, ELL", CONFIG3, h3, {})
    blk = cs._joint_solve("config 3 superc, blocked-Kron", CONFIG3, h3, kron)
    cs._cross_check("config 3", ell, blk, kron)
    c4 = cs._joint_solve("config 4 nonsu2, ELL", CONFIG4,
                         spin_mixing_hloc(2), {})
    cs._gf_one_at_a_time("config 4, ELL", c4["res"])
    print(f"done in {time.perf_counter() - t0:.1f} s")
    for kind in ("private", "shared", "private"):
        with mock.patch.object(torch.cuda, "graph_pool_handle",
                               lambda: None) if kind == "private" \
                else contextlib.nullcontext():
            cs._joint_solve(f"config 3 blocked-Kron, {kind} pools", CONFIG3,
                            h3, kron)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
