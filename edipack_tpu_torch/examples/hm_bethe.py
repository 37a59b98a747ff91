"""Hubbard model on the Bethe lattice — single-band DMFT loop.

The canonical first DMFT calculation, the counterpart of
``examples/python/hm_bethe.py`` (and of the reference's
``examples/fortran/hm_bethe.f90``): the semicircular density of states of
the infinite-coordination Bethe lattice makes the self-consistency
closed-form,

    Delta(iw) = (D/2)^2 * G_loc(iw),   G_loc = G_imp,

so each iteration is: solve the impurity -> build the new hybridization
from G_imp -> mix -> check convergence -> chi^2-fit the bath to it ->
repeat. The loop, mixing, convergence test and outputs are those of
``examples/python/hm_bethe.py``.

Run:  python -m edipack_tpu_torch.examples.hm_bethe             (on CUDA)
      python -m edipack_tpu_torch.examples.hm_bethe device=cpu
      python -m edipack_tpu_torch.examples.hm_bethe uloc=4.0    (overrides)

It reads inputED.conf (else inputED.in) from the working directory, as
the reference's examples do (``examples/python/inputED.conf`` is the
single-band setting), and writes G_imp / Sigma on the Matsubara axis as
text files in ./ plus a convergence log. The solve runs on ``device``;
the bath fit on host CPU tensors (bath/fit.py).
"""
from __future__ import annotations

import os
import sys
from typing import Callable, List

import numpy as np

import edipack_tpu_torch as ed

WBAND = 1.0          # half-bandwidth D of the semicircular DOS
WMIX = 0.5           # linear mixing of the hybridization


def dmft_loop(cfg: ed.EDConfig, device: str = "cuda",
              log: Callable[[str], None] = print) -> List[dict]:
    """Run the Bethe-lattice DMFT loop of ``cfg`` (installed as the global
    config, which ed_chi2_fitgf reads) on ``device``. Returns one record
    per loop: its error, densities, the bath it solved, G and Σ on the
    Matsubara axis."""
    ed.set_config(cfg)
    bath = ed.ed_init_solver(cfg=cfg, device=device)
    ed.ed_set_hloc(np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)))
    history: List[dict] = []
    delta_prev = None
    for iloop in range(cfg.nloop):
        ed.ed_solve(bath)

        # Bethe self-consistency: Delta = (D/2)^2 G_imp
        gimp = ed.ed_get_gimp(axis="m")     # (Nspin,Nspin,Norb,Norb,Lmats)
        delta = (WBAND / 2.0) ** 2 * gimp
        if delta_prev is not None:
            delta = WMIX * delta + (1.0 - WMIX) * delta_prev

        # convergence on the hybridization (reference check_convergence on
        # the Weiss field)
        err = (1.0 if delta_prev is None else
               float(np.sum(np.abs(delta - delta_prev))
                     / max(np.sum(np.abs(delta)), 1e-15)))
        dens = ed.ed_get_dens()
        log(f"loop {iloop + 1:3d}  err {err:.3e}  dens {dens[0]:.6f}")
        history.append(dict(err=err, dens=np.asarray(dens), bath=bath,
                            gimp=gimp, sigma=ed.ed_get_sigma(axis="m")))
        delta_prev = delta
        if err < cfg.dmft_error:
            break

        # fit the bath to the new hybridization on the fit window
        bath = ed.ed_chi2_fitgf(delta[0, 0][..., :cfg.lfit], bath, ispin=1)
    return history


def main(argv: List[str]) -> int:
    device = "cuda"
    rest = []
    for tok in argv:
        key, _, val = tok.partition("=")
        if key.strip().lstrip("-").lower() == "device":
            device = val
        else:
            rest.append(tok)
    cfg = ed.ed_read_input("inputED.conf" if os.path.exists("inputED.conf")
                           else "inputED.in", argv=rest)
    wm = (2 * np.arange(cfg.lmats) + 1) * np.pi / cfg.beta
    dmft_loop(cfg, device, log=lambda s: print(s, flush=True))

    # ---- outputs (reference-style text files) ----------------------------
    gimp = ed.ed_get_gimp(axis="m")[0, 0, 0, 0]
    sigma = ed.ed_get_sigma(axis="m")[0, 0, 0, 0]
    np.savetxt("impG_iw.ed", np.column_stack([wm, gimp.imag, gimp.real]))
    np.savetxt("impSigma_iw.ed",
               np.column_stack([wm, sigma.imag, sigma.real]))
    print(f"done: dens={ed.ed_get_dens()[0]:.6f}; wrote impG_iw.ed "
          f"impSigma_iw.ed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
