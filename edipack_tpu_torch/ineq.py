"""Inequivalent impurities (real-space DMFT): Nineq impurity problems per
DMFT iteration, solved on one device.

Parity target: reference src/ineq (E2I_MAIN.f90): per-site interaction
overrides (``Uloc_ii``, ``Ust_ii``, ``Jh_ii``, ``Jx_ii``, ``Jp_ii``,
E2I_MAIN.f90:174-178, 261-265), the GF skip ``flag_gf`` (:179), a per-site
Hloc (E2I_AUX_FUNX ed_set_Hloc lattice overloads) and the getters stacked
over a leading Nineq axis (E2I_IO); counterpart of edipack_tpu.ineq.

Normal mode runs every site as one sweep (solver.core.solve_impurity_sites:
the dense sectors of all sites share the batched eigh buckets, the large
sectors run through each site's operator); superc and nonsu2 run the sites
one after another through EDSolver.solve. Each site writes its files with
the suffix ``_ineq%04d`` (site numbers from 1).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import io as edio
from .config import EDConfig, get_config
from .device import resolve_device
from .main import DeviceLike, EDSolver


class EDIneqSolver:
    """Nineq impurity solvers that share one configuration and device."""

    def __init__(self, nineq: int, cfg: Optional[EDConfig] = None,
                 device: DeviceLike = "cuda"):
        self.nineq = nineq
        self.cfg = cfg or get_config()
        self.device = resolve_device(device)
        self.solvers = [EDSolver(self.cfg.replace(
            ed_file_suffix=f"_ineq{n + 1:04d}"), device=self.device)
            for n in range(nineq)]

    def init_solver(self, baths: Optional[np.ndarray] = None) -> np.ndarray:
        """Each site's bath (from ``baths[n]``, else its restart file or the
        default); returns the (Nineq, Nb) stack."""
        return np.stack([s.init_solver(None if baths is None else baths[n])
                         for n, s in enumerate(self.solvers)])

    def set_hloc(self, hloc_ineq: np.ndarray) -> None:
        """Per-site Hloc with a leading Nineq axis ((Nineq, Nspin, Nspin,
        Norb, Norb) or (Nineq, Nso, Nso)), or one Hloc for every site."""
        h = np.asarray(hloc_ineq)
        per_site = h.ndim >= 2 and h.shape[0] == self.nineq and (
            h.ndim == 5 or (h.ndim == 3 and h.shape[1] == h.shape[2]))
        for n, s in enumerate(self.solvers):
            s.set_hloc(h[n] if per_site else h)

    def solve(self, baths: Optional[np.ndarray] = None,
              uloc_ii: Optional[np.ndarray] = None,
              ust_ii: Optional[np.ndarray] = None,
              jh_ii: Optional[np.ndarray] = None,
              jx_ii: Optional[np.ndarray] = None,
              jp_ii: Optional[np.ndarray] = None,
              flag_gf: bool = True) -> List:
        """Solve every site; the ``*_ii`` arrays override the Kanamori
        couplings per site (uloc_ii (Nineq, Norb), the others (Nineq,))."""
        for n, s in enumerate(self.solvers):
            over = {}
            if uloc_ii is not None:
                over["uloc"] = list(np.atleast_2d(uloc_ii)[n])
            for name, arr in (("ust", ust_ii), ("jh", jh_ii), ("jx", jx_ii),
                              ("jp", jp_ii)):
                if arr is not None:
                    over[name] = float(np.atleast_1d(arr)[n])
            if over:
                s.cfg = s.cfg.replace(**over)
        if self.cfg.ed_mode == "normal":
            return self._solve_batched(baths, flag_gf)
        return [s.solve(None if baths is None else baths[n], flag_gf=flag_gf)
                for n, s in enumerate(self.solvers)]

    def _solve_batched(self, baths, flag_gf: bool) -> List:
        """The normal-mode sweep over all sites. As in edipack_tpu, it reads
        no state_list/sectors restart file, carries no finite-T budget from
        one call to the next, and takes no complex-Hloc route."""
        from .bath.dmft_bath import array_to_bath
        from .solver.core import solve_impurity_sites
        from .umatrix import build_umatrix
        cfgs, hlocs, ums, site_baths, neigens = [], [], [], [], []
        for n, s in enumerate(self.solvers):
            if baths is not None:
                s.bath = array_to_bath(baths[n], s.cfg, s.basis)
            cfgs.append(s.cfg)
            hlocs.append(s.hloc)
            ums.append(build_umatrix(s.cfg, runtime_terms=s.runtime_terms))
            site_baths.append(s.bath)
            neigens.append(s.result.diag.neigen_sector
                           if s.result is not None
                           and s.neigen_sector_override is None
                           else s.neigen_sector_override)
        results = solve_impurity_sites(self.cfg, hlocs, ums, site_baths,
                                       self.device, cfgs=cfgs,
                                       neigen_overrides=neigens,
                                       flag_gf=flag_gf)
        for s, res in zip(self.solvers, results):
            s.result = res
            if s.cfg.ed_write_files:
                edio.write_all_outputs(s.cfg, res)
        return results

    def finalize(self) -> None:
        for s in self.solvers:
            s.finalize()

    # -- getters stacked over sites (reference E2I_IO) ----------------------
    def _stack(self, fn):
        return np.stack([fn(s) for s in self.solvers])

    def get_sigma(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_sigma(zeta, axis, typ))

    def get_gimp(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_gimp(zeta, axis, typ))

    def get_g0imp(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_g0imp(zeta, axis, typ))

    def get_dimp(self, zeta=None, axis="m"):
        return self._stack(lambda s: s.result.get_dimp(zeta, axis))

    def get_chi(self, kind="spin", zeta=None, axis="m"):
        return self._stack(lambda s: s.result.get_chi(kind, zeta, axis))

    def get_dens(self):
        return self._stack(lambda s: s.result.dens)

    def get_docc(self):
        return self._stack(lambda s: s.result.docc)

    def get_mag(self, component: str = "z"):
        comp = {"x": 0, "y": 1, "z": 2}[component]
        return self._stack(lambda s: s.result.mag[comp])

    def get_phi(self):
        return self._stack(lambda s: s.result.phisc)

    def get_argphi(self):
        return self._stack(lambda s: s.result.argphi)

    def get_exct(self):
        return self._stack(lambda s: s.result.exct)

    def get_eimp(self):
        return self._stack(lambda s: s.result.energies)

    def get_doubles(self):
        return self._stack(lambda s: s.result.doubles)

    def get_evals(self):
        return [s.result.evals for s in self.solvers]

    def get_neigen_sector(self):
        return self._stack(lambda s: s.result.neigen_sector)

    def get_rdm(self):
        return self._stack(lambda s: s.result.get_rdm())

    def get_sp_dm(self):
        return self._stack(lambda s: s.result.single_particle_dm)

    def fit_gf(self, funcs, baths, ispin=1):
        """The χ² bath fit of every site to ``funcs[n]`` (host CPU tensors,
        as bath/fit.py does for one site); returns the (Nineq, Nb) stack."""
        from .bath.fit import chi2_fitgf
        return np.stack([chi2_fitgf(s.cfg, funcs[n], baths[n], ispin=ispin,
                                    basis=s.basis)
                         for n, s in enumerate(self.solvers)])
