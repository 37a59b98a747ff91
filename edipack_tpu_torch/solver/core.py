"""End-to-end normal-mode impurity solve (the reference `ed_solve` body,
ED_MAIN.f90:164-228): sector operators -> diagonalization -> Green's
functions -> observables, with all products retained on the result object
for the `ed_*` getters; counterpart of edipack_tpu.solver.core.

Routing of a sector's matvec (``ed_fused_matvec``), in the working dtype
(``ed_precision``: the f64 kernel B1 or the f32 kernel B2):
  * ``auto``   — the fused CUDA kernel (ops.fused_matvec) for sectors of
    dim >= 2^17 without phonons on a CUDA device, else KronMatvec;
  * ``always`` — the fused operator on any device (its plain PyTorch
    version on the CPU) wherever build_fused_normal applies;
  * ``never``  — KronMatvec.
The GF chains use the same operator (in the fused internal layout).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..bath.dmft_bath import DmftBath
from ..bath.functions import (delta_bath, g0and_bath, invg0_bath,
                              matsubara_grid, real_grid)
from ..config import EDConfig
from ..device import DTYPE, PhaseTimer, working_dtype
from ..models.normal import NormalSectorOp, build_normal_sector_op
from ..ops.fused_matvec import FusedKron
from ..ops.fused_normal import build_fused_normal
from ..ops.matvec import KronMatvec
from ..sectors import Sector, SectorTable
from ..umatrix import Umatrix
from .diag import DiagResult, diagonalize
from .greens import (GFMatrix, build_gf_normal, eval_dimp, eval_gf_normal,
                     sigma_normal)
from .observables import Observables, compute_observables_normal

FUSED_MIN_DIM = 1 << 17


def not_implemented(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"edipack_tpu_torch: {what} is not ported yet (ROADMAP.md queue A, "
        f"{item}); use edipack_tpu for it")


def check_supported(cfg: EDConfig) -> None:
    """Raise for every input this package does not solve yet."""
    if cfg.ed_mode != "normal":
        raise not_implemented(f"ed_mode={cfg.ed_mode}", "joint modes")
    if cfg.bath_type not in ("normal", "hybrid"):
        raise not_implemented(f"bath_type={cfg.bath_type}", "joint modes")
    if cfg.ed_finite_temp:
        raise not_implemented("ed_finite_temp", "extras")
    if cfg.chispin_flag or cfg.chidens_flag or cfg.chipair_flag \
            or cfg.chiexct_flag:
        raise not_implemented("susceptibilities (chi*_flag)", "extras")
    if cfg.rdm_flag:
        raise not_implemented("rdm_flag", "extras")
    if not cfg.ed_total_ud:
        raise not_implemented("ed_total_ud=False", "extras")


@dataclass
class SolveResult:
    cfg: EDConfig
    table: SectorTable
    diag: DiagResult
    gf: Optional[GFMatrix]
    obs: Observables
    bath: DmftBath
    hloc: np.ndarray
    um: Umatrix
    device: torch.device
    timings: Dict[str, float] = field(default_factory=dict)
    n_matvecs: int = 0

    def _zgrid(self, zeta, axis):
        if zeta is not None:
            return np.atleast_1d(np.asarray(zeta, complex))
        return matsubara_grid(self.cfg) if axis.startswith("m") \
            else real_grid(self.cfg)

    def get_gimp(self, zeta=None, axis="m", typ="n"):
        if typ != "n":
            raise ValueError("anomalous GF only exists in superc mode")
        return eval_gf_normal(self.cfg, self.gf, self._zgrid(zeta, axis))

    def get_g0imp(self, zeta=None, axis="m", typ="n"):
        return g0and_bath(self.cfg, self.bath, self.hloc,
                          self._zgrid(zeta, axis))

    def get_g0and(self, zeta=None, axis="m", typ="n"):
        return self.get_g0imp(zeta, axis, typ)

    def get_delta(self, zeta=None, axis="m", typ="n"):
        return delta_bath(self.cfg, self.bath, self._zgrid(zeta, axis))

    def get_sigma(self, zeta=None, axis="m", typ="n"):
        z = self._zgrid(zeta, axis)
        ig0 = invg0_bath(self.cfg, self.bath, self.hloc, z)
        return sigma_normal(self.cfg, self.get_gimp(z, axis, typ), ig0)

    def get_dimp(self, zeta=None, axis="m"):
        return eval_dimp(self.cfg, self.gf, self._zgrid(zeta, axis),
                         axis=axis[:1])

    @property
    def dens(self):
        return self.obs.dens

    @property
    def docc(self):
        return self.obs.docc

    @property
    def mag(self):
        return self.obs.mag

    @property
    def energies(self):
        return self.obs.energies

    @property
    def doubles(self):
        return self.obs.doubles

    @property
    def imp_info(self):
        return self.obs.imp_info

    @property
    def evals(self):
        """Energies of the retained state list (reference ed_get_evals)."""
        return np.array([st.energy for st in self.diag.state_list.states])

    @property
    def neigen_sector(self):
        return self.diag.neigen_sector

    @property
    def e0(self):
        return self.diag.e0


def _normal_builders(cfg: EDConfig, table: SectorTable, hloc: np.ndarray,
                     um: Umatrix, bath: DmftBath, device: torch.device):
    """Operator / matvec builders of the normal-mode solve (cached per
    sector)."""
    dtype = working_dtype(cfg)
    op_cache: Dict[int, NormalSectorOp] = {}
    mv_cache: Dict[int, object] = {}
    dense_cache: Dict[int, Tuple] = {}

    def get_op(sec: Sector) -> NormalSectorOp:
        if sec.index not in op_cache:
            op_cache[sec.index] = build_normal_sector_op(cfg, sec, hloc, um,
                                                         bath)
        return op_cache[sec.index]

    def _try_fused(sec: Sector) -> Optional[FusedKron]:
        mode = cfg.ed_fused_matvec
        if mode == "never":
            return None
        if mode == "auto" and (device.type != "cuda"
                               or sec.dim < FUSED_MIN_DIM):
            return None
        fop = build_fused_normal(get_op(sec), cfg.norb)
        return None if fop is None else FusedKron(fop, device, dtype=dtype)

    def matvec_builder(sec: Sector):
        if sec.index not in mv_cache:
            mv = _try_fused(sec)
            if mv is None:
                mv = KronMatvec(get_op(sec), device, dtype=dtype)
            if cfg.ed_verbose >= 4:
                print(f"[edipack_tpu_torch:DEBUG] sector {sec.index} "
                      f"dim={sec.dim} (dw={sec.dim_dw}, up={sec.dim_up}, "
                      f"ph={sec.dim_ph}) -> {type(mv).__name__}")
            mv_cache[sec.index] = mv
        return mv_cache[sec.index]

    def dense_builder(sec: Sector) -> np.ndarray:
        return get_op(sec).to_dense()

    def dense_eig_cache(isec: int):
        """Full eigh of small sectors, cached, for exact GF moments."""
        sec = table.sector(isec)
        if sec.dim > cfg.lanc_dim_threshold:
            return None
        if isec not in dense_cache:
            evals, evecs = np.linalg.eigh(dense_builder(sec))
            dense_cache[isec] = (evals, torch.as_tensor(evecs, dtype=DTYPE,
                                                        device=device))
        return dense_cache[isec]

    return SimpleNamespace(matvec_builder=matvec_builder,
                           dense_builder=dense_builder,
                           dense_eig_cache=dense_eig_cache,
                           op_cache=op_cache, mv_cache=mv_cache)


def solve_impurity(cfg: EDConfig, hloc: np.ndarray, um: Umatrix,
                   bath: DmftBath, device: torch.device,
                   neigen_override: Optional[np.ndarray] = None,
                   sector_mask: Optional[np.ndarray] = None,
                   flag_gf: bool = True) -> SolveResult:
    cfg.validate()
    check_supported(cfg)
    timer = PhaseTimer(device, verbose=cfg.ed_verbose)
    table = SectorTable(cfg)
    b = _normal_builders(cfg, table, hloc, um, bath, device)

    with timer.phase("diagonalization"):
        diag = diagonalize(cfg, table, b.matvec_builder, b.dense_builder,
                           device, neigen_override=neigen_override,
                           sector_mask=sector_mask)
    gf = GFMatrix()
    if flag_gf:
        with timer.phase("greens_functions"):
            gf = build_gf_normal(cfg, table, diag.state_list,
                                 b.matvec_builder, b.dense_eig_cache)
    with timer.phase("observables"):
        obs = compute_observables_normal(cfg, table, diag.state_list, hloc,
                                         um, b.op_cache)
    return SolveResult(cfg=cfg, table=table, diag=diag, gf=gf, obs=obs,
                       bath=bath.copy(), hloc=np.asarray(hloc), um=um,
                       device=device, timings=dict(timer.timings),
                       n_matvecs=sum(mv.n_calls
                                     for mv in b.mv_cache.values()))
