"""End-to-end impurity solve (the reference `ed_solve` body,
ED_MAIN.f90:164-228): sector operators -> diagonalization -> Green's
functions -> observables -> susceptibilities -> impurity RDM, with all
products retained on the result object for the `ed_*` getters; counterpart
of edipack_tpu.solver.core. superc and nonsu2 solves go to
solver.core_joint.solve_impurity_joint; several normal-mode sites
(real-space DMFT) go to :func:`solve_impurity_sites` as one sweep.

Routing of a sector's matvec (``ed_fused_matvec``), in the working dtype
(``ed_precision``: the f64 kernel B1 or the f32 kernel B2):
  * ``auto``   — the fused CUDA kernel (ops.fused_matvec) for sectors of
    dim >= 2^17 without phonons on a CUDA device, else KronMatvec;
  * ``always`` — the fused operator on any device (its plain PyTorch
    version on the CPU) wherever build_fused_normal applies;
  * ``never``  — KronMatvec.
The GF and susceptibility chains use the same operator (in the fused
internal layout).

Multi-GPU (parallel.mesh): under an initialized process group of more than
one rank, every rank runs the same solve; a sector of dim >
4·lanc_dim_threshold whose dw dimension the world size divides (the JAX
package's rule) is split over the ranks by its dw rows — through B1/B2 on
a row range where the fused route applies, else ShardedKronMatvec — and
the dense buckets are shared. Every rank returns the same result.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bath.dmft_bath import DmftBath
from ..bath.functions import (delta_bath, fdelta_bath, g0and_bath,
                              invf0_bath, invg0_bath, matsubara_grid,
                              real_grid)
from ..config import EDConfig
from ..device import DTYPE, PhaseTimer, working_dtype
from ..models.normal import NormalSectorOp, build_normal_sector_op
from ..ops.fused_matvec import FusedKron, ShardedFusedKron
from ..ops.fused_normal import build_fused_normal
from ..ops.matvec import KronMatvec, ShardedKronMatvec
from ..parallel.mesh import make_mesh, shard_normal
from ..sectors import Sector, SectorTable
from ..umatrix import Umatrix
from .diag import DiagResult, diagonalize, diagonalize_sites
from .greens import (GFMatrix, build_gf_normal, eval_dimp, eval_gf_normal,
                     sigma_normal)
from .chi import build_chi_normal
from .observables import Observables, compute_observables_normal
from .rdm import impurity_rdm_normal

FUSED_MIN_DIM = 1 << 17


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
    chi: Optional[GFMatrix] = None
    rdm: Optional[np.ndarray] = None
    hloc_anomalous: Optional[np.ndarray] = None

    def _zgrid(self, zeta, axis):
        if zeta is not None:
            return np.atleast_1d(np.asarray(zeta, complex))
        return matsubara_grid(self.cfg) if axis.startswith("m") \
            else real_grid(self.cfg)

    def get_gimp(self, zeta=None, axis="m", typ="n"):
        """G (typ "n") or, in superc, the anomalous F (typ "a"):
        (Nspin, Nspin, Norb, Norb, Lz); nonsu2 fills the spin blocks."""
        z = self._zgrid(zeta, axis)
        mode = self.cfg.ed_mode
        if mode == "superc":
            from .core_joint import eval_gf_superc
            g, f, _ = eval_gf_superc(self.cfg, self.gf, z)
            return g if typ == "n" else f
        if typ != "n":
            raise ValueError("anomalous GF only exists in superc mode")
        if mode == "nonsu2":
            from .core_joint import eval_gf_nonsu2
            return eval_gf_nonsu2(self.cfg, self.gf, z)
        return eval_gf_normal(self.cfg, self.gf, z)

    def get_g0imp(self, zeta=None, axis="m", typ="n"):
        return g0and_bath(self.cfg, self.bath, self.hloc,
                          self._zgrid(zeta, axis))

    def get_g0and(self, zeta=None, axis="m", typ="n"):
        return self.get_g0imp(zeta, axis, typ)

    def get_delta(self, zeta=None, axis="m", typ="n"):
        fn = delta_bath if typ == "n" else fdelta_bath
        return fn(self.cfg, self.bath, self._zgrid(zeta, axis))

    def get_sigma(self, zeta=None, axis="m", typ="n"):
        """Σ (typ "n") or, in superc, the anomalous self-energy (typ "a")
        by the Nambu Dyson equation."""
        z = self._zgrid(zeta, axis)
        ig0 = invg0_bath(self.cfg, self.bath, self.hloc, z)
        if self.cfg.ed_mode == "superc":
            from .core_joint import eval_gf_superc, sigma_superc
            g, f, _ = eval_gf_superc(self.cfg, self.gf, z)
            # F21 = F evaluated at conj(z) (reference get_impF_superc
            # zconj=.true.), the Nambu 21 block as conj(F21)^T
            _, f21, _ = eval_gf_superc(self.cfg, self.gf, np.conj(z))
            if0 = invf0_bath(self.cfg, self.bath, self.hloc_anomalous, z)
            sigma, self_ = sigma_superc(self.cfg, g, f, ig0, if0,
                                        axis=axis[:1], f21=f21)
            return sigma if typ == "n" else self_
        return sigma_normal(self.cfg, self.get_gimp(z, axis, typ), ig0)

    def get_self(self, zeta=None, axis="m"):
        """Anomalous self-energy (superc; reference get_Self_superc)."""
        return self.get_sigma(zeta, axis, typ="a")

    def get_dimp(self, zeta=None, axis="m"):
        return eval_dimp(self.cfg, self.gf, self._zgrid(zeta, axis),
                         axis=axis[:1])

    def get_chi(self, kind="spin", zeta=None, axis="m"):
        if self.chi is None:
            raise RuntimeError(
                f"chi_{kind} was not computed (enable chi{kind}_flag)")
        z = self._zgrid(zeta, axis)
        norb = self.cfg.norb
        out = np.zeros((norb, norb, len(z)), complex)
        for a in range(norb):
            for b in range(norb):
                out[a, b] = self.chi.eval((kind, a, b), z)
        return out

    def get_rdm(self, norbs=None):
        if self.rdm is None:
            raise RuntimeError("rdm was not computed (enable rdm_flag)")
        return self.rdm

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
    def single_particle_dm(self):
        return self.obs.sp_dm

    @property
    def phisc(self):
        p = self.obs.phisc
        return p if p is not None else np.zeros(self.cfg.norb)

    @property
    def argphi(self):
        p = self.obs.argphi
        return p if p is not None else np.zeros(self.cfg.norb)

    @property
    def exct(self):
        e = self.obs.exct
        return e if e is not None else np.zeros((4, self.cfg.norb,
                                                 self.cfg.norb))

    @property
    def evals(self):
        """Energies of the retained state list (reference ed_get_evals)."""
        return np.array([st.energy for st in self.diag.state_list.states])

    @property
    def evals_all(self):
        """All computed sector eigenvalues, ascending."""
        parts = list(self.diag.evals_by_sector.values())
        return np.sort(np.concatenate(parts)) if parts else np.zeros(0)

    @property
    def neigen_sector(self):
        return self.diag.neigen_sector

    @property
    def e0(self):
        return self.diag.e0


def _solve_mesh(cfg: EDConfig, device: torch.device):
    """The mesh of the solve (parallel.mesh.make_mesh), or None; printed
    at ed_verbose >= 2."""
    mesh = make_mesh(device)
    if mesh is not None and cfg.ed_verbose >= 2:
        print(f"[edipack_tpu_torch] {mesh}")
    return mesh


def _normal_builders(cfg: EDConfig, table: SectorTable, hloc: np.ndarray,
                     um: Umatrix, bath: DmftBath, device: torch.device,
                     mesh=None):
    """Operator / matvec builders of the normal-mode solve (cached per
    sector); with ``mesh``, the sectors :func:`shard_normal` selects are
    split over its ranks."""
    dtype = working_dtype(cfg)
    op_cache: Dict[int, NormalSectorOp] = {}
    mv_cache: Dict[int, object] = {}
    dense_cache: Dict[int, Tuple] = {}

    def get_op(sec: Sector) -> NormalSectorOp:
        if sec.index not in op_cache:
            op_cache[sec.index] = build_normal_sector_op(cfg, sec, hloc, um,
                                                         bath)
        return op_cache[sec.index]

    def _try_fused(sec: Sector, shard: bool) -> Optional[FusedKron]:
        mode = cfg.ed_fused_matvec
        if mode == "never":
            return None
        if mode == "auto" and (device.type != "cuda"
                               or sec.dim < FUSED_MIN_DIM):
            return None
        fop = build_fused_normal(get_op(sec), cfg.norb)
        if fop is None:
            return None
        if shard:
            return ShardedFusedKron(fop, device, dtype, mesh)
        return FusedKron(fop, device, dtype=dtype)

    def matvec_builder(sec: Sector):
        if sec.index not in mv_cache:
            shard = mesh is not None and shard_normal(
                sec.dim, sec.dim_dw, cfg.lanc_dim_threshold, mesh.world)
            mv = _try_fused(sec, shard)
            if mv is None:
                mv = ShardedKronMatvec(get_op(sec), device, dtype, mesh) \
                    if shard else KronMatvec(get_op(sec), device, dtype=dtype)
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


def _finish_normal_site(cfg: EDConfig, table: SectorTable, b,
                        diag: DiagResult, hloc: np.ndarray, um: Umatrix,
                        bath: DmftBath, device: torch.device, flag_gf: bool,
                        timer: PhaseTimer) -> SolveResult:
    """Green's functions, observables, χ and the impurity RDM of one site
    from its DiagResult, each phase timed by ``timer``."""
    gf = GFMatrix()
    if flag_gf:
        with timer.phase("greens_functions"):
            gf = build_gf_normal(cfg, table, diag.state_list,
                                 b.matvec_builder, b.dense_eig_cache)
    with timer.phase("observables"):
        obs = compute_observables_normal(cfg, table, diag.state_list, hloc,
                                         um, b.op_cache)
    chi = None
    if flag_gf and (cfg.chispin_flag or cfg.chidens_flag or cfg.chipair_flag
                    or cfg.chiexct_flag):
        with timer.phase("susceptibilities"):
            chi = build_chi_normal(cfg, table, diag.state_list,
                                   b.matvec_builder, b.dense_eig_cache)
    rdm = None
    if cfg.rdm_flag:
        with timer.phase("impurity_rdm"):
            rdm = impurity_rdm_normal(cfg, table, diag.state_list)
    return SolveResult(cfg=cfg, table=table, diag=diag, gf=gf, obs=obs,
                       bath=bath.copy(), hloc=np.asarray(hloc), um=um,
                       device=device, timings=dict(timer.timings),
                       n_matvecs=sum(mv.n_calls
                                     for mv in b.mv_cache.values()),
                       chi=chi, rdm=rdm)


def solve_impurity_sites(cfg: EDConfig, hlocs, ums, baths,
                         device: torch.device, cfgs=None,
                         neigen_overrides=None, sector_masks=None,
                         flag_gf: bool = True) -> List[SolveResult]:
    """Solve Nineq normal-mode impurity problems as one site-batched sweep
    (counterpart of edipack_tpu.solver.core.solve_impurity_sites).

    The sites share one SectorTable; each has its own operator builders
    (Hloc, U, bath; ``cfgs[s]`` may change the interaction values), and
    their dense sectors share the batched eigh buckets of
    :func:`~.diag.diagonalize_sites`. The sites must share the sector
    structure: norb, nbath, nspin, nph, ed_total_ud, bath_type, ed_mode.
    Each site's result times its own phases; its "diagonalization" is the
    whole sweep's time, the same for every site.
    """
    nsites = len(hlocs)
    if cfgs is None:
        cfgs = [cfg] * nsites
    key = lambda c: (c.norb, c.nbath, c.nspin, c.nph, c.ed_total_ud,
                     c.bath_type, c.ed_mode)
    for c in cfgs:
        c.validate()
        if key(c) != key(cfg):
            raise ValueError("solve_impurity_sites: sites must share the "
                             "sector structure")
    table = SectorTable(cfg)
    mesh = _solve_mesh(cfg, device)
    builders = [_normal_builders(cfgs[s], table, hlocs[s], ums[s], baths[s],
                                 device, mesh) for s in range(nsites)]
    timer = PhaseTimer(device, verbose=cfg.ed_verbose)
    with timer.phase("diagonalization"):
        diags = diagonalize_sites(
            cfg, table, [b.matvec_builder for b in builders],
            [b.dense_builder for b in builders], device,
            neigen_overrides=neigen_overrides, sector_masks=sector_masks,
            mesh=mesh)
    out = []
    for s in range(nsites):
        site_timer = PhaseTimer(device)
        site_timer.timings.update(timer.timings)
        out.append(_finish_normal_site(cfgs[s], table, builders[s], diags[s],
                                       hlocs[s], ums[s], baths[s], device,
                                       flag_gf, site_timer))
    return out


def solve_impurity(cfg: EDConfig, hloc: np.ndarray, um: Umatrix,
                   bath: DmftBath, device: torch.device,
                   neigen_override: Optional[np.ndarray] = None,
                   sector_mask: Optional[np.ndarray] = None,
                   hloc_anomalous: Optional[np.ndarray] = None,
                   flag_gf: bool = True) -> SolveResult:
    cfg.validate()
    if cfg.ed_mode != "normal":
        from .core_joint import solve_impurity_joint
        return solve_impurity_joint(cfg, hloc, um, bath, device,
                                    neigen_override=neigen_override,
                                    sector_mask=sector_mask,
                                    hloc_anomalous=hloc_anomalous,
                                    flag_gf=flag_gf)
    timer = PhaseTimer(device, verbose=cfg.ed_verbose,
                       trace_dir=cfg.ed_profile_dir)
    table = SectorTable(cfg)
    mesh = _solve_mesh(cfg, device)
    b = _normal_builders(cfg, table, hloc, um, bath, device, mesh)
    with timer:     # the solve's trace, where a trace directory is set
        with timer.phase("diagonalization"):
            diag = diagonalize(cfg, table, b.matvec_builder, b.dense_builder,
                               device, neigen_override=neigen_override,
                               sector_mask=sector_mask, mesh=mesh)
        return _finish_normal_site(cfg, table, b, diag, hloc, um, bath,
                                   device, flag_gf, timer)
