"""File outputs and restart contracts (normal mode).

Parity targets (SURVEY.md §5 checkpoint/resume); counterpart of
edipack_tpu.io, with the same file names and column formats, so that a
restart file written by either package is read by the other:
  * observables_{info,last,all}.ed, energy_{info,last}.ed text metrics
    (reference write_obs_* ED_OBSERVABLES_NORMAL.f90:968-1210)
  * state_list.restart — per-retained-state sector quantum numbers, used to
    seed neigen_sector on restart (ED_SETUP.f90:557-590)
  * sectors.restart (SectorFile) — restrict the diagonalization sweep to
    listed sectors ± ed_sectors_shift (ED_DIAG_NORMAL.f90:311-371)
  * xmu.restart — chemical potential + step for fixed-density runs
  * hamiltonian.restart — bath parameters (bath/dmft_bath.py)
  * GFmatrix npz store (solver/greens.py GFMatrix.save/load)

Not here yet: the finite-T state histogram and the susceptibility files
(ROADMAP.md queue A, item 9, extras), and the superc impF/impSelf and
nonsu2 SOC-operator files (item 10, joint modes); check_supported refuses
the inputs that would write them.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .bath.dmft_bath import save_bath_file
from .config import EDConfig
from .sectors import SectorTable
from .solver.diag import DiagResult
from .solver.observables import Observables


def _path(cfg: EDConfig, name: str) -> str:
    return os.path.join(cfg.ed_output_dir, name + cfg.ed_file_suffix + ".ed")


def write_observables(cfg: EDConfig, obs: Observables, last: bool = True) -> None:
    norb = cfg.norb
    names = ([f"dens_{a+1}" for a in range(norb)]
             + [f"docc_{a+1}" for a in range(norb)]
             + [f"nup_{a+1}" for a in range(norb)]
             + [f"ndw_{a+1}" for a in range(norb)]
             + [f"mag_{a+1}" for a in range(norb)]
             + ["s2tot", "egs"])
    vals = np.concatenate([obs.dens, obs.docc, obs.dens_up, obs.dens_dw,
                           obs.mag[2], [obs.s2tot, obs.egs]])
    with open(_path(cfg, "observables_info"), "w") as fh:
        fh.write("# " + " ".join(f"{i+1}:{n}" for i, n in enumerate(names)) + "\n")
    mode = "w" if last else "a"
    with open(_path(cfg, "observables_last" if last else "observables_all"),
              mode) as fh:
        fh.write(" ".join(f"{v:.12f}" for v in vals) + "\n")


def write_energy(cfg: EDConfig, obs: Observables) -> None:
    names = ["epot", "eint", "ehartree", "eknot", "dust", "dund", "dse", "dph"]
    vals = np.concatenate([obs.energies, obs.doubles])
    with open(_path(cfg, "energy_info"), "w") as fh:
        fh.write("# " + " ".join(f"{i+1}:{n}" for i, n in enumerate(names)) + "\n")
    with open(_path(cfg, "energy_last"), "w") as fh:
        fh.write(" ".join(f"{v:.12f}" for v in vals) + "\n")


def write_eigenvalues(cfg: EDConfig, diag: DiagResult, table: SectorTable) -> None:
    """eigenvalues_list.ed + state_list.ed (ED_DIAG_NORMAL.f90:280-285)."""
    with open(_path(cfg, "eigenvalues_list"), "w") as fh:
        for isec in sorted(diag.evals_by_sector):
            qn = table.qns[isec]
            for ev in diag.evals_by_sector[isec]:
                fh.write(f"{ev:.12f}  {qn}\n")
    with open(_path(cfg, "state_list"), "w") as fh:
        e0 = diag.e0
        for i, st in enumerate(diag.state_list):
            qn = table.qns[st.sector]
            fh.write(f"{i+1} {st.energy:.12f} {st.energy-e0:.12e} {qn}\n")


# ---------------------------------------------------------------------------
# restart files
# ---------------------------------------------------------------------------


def _qn_fields(qn: Tuple) -> List[int]:
    if qn[0] == "n":
        return list(qn[1]) + list(qn[2])
    if qn[0] == "ntj":
        return [qn[1], qn[2]]
    return [qn[1]]


def _restart_path(cfg: EDConfig, name: str) -> str:
    return os.path.join(cfg.ed_output_dir,
                        name + cfg.ed_file_suffix + ".restart")


def write_state_list_restart(cfg: EDConfig, diag: DiagResult,
                             table: SectorTable, path: Optional[str] = None) -> None:
    path = path or _restart_path(cfg, "state_list")
    with open(path, "w") as fh:
        for i, st in enumerate(diag.state_list):
            fields = " ".join(str(x) for x in _qn_fields(table.qns[st.sector]))
            fh.write(f"{i+1} {st.sector} {fields}\n")


def read_state_list_restart(cfg: EDConfig, table: SectorTable,
                            path: Optional[str] = None) -> Optional[np.ndarray]:
    """Seed neigen_sector from a previous run's retained states
    (reference setup_global, ED_SETUP.f90:557-590)."""
    path = path or _restart_path(cfg, "state_list")
    if not os.path.exists(path):
        return None
    counts = np.zeros(len(table), dtype=int)
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                isec = int(parts[1])
                if 0 <= isec < len(table):
                    counts[isec] += 1
    if counts.sum() == 0:
        return None
    neigen_max = counts.max()
    neigen = np.full(len(table), neigen_max + 2 * cfg.lanc_nstates_step, int)
    nz = counts > 0
    neigen[nz] = np.maximum(1, counts[nz] + 2 * cfg.lanc_nstates_step)
    return neigen


def write_sectors_restart(cfg: EDConfig, diag: DiagResult, table: SectorTable,
                          path: Optional[str] = None) -> None:
    path = path or _restart_path(cfg, cfg.sectorfile)
    secs = sorted({st.sector for st in diag.state_list})
    with open(path, "w") as fh:
        for isec in secs:
            fh.write(" ".join(str(x) for x in _qn_fields(table.qns[isec])) + "\n")


def read_sectors_restart(cfg: EDConfig, table: SectorTable,
                         path: Optional[str] = None) -> Optional[np.ndarray]:
    """Sector mask: listed sectors expanded by ±ed_sectors_shift in each
    quantum number (reference ED_DIAG_NORMAL.f90:325-371)."""
    path = path or _restart_path(cfg, cfg.sectorfile)
    if not os.path.exists(path):
        return None
    listed = []
    with open(path) as fh:
        for line in fh:
            parts = [int(x) for x in line.split()]
            if parts:
                listed.append(parts)
    if not listed:
        return None
    mask = np.zeros(len(table), dtype=bool)
    shift = cfg.ed_sectors_shift
    for i, qn in enumerate(table.qns):
        fields = np.asarray(_qn_fields(qn))
        for ref in listed:
            if len(ref) == len(fields) and np.all(np.abs(fields - np.asarray(ref))
                                                  <= shift):
                mask[i] = True
                break
    return mask


def write_xmu_restart(cfg: EDConfig, xmu: float, ndelta: float,
                      path: Optional[str] = None) -> None:
    path = path or os.path.join(cfg.ed_output_dir, "xmu.restart")
    with open(path, "w") as fh:
        fh.write(f"{xmu:.12f} {ndelta:.12f}\n")


def read_xmu_restart(cfg: EDConfig, path: Optional[str] = None):
    path = path or os.path.join(cfg.ed_output_dir, "xmu.restart")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        parts = fh.read().split()
    return float(parts[0]), float(parts[1]) if len(parts) > 1 else cfg.ndelta


def write_all_outputs(cfg: EDConfig, result) -> None:
    """Everything ed_solve writes when ed_write_files is on."""
    os.makedirs(cfg.ed_output_dir, exist_ok=True)
    write_observables(cfg, result.obs)
    if cfg.ed_obs_all:
        # append per-loop history (reference observables_all.ed, gated by
        # ED_OBS_ALL)
        write_observables(cfg, result.obs, last=False)
    write_energy(cfg, result.obs)
    if result.gf is not None and result.gf.channels:
        write_gf_text(cfg, result)
    write_eigenvalues(cfg, result.diag, result.table)
    write_state_list_restart(cfg, result.diag, result.table)
    write_sectors_restart(cfg, result.diag, result.table)
    save_bath_file(result.bath, os.path.join(
        cfg.ed_output_dir, cfg.hfile + cfg.ed_file_suffix + ".used"))
    # Källén-Lehmann weight/pole store, re-loadable without re-solving
    # (reference write_GFmatrix / ed_read_ImpGMatrix, ED_GFMATRIX.f90:78-107)
    if result.gf is not None and result.gf.channels:
        result.gf.save(os.path.join(
            cfg.ed_output_dir, f"gfmatrix{cfg.ed_file_suffix}.npz"))


# ---------------------------------------------------------------------------
# GF / Sigma text outputs (reference ED_IO print routines: one file per
# component, columns [w, Im F, Re F]; names impG_l{ab}_s{ss'}_iw.ed etc.,
# ED_GREENS_FUNCTIONS.f90:292-338/383+)
# ---------------------------------------------------------------------------


def _splot(cfg: EDConfig, name: str, x, f) -> None:
    path = os.path.join(cfg.ed_output_dir, name + cfg.ed_file_suffix + ".ed")
    f = np.asarray(f)
    with open(path, "w") as fh:
        if np.iscomplexobj(f):
            for xi, fi in zip(x, f):
                fh.write(f"{xi:.12f} {fi.imag:.12e} {fi.real:.12e}\n")
        else:
            for xi, fi in zip(x, f):
                fh.write(f"{xi:.12f} {fi:.12e}\n")


def _print_components(cfg: EDConfig, tag: str, axis_tag: str, x, arr) -> None:
    arr = np.asarray(arr)        # (Nspin, Nspin, Norb, Norb, L)
    ns, no = arr.shape[0], arr.shape[2]
    for s1 in range(ns):
        for s2 in range(ns):
            for a in range(no):
                for b in range(no):
                    comp = arr[s1, s2, a, b]
                    if a != b or s1 != s2:
                        if not np.any(comp):
                            continue
                        lab = f"_l{a + 1}{b + 1}_s{s1 + 1}{s2 + 1}"
                    else:
                        lab = f"_l{a + 1}{a + 1}_s{s1 + 1}"
                    _splot(cfg, f"{tag}{lab}_{axis_tag}", x, comp)


def write_gf_text(cfg: EDConfig, result) -> None:
    """impG/impG0/impSigma text files on both axes, gated by the
    ed_print_* flags, and the diagonal impG on the imaginary-time grid."""
    wm = (2 * np.arange(cfg.lmats) + 1) * np.pi / cfg.beta
    zm = 1j * wm
    wr = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    zr = wr + 1j * cfg.eps
    if cfg.ed_print_g:
        _print_components(cfg, "impG", "iw", wm, result.get_gimp(zm, "m"))
        _print_components(cfg, "impG", "realw", wr, result.get_gimp(zr, "r"))
        # imaginary-time diagonal components from the KL poles (Ltau grid)
        tau = np.linspace(0.0, cfg.beta, cfg.ltau)
        for s in range(cfg.nspin):
            for a in range(cfg.norb):
                if ("g", s, a, a) in result.gf.channels:
                    gt = result.gf.eval_tau(("g", s, a, a), tau, cfg.beta)
                    _splot(cfg, f"impG_l{a + 1}{a + 1}_s{s + 1}_tau", tau, gt)
    if cfg.ed_print_g0:
        _print_components(cfg, "impG0", "iw", wm, result.get_g0imp(zm, "m"))
        _print_components(cfg, "impG0", "realw", wr, result.get_g0imp(zr, "r"))
    if cfg.ed_print_sigma:
        _print_components(cfg, "impSigma", "iw", wm, result.get_sigma(zm, "m"))
        _print_components(cfg, "impSigma", "realw", wr,
                          result.get_sigma(zr, "r"))
