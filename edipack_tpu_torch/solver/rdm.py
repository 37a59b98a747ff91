"""Impurity reduced density matrix (normal mode); counterpart of
edipack_tpu.solver.rdm (``impurity_rdm_normal``, ``get_reduced_rdm``).

Parity target: reference ED_RDM.f90 + ED_RDM_NORMAL.f90 (:90-213), which
factorizes each sector state into impurity⊗bath via the sparse_map
intersections. Here: impurity levels are the low ``Norb`` bits of each
spin's bitset, so each state tensor is scattered, on the solve's device,
into a dense (imp_dw, imp_up, bath_up, bath_dw) array and the bath is
traced with one matrix product. Fermionic cross signs cancel because the
RDM is particle-number block-diagonal per spin (even operator pairing), so
the per-spin convention is exact. At config 2's (7,7) sector the dense
array holds (4·2508)² f64, about 0.8 GB; it is freed after each state.

RDM basis index: I = imp_up + 2^Norb * imp_dw (up bits fastest), matching
the reference's [4^Norb x 4^Norb] layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EDConfig
from ..sectors import SectorTable
from .eigenspace import StateList


def _split_scatter(basis: np.ndarray, norb: int):
    """Return (imp_conf, bath_rank, n_bath_configs) for each basis state."""
    imp_mask = (1 << norb) - 1
    imp = (basis & imp_mask).astype(np.int64)
    bath = (basis >> norb).astype(np.int64)
    uniq, rank = np.unique(bath, return_inverse=True)
    return imp, rank.reshape(-1), len(uniq)


def impurity_rdm_normal(cfg: EDConfig, table: SectorTable,
                        sl: StateList) -> np.ndarray:
    norb = cfg.norb
    nimp = 1 << norb
    w = sl.boltzmann_weights()
    rho = None
    for ist, st in enumerate(sl):
        sec = table.sector(st.sector)
        v3 = st.vector.reshape(sec.dim_ph, sec.dim_dw, sec.dim_up)
        dev = v3.device
        iu, bu, nbu = _split_scatter(sec.ups, norb)
        idn, bd, nbd = _split_scatter(sec.dws, norb)
        nbath = nbu * nbd
        # flat position of V[d, u] in W[imp_dw, imp_up, bath_up, bath_dw]
        pos_u = torch.as_tensor(iu * nbath + bu * nbd, device=dev)
        pos_d = torch.as_tensor(idn * nimp * nbath + bd, device=dev)
        pos = (pos_d[:, None] + pos_u[None, :]).reshape(-1)
        if rho is None:
            rho = torch.zeros(nimp * nimp, nimp * nimp, dtype=torch.float64,
                              device=dev)
        for p in range(sec.dim_ph):
            wd = torch.zeros(nimp * nimp * nbath, dtype=torch.float64,
                             device=dev)
            wd[pos] = v3[p].reshape(-1).to(torch.float64)
            wd = wd.view(nimp * nimp, nbath)
            rho += w[ist] * (wd @ wd.T)
            del wd
        del pos
    return rho.cpu().numpy()


def get_reduced_rdm(rdm: np.ndarray, orbital_mask, norb: int,
                    ) -> np.ndarray:
    """Trace the impurity RDM down to an orbital subset with fermionic
    sign bookkeeping (reference get_reduced_rdm_normal, ED_RDM.f90:71-230).

    ``rdm``: (4^norb, 4^norb) impurity RDM with index I = iu + 2^norb*id.
    ``orbital_mask``: length-norb booleans, True = keep."""
    mask = np.asarray(orbital_mask, bool)
    if mask.shape != (norb,):
        raise ValueError("orbital_mask must have one entry per orbital")
    nred = int(mask.sum())
    if nred < 1:
        raise ValueError("reduced system needs at least one orbital")
    if nred == norb:
        return rdm.copy()
    red = np.nonzero(mask)[0]
    tra = np.nonzero(~mask)[0]
    nimp = 1 << norb

    bits = ((np.arange(nimp)[:, None] >> np.arange(norb)[None, :]) & 1)
    # sign: for each kept orbital r, count occupied TRACED bits below r
    filt = bits.copy()
    filt[:, red] = 0
    csum = np.cumsum(filt, axis=1)      # inclusive prefix sums
    n = np.zeros(nimp, dtype=np.int64)
    for r in red:
        n += csum[:, r] - filt[:, r]    # traced bits strictly below r
    sgn = 1.0 - 2.0 * (n % 2)
    red_idx = (bits[:, red] << np.arange(nred)[None, :]).sum(1)
    tra_idx = (bits[:, tra] << np.arange(norb - nred)[None, :]).sum(1)

    nred_imp = 1 << nred
    out = np.zeros((nred_imp * nred_imp, nred_imp * nred_imp), rdm.dtype)
    for iu in range(nimp):
        for idw in range(nimp):
            i = iu + nimp * idw
            for ju in range(nimp):
                if tra_idx[ju] != tra_idx[iu]:
                    continue
                for jd in range(nimp):
                    if tra_idx[jd] != tra_idx[idw]:
                        continue
                    j = ju + nimp * jd
                    io = red_idx[iu] + nred_imp * red_idx[idw]
                    jo = red_idx[ju] + nred_imp * red_idx[jd]
                    s = sgn[iu] * sgn[idw] * sgn[ju] * sgn[jd]
                    out[io, jo] += rdm[i, j] * s
    return out
