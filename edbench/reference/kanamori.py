"""What a configuration of the Kanamori impurity (``ed_mode`` normal or
superc, normal bath) needs besides its plain reference, and the reference
itself behind one interface, which the harness loads by the path a
configuration names under ``reference``:

* :func:`default_bath`: the configuration's default bath, the arrays that
  traffic moves; :func:`pack`: the program's bath layout of such a bath;
* :func:`program_hloc`: the configuration's Hloc in the program's layout;
* :func:`read_back`: what a DMFT driver reads from the program after a
  solve, in the form :func:`solve` gives the reference's answers;
* :func:`sectors`: the sectors a solve diagonalizes, the restart's listed
  sectors widened by ``ed_sectors_shift``, or every sector without one;
* :func:`solve`: the reference's answers for one bath.

An answer is a dict: ``kept`` [(sector label, energy)], ``functions``
{name: (norb, L) array on the Matsubara grid} (with ``flag_gf``) and
``observables`` {name: array}. ``read_back`` is handed the program's
module and result; nothing here imports the program.

The default bath is EDIpack's ``init_dmft_bath``: a flat band of
half-width ``ed_hw_bath`` discretized with the levels nearest zero at
±0.1, hybridizations max(0.1, 1/√Nbath), pairing ``deltasc``;
:func:`flat_band_levels` is a frozen copy of
``edipack_tpu_torch/bath/dmft_bath.py:_flat_band_levels`` (commit
a90ee7e). The packed array is EDIpack's ``get_dmft_bath`` layout for a
normal bath: energies, then (superc) pairings, then hybridizations, each
(Nspin, Norb, Nbath).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .model import Model


def flat_band_levels(nbath: int, hw: float) -> np.ndarray:
    e = np.zeros(nbath)
    if nbath == 0:
        return e
    e[0], e[-1] = -hw, hw
    nh = nbath // 2
    if nbath % 2 == 0 and nbath >= 4:
        de = hw / max(nh - 1, 1)
        e[nh - 1], e[nh] = -0.1, 0.1
        for i in range(2, nh):
            e[i - 1] = -hw + (i - 1) * de
            e[nbath - i] = hw - (i - 1) * de
    elif nbath % 2 == 1 and nbath >= 3:
        de = hw / nh
        for i in range(2, nh + 1):
            e[i - 1] = -hw + (i - 1) * de
            e[nbath - i] = hw - (i - 1) * de
    return e


def _superc(params: dict) -> bool:
    return params.get("ed_mode", "normal") == "superc"


def default_bath(params: dict) -> Dict[str, np.ndarray]:
    """(Norb, Nbath) arrays e, v and, in superc, d."""
    no, nb = params["norb"], params["nbath"]
    e = np.tile(flat_band_levels(nb, params.get("ed_hw_bath", 2.0)), (no, 1))
    v = np.full((no, nb), max(0.1, 1.0 / np.sqrt(nb)))
    out = dict(e=e, v=v)
    if _superc(params):
        out["d"] = np.full((no, nb), params.get("deltasc", 0.02))
    return out


def pack(bath: Dict[str, np.ndarray]) -> np.ndarray:
    parts = [bath["e"].ravel()]
    if "d" in bath:
        parts.append(bath["d"].ravel())
    parts.append(bath["v"].ravel())
    return np.concatenate(parts)


def hloc_diag(conf: dict) -> np.ndarray:
    """The configuration's ``hloc``: the diagonal of Hloc an orbital, both
    spins alike; zero when the configuration gives none."""
    no = conf["params"]["norb"]
    return np.asarray(conf.get("hloc", np.zeros(no)), float).reshape(no)


def program_hloc(conf: dict) -> np.ndarray:
    """Hloc as ``ed_set_hloc`` takes it: (Nspin, Nspin, Norb, Norb)."""
    ns = conf["params"].get("nspin", 1)
    h = np.zeros((ns, ns) + (conf["params"]["norb"],) * 2)
    for s in range(ns):
        h[s, s] = np.diag(hloc_diag(conf))
    return h


def _label(qn) -> tuple:
    """A sector's quantum numbers as a tuple of ints: (nup, ndw) or (sz,)."""
    out = []
    for x in qn[1:]:
        out += list(x) if isinstance(x, (tuple, list)) else [x]
    return tuple(int(x) for x in out)


def _diag(a) -> np.ndarray:
    a = np.asarray(a)[0, 0]
    return np.array([a[i, i] for i in range(a.shape[0])])


def read_back(ed, res, params: dict, flag_gf: bool) -> dict:
    """The program's answers for one solve, and its counters: ``ed`` the
    program's functional API, ``res`` what ``ed_solve`` returned."""
    table = res.table
    obs = dict(dens=np.asarray(ed.ed_get_dens(), float),
               docc=np.asarray(ed.ed_get_docc(), float),
               energies=np.asarray(ed.ed_get_eimp(), float))
    if _superc(params):
        obs["phi"] = np.diag(np.asarray(res.phisc, float)).copy()
    out = dict(kept=[(_label(table.sector(st.sector).qn), float(st.energy))
                     for st in res.diag.state_list],
               observables=obs, timings=dict(res.timings),
               matvecs=int(sum(s[2] for s in
                               res.diag.lanczos_stats.values())))
    if flag_gf:
        fn = dict(g=_diag(ed.ed_get_gimp()), sigma=_diag(ed.ed_get_sigma()))
        if _superc(params):
            fn["f"] = _diag(ed.ed_get_gimp(typ="a"))
        out["functions"] = fn
    return out


def all_sectors(params: dict) -> List[Tuple[int, ...]]:
    ns = params["norb"] * (params["nbath"] + 1)
    if _superc(params):
        return [(sz,) for sz in range(-ns, ns + 1)]
    return [(u, d) for u in range(ns + 1) for d in range(ns + 1)]


def sectors(conf: dict) -> List[Tuple[int, ...]]:
    """The sectors a solve diagonalizes: with ``ed_sectors`` and listed
    ``restart_sectors``, those within ``ed_sectors_shift`` of a listed one
    in every quantum number (EDIpack's default shift 1); else all."""
    p = conf["params"]
    listed = conf.get("restart_sectors") if p.get("ed_sectors") else None
    every = all_sectors(p)
    if not listed:
        return every
    shift = p.get("ed_sectors_shift", 1)
    return [lab for lab in every
            if any(len(r) == len(lab)
                   and all(abs(a - b) <= shift for a, b in zip(lab, r))
                   for r in listed)]


def matsubara(params: dict) -> np.ndarray:
    n = params.get("lmats", 4096)
    return 1j * (2 * np.arange(n) + 1) * np.pi / params.get("beta", 1000.0)


def model_params(params: dict) -> dict:
    """The model parameters the reference needs, with EDIpack's defaults."""
    p = dict(ed_mode="normal", xmu=0.0, beta=1000.0, lmats=4096,
             gs_threshold=1e-9, lanc_ngfiter=200, hfmode=True,
             ust=0.0, jh=0.0, jx=0.0, jp=0.0, lanc_nstates_sector=2)
    p.update(params)
    return p


def solve(conf: dict, bath: Dict[str, np.ndarray], dtype: torch.dtype,
          device, flag_gf: bool = True) -> dict:
    """The reference's answers for one bath in working precision
    ``dtype``: the kept states over :func:`sectors`, the observables and,
    with ``flag_gf``, G, Σ (and F) on the Matsubara grid; ``seconds``
    splits its time."""
    p = model_params(conf["params"])
    t0 = time.perf_counter()
    model = Model(p, bath, dtype, device, hloc=hloc_diag(conf))
    kept = model.kept(sectors(conf), p["lanc_nstates_sector"])
    t1 = time.perf_counter()
    out = dict(kept=[(k[0], k[1]) for k in kept],
               observables=model.observables(kept))
    if flag_gf:
        z = matsubara(p)
        gf = model.greens(kept, z)
        fn = dict(g=gf["g"], sigma=model.sigma(z, gf))
        if "f" in gf:
            fn["f"] = gf["f"]
        out["functions"] = fn
    out["seconds"] = dict(states=t1 - t0, rest=time.perf_counter() - t1)
    model.free()
    return out
