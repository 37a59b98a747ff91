"""Write the edipack_tpu reference numbers that edipack_tpu_torch is held to
on the card (chip_smoke.py) and in the slow CPU tests
(tests/test_torch_solve.py, tests/test_torch_f32.py, tests/test_torch_dmft.py).

    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py [float64] [float32] [dmft]
    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py extras [PART ...]
    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py joint
    JAX_PLATFORMS=cpu python tests/gen_torch_golden.py ineq

Runs the JAX package's ed_solve on the CPU at norb=2, nbath=4 with the
two-orbital Kanamori parameters of bench.py and writes, for each precision
named (both by default):

* float64: tests/data/torch_port_golden_n2b4.json (f64 KronMatvec, exact GF
  moments);
* float32: tests/data/torch_port_golden_f32_n2b4.json (``ed_precision=
  "float32"``: f32 KronMatvec, the route ``never`` the CPU takes; f64 dense
  buckets), with ``ed_twin=True``. The ground level is a doublet of twin
  sectors, (4,6) and (6,4), 2.6e-14 apart at f64; without twins an f32
  solve keeps only the member that rounding puts lower, and the spin-up G
  of the two differs by 1.1e-2. Twins give both the same energy, so every
  solve keeps both. G and Σ are taken on the Matsubara grid of
  ``beta_grid``, whose lowest frequency the f32 solve resolves (see
  tests/test_torch_f32.py). Under the key ``f64`` the file also holds the
  same configuration solved in f64 (twins on, G and Σ on the same grid):
  the JAX f32 solve lies 1.1e-4 from that e0 at this size, so the f32
  checks hold the port to both.

* dmft: tests/data/torch_port_golden_dmft_n2b4.json, two iterations of
  the Bethe-lattice DMFT loop at the same configuration with
  ``cg_scheme="delta"`` and ``cg_method=1`` (about 4 min): solve, Δ =
  (D/2)² G with D = 1, the χ² fit of the bath to Δ, and again from the
  fitted bath in the same solver. For each loop: e0, dens, docc, G and Σ,
  and the packed bath the fit returned. No mixing: each loop's Δ is (D/2)²
  times its own G. The fit is L-BFGS-B (``cg_method=1``), which stops on
  its own criterion: the default CG stops at cg_niter here, and the point
  where it stops moves with the last bits of its target
  (tests/test_torch_fit.py), so no golden number could hold it.

* extras: tests/data/torch_port_golden_extras_n2b4.json, the normal-mode
  extras at the same Kanamori parameters with a crystal field Hloc =
  diag(0.1, -0.1) (name parts, t0 finite_t total_ud twobody, to write
  only those): (1) a T=0 solve with the four χ flags
  and rdm_flag, then the Krylov state complexity: χ spin/dens/pair/exct on
  the bosonic frequencies ν_1..ν_32 of β = 20 (CHI_BETA_GRID; the exciton
  channels singlet, triplet-z and spin-flip by their keys), the
  RDM, the reduced RDM of orbital 1, K(t), S(t) and the Krylov
  distribution on 0 <= t <= 2 (see CHI_ALL), the energies, sp_dm; (2)
  three finite-T solves of one EDSolver (β = 20, cutoff 1e-3, budget 10, step 5): each solve's
  lanc_nstates_total, neigen_sector, zeta, e0, dens and G, and the
  histogram_states.ed text; (3) an ed_total_ud=False solve of the
  density-density model (jx = jp = 0): e0, dens, docc, G; (4) the T=0
  model with a runtime two-body term (ed_add_twobody_operator): e0, dens.
  Every solve takes lanc_niter=8192, so that no Lanczos sector stops at
  its restart cap: at the default 512, excited states kept at finite T
  stop there with residuals up to 1e-2, and their vectors depend on the
  start vector, which the two packages draw differently. The generator
  checks that each finite-T budget ends in a gap of the spectrum (twin
  sectors give degenerate pairs), so the kept set does not hang on the
  last bits of the energies.

* joint: tests/data/torch_port_golden_joint.json, the superc / nonsu2
  cases of tests/joint_cases.py (about 2 min): superc at norb=2, nbath=3
  with deltasc and an anomalous Hloc, nonsu2 at norb=2, nbath=2 with a
  spin-mixing Hloc and spin_field_x, the norb=3 t2g model with λ L·S and
  its quantum SOC operators, a complex Hloc in ed_mode=normal, a superc
  replica bath, and a superc solve with phonons; each through
  ``run_case`` (ed_* API, f64 JointMatvec on the CPU), with a χ² fit by
  L-BFGS-B of the superc and nonsu2 baths to (D/2)² (G, F) and (D/2)² G.

* ineq: tests/data/torch_port_golden_ineq.json, inequivalent sites
  through EDIneqSolver (four parts, each in a process of its own, three
  run together, then the second iteration; about 20 min on an 8-core CPU,
  most of it the n2b4 sites' Lanczos sectors): (1) three sites of CONFIG with the DMFT fit settings,
  a staggered Hloc and per-site uloc_ii / ust_ii: a statics-only call
  (flag_gf=False), a full call (e0, evals, dens, docc, energies, G and Σ
  on NMATS frequencies), the L-BFGS-B fit of every site to (D/2)² G
  (fit_gf), and the second iteration from the fitted baths; (2) two superc
  sites (norb=2, nbath=2, bench.py config 3's couplings) through the
  per-site loop: e0, dens, docc, φ, G and F; (3) the C drivers' case: two
  sites of CONFIG with uniform U, default baths and the Hloc ±HSTAG/2 on
  every orbital, G on the default grid of ``lmats`` = NMATS points.

Not collected by pytest (the file name does not start with ``test_``).
"""
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import edipack_tpu.main as ed  # noqa: E402
from edipack_tpu.config import default_config  # noqa: E402

OUT = os.path.join(HERE, "data", "torch_port_golden_n2b4.json")
OUT_F32 = os.path.join(HERE, "data", "torch_port_golden_f32_n2b4.json")
OUT_DMFT = os.path.join(HERE, "data", "torch_port_golden_dmft_n2b4.json")
OUT_EXTRAS = os.path.join(HERE, "data", "torch_port_golden_extras_n2b4.json")
OUT_JOINT = os.path.join(HERE, "data", "torch_port_golden_joint.json")
# the DMFT golden: Bethe lattice of half-bandwidth D, two loops
DMFT = dict(cg_scheme="delta", cg_method=1)
WBAND = 1.0
DMFT_LOOPS = 2
CONFIG = dict(norb=2, nbath=4, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
              jx=0.15, jp=0.15)
NMATS = 32
BETA_GRID_F32 = 20.0


def pairs(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], axis=-1).tolist()


def solve(config, beta_grid=None):
    """One ed_solve of ``config``; its results, G and Σ on the Matsubara
    grid of ``beta_grid`` (default: the solve's β)."""
    cfg = default_config(**config, ed_verbose=0)
    assert dataclasses.asdict(cfg)["lanc_dim_threshold"] == 1024
    bath = ed.ed_init_solver(cfg=cfg)
    ed.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    res = ed.ed_solve(bath)
    z = 1j * np.pi / (beta_grid or cfg.beta) * (2 * np.arange(NMATS) + 1)
    out = dict(
        e0=float(res.e0), evals=np.asarray(res.evals).tolist(),
        dens=np.asarray(res.dens).tolist(),
        docc=np.asarray(res.docc).tolist(),
        energies=np.asarray(res.energies).tolist(),
        gimp=pairs(ed.ed_get_gimp(z)), sigma=pairs(ed.ed_get_sigma(z)))
    ed.ed_finalize_solver()
    return cfg, np.asarray(bath).tolist(), out


def write_golden(precision):
    if precision == "float64":
        cfg, bath, res = solve(CONFIG)
        out = dict(source="edipack_tpu ed_solve on the CPU (f64 KronMatvec, "
                          "exact GF)", config=CONFIG, beta=cfg.beta)
    else:
        config = dict(CONFIG, ed_precision=precision, ed_twin=True)
        cfg, bath, res = solve(config, BETA_GRID_F32)
        _, bath64, res64 = solve(dict(config, ed_precision="float64"),
                                 BETA_GRID_F32)
        assert bath64 == bath
        out = dict(source="edipack_tpu ed_solve on the CPU, "
                          "ed_precision=float32 (f32 KronMatvec, route "
                          "never; f64 dense buckets); under f64 the same "
                          "configuration in f64", config=config,
                   beta=cfg.beta, beta_grid=BETA_GRID_F32)
    out.update(nmats=NMATS, bath=bath, **res)
    if precision != "float64":
        out["f64"] = res64
    path = OUT if precision == "float64" else OUT_F32
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {path}: e0 {res['e0']}")


def dmft_loops(mod, cfg, nloops=DMFT_LOOPS, **init):
    """``nloops`` Bethe-lattice DMFT iterations of ``cfg`` through the
    ``ed_*`` API of ``mod`` (edipack_tpu.main or edipack_tpu_torch.main,
    whose config module must hold ``cfg`` as the current one): solve, then
    fit the bath to Δ = (D/2)² G. ``init``: extra ed_init_solver arguments.
    Returns one record per loop."""
    z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
    bath = mod.ed_init_solver(cfg=cfg, **init)
    mod.ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
    out = []
    for _ in range(nloops):
        res = mod.ed_solve(bath)
        delta = (WBAND / 2.0) ** 2 * mod.ed_get_gimp(axis="m")
        bath = mod.ed_chi2_fitgf(delta, bath, ispin=1)
        out.append(dict(e0=float(res.e0), dens=np.asarray(res.dens),
                        docc=np.asarray(res.docc), gimp=mod.ed_get_gimp(z),
                        sigma=mod.ed_get_sigma(z), bath=np.asarray(bath)))
    mod.ed_finalize_solver()
    return out


def write_dmft_golden():
    import subprocess
    from edipack_tpu.config import set_config
    config = dict(CONFIG, **DMFT)
    cfg = set_config(default_config(**config, ed_verbose=0))
    loops = dmft_loops(ed, cfg)
    commit = subprocess.run(["git", "log", "-1", "--format=%h", "--",
                             "edipack_tpu"], capture_output=True, text=True,
                            cwd=os.path.dirname(HERE)).stdout.strip()
    out = dict(source=f"edipack_tpu (last commit {commit}) on the CPU: "
                      f"{DMFT_LOOPS} Bethe DMFT loops through ed_solve (f64 "
                      f"KronMatvec, exact GF) and ed_chi2_fitgf, D = "
                      f"{WBAND}, no mixing", config=config, beta=cfg.beta,
               nmats=NMATS, wband=WBAND, lfit=cfg.lfit,
               loops=[{k: pairs(v) if k in ("gimp", "sigma") else
                       (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in rec.items()} for rec in loops])
    with open(OUT_DMFT, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {OUT_DMFT}: e0 {[r['e0'] for r in loops]}")


# the extras golden: CONFIG with a crystal field (no degenerate levels
# inside one sector), every Lanczos sector converged
EXTRAS = dict(CONFIG, lanc_niter=8192)
EXTRAS_HLOC = [[0.1, 0.0], [0.0, -0.1]]
# Krylov times up to 2.0: the chains run 200 Lanczos steps without
# reorthogonalization (the reference's algorithm, in both packages), and
# the rounding they amplify reaches K(t) late: at this model the two
# packages' K(t) differ by 5e-13 at t = 2, 9e-10 at t = 3, 2e-7 at t = 4.5
# and 5.5e-6 at t = 5 (measured on the CPU)
CHI_ALL = dict(chispin_flag=True, chidens_flag=True, chipair_flag=True,
               chiexct_flag=True, rdm_flag=True, tmax=2.0, ltimes=11)
FINITE_T = dict(ed_finite_temp=True, beta=20.0, cutoff=1e-3,
                lanc_nstates_total=10, lanc_nstates_step=5)
FINITE_T_SOLVES = 3
TOTAL_UD = dict(ed_total_ud=False, jx=0.0, jp=0.0)
TWOBODY = [(1, "u", 2, "d", 1, "u", 2, "d", 0.3),
           (1, "d", 2, "u", 1, "d", 2, "u", 0.3)]
# the exciton channels by their own keys: ed_get_exctchi asks for the key
# "exct", which no channel has, and returns zeros in both packages
CHI_KINDS = ("spin", "dens", "pair", "exct_s", "exct_tz", "exct_t")
# χ is taken on the bosonic frequencies of this β, not the solve's (1000):
# the Hermitian channels' static poles sit at ±(rounding of E_n - E_i)
# and add about 2 w (E_n - E_i) / ν² at ν ≠ 0, which at ν_1 = 2π/1000 turns
# 1e-12 of pole rounding into 5e-8 of χ; at β = 20 it stays below 1e-10
CHI_BETA_GRID = 20.0
REDUCED_MASK = [True, False]


def bosonic(beta):
    """ν_1 .. ν_NMATS."""
    return 1j * 2 * np.pi / beta * np.arange(1, NMATS + 1)


def fermionic(beta):
    return 1j * np.pi / beta * (2 * np.arange(NMATS) + 1)


def extras_solver(mod, cfg, terms=(), **init):
    """ed_init_solver / ed_set_hloc of ``cfg`` (the current config) through
    the ed_* API of ``mod`` (edipack_tpu.main or edipack_tpu_torch.main),
    with the runtime two-body ``terms``. ``init``: extra ed_init_solver
    arguments."""
    bath = mod.ed_init_solver(cfg=cfg, **init)
    mod.ed_set_hloc(np.asarray(EXTRAS_HLOC).reshape(1, 1, 2, 2))
    for t in terms:
        mod.ed_add_twobody_operator(*t)
    return bath


def krylov_dict(kr):
    return {f: {",".join(map(str, k)): np.asarray(v).tolist()
                for k, v in getattr(kr, f).items()}
            for f in ("complexity", "entropy", "distribution")}


def extras_t0(mod, make_cfg, **init):
    """``make_cfg(config_dict)``: the package's config, made the current
    one."""
    cfg = make_cfg(dict(EXTRAS, **CHI_ALL))
    bath = extras_solver(mod, cfg, **init)
    res = mod.ed_solve(bath)
    z = bosonic(CHI_BETA_GRID)
    out = dict(bath=np.asarray(bath).tolist(), e0=float(res.e0),
               dens=np.asarray(res.dens).tolist(),
               docc=np.asarray(res.docc).tolist(),
               energies=[mod.ed_get_epot(), mod.ed_get_eint(),
                         mod.ed_get_ehartree(), mod.ed_get_eknot()],
               sp_dm=np.real(mod.ed_get_sp_dm()).tolist(),
               chi={k: pairs(mod.ed_get_chi(k, z)) for k in CHI_KINDS},
               rdm=np.asarray(mod.ed_get_rdm()).tolist(),
               reduced_rdm=np.asarray(
                   mod.ed_get_reduced_rdm(REDUCED_MASK)).tolist(),
               krylov=krylov_dict(mod.ed_build_krylov_state_complexity()))
    mod.ed_finalize_solver()
    return out


def extras_finite_t(mod, make_cfg, outdir, **init):
    """FINITE_T_SOLVES solves of one solver; the histogram file is written
    under ``outdir``."""
    cfg = make_cfg(dict(EXTRAS, **FINITE_T, ed_write_files=True,
                        ed_output_dir=outdir))
    bath = extras_solver(mod, cfg, **init)
    z = fermionic(cfg.beta)
    solves = []
    for _ in range(FINITE_T_SOLVES):
        res = mod.ed_solve(bath)
        solves.append(dict(
            lanc_nstates_total=int(res.diag.lanc_nstates_total),
            neigen_sector=np.asarray(res.diag.neigen_sector).tolist(),
            zeta=float(res.diag.zeta), e0=float(res.e0),
            dens=np.asarray(res.dens).tolist(),
            gimp=pairs(mod.ed_get_gimp(z)),
            energies=sorted(float(st.energy) for st in
                            res.diag.state_list.states),
            computed=sorted(float(e) for ev in
                            res.diag.evals_by_sector.values() for e in ev),
            budget_in=None))
    mod.ed_finalize_solver()
    with open(os.path.join(outdir, "histogram_states.ed")) as fh:
        hist = fh.read()
    return solves, hist


def extras_simple(mod, make_cfg, config, terms=(), **init):
    cfg = make_cfg(config)
    bath = extras_solver(mod, cfg, terms, **init)
    res = mod.ed_solve(bath)
    out = dict(e0=float(res.e0), dens=np.asarray(res.dens).tolist(),
               docc=np.asarray(res.docc).tolist(),
               gimp=pairs(mod.ed_get_gimp(fermionic(cfg.beta))))
    mod.ed_finalize_solver()
    return out


def check_finite_t(solves):
    """The kept list (the lowest states above the cutoff, at most the
    budget) must end in a gap of the computed spectrum, and no computed
    state may sit within a factor 2 of the cutoff's weight."""
    budget = FINITE_T["lanc_nstates_total"]
    beta, cutoff = FINITE_T["beta"], FINITE_T["cutoff"]
    for k, s in enumerate(solves):
        kept, comp = s["energies"], s["computed"]
        nxt = comp[len(kept)] if len(comp) > len(kept) else np.inf
        gap = nxt - kept[-1]
        wts = np.exp(-beta * (np.asarray(comp) - comp[0]))
        near = wts[(wts > cutoff / 2) & (wts < 2 * cutoff)]
        print(f"finite T solve {k + 1}: budget {budget}, kept {len(kept)}, "
              f"next budget {s['lanc_nstates_total']}, gap above the kept "
              f"list {gap:.3e}, weights near the cutoff {near}")
        assert gap > 1e-6, "a finite-T budget splits a degenerate level"
        assert near.size == 0, "a state's weight sits at the cutoff"
        s["budget_in"] = budget
        budget = s["lanc_nstates_total"]
        del s["computed"]


def extras_part(part, path):
    """One part of the extras golden, written to ``path`` as JSON. Each
    part runs in a process of its own: the per-orbital solve compiles one
    executable per Lanczos sector, and after the other parts' the process
    runs out of memory for more."""
    import tempfile
    from edipack_tpu.config import set_config

    def make_cfg(config):
        return set_config(default_config(**config, ed_verbose=0))

    if part == "t0":
        out = extras_t0(ed, make_cfg)
    elif part == "finite_t":
        with tempfile.TemporaryDirectory() as tmp:
            solves, hist = extras_finite_t(ed, make_cfg, tmp)
        check_finite_t(solves)
        out = dict(solves=solves, histogram=hist)
    elif part == "total_ud":
        out = extras_simple(ed, make_cfg, dict(EXTRAS, **TOTAL_UD))
    else:
        out = extras_simple(ed, make_cfg, EXTRAS, TWOBODY)
    print(f"{part}: e0 {out.get('e0', [s['e0'] for s in out.get('solves', [])])}")
    with open(path, "w") as fh:
        json.dump(out, fh)


def write_extras_golden(only=()):
    """All four parts, or only the parts named in ``only`` (the others
    are kept from the existing file)."""
    import subprocess
    import tempfile
    parts = {}
    if only:
        with open(OUT_EXTRAS) as fh:
            old = json.load(fh)
        for part in set(("t0", "finite_t", "total_ud", "twobody")) - set(only):
            parts[part] = {k: v for k, v in old[part].items()
                           if k not in ("config", "terms", "reduced_mask")}
    with tempfile.TemporaryDirectory() as tmp:
        for part in only or ("t0", "finite_t", "total_ud", "twobody"):
            path = os.path.join(tmp, part + ".json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "extras_part", part, path], check=True)
            with open(path) as fh:
                parts[part] = json.load(fh)
    t0, total_ud, twobody = parts["t0"], parts["total_ud"], parts["twobody"]
    solves, hist = parts["finite_t"]["solves"], parts["finite_t"]["histogram"]
    commit = subprocess.run(["git", "log", "-1", "--format=%h", "--",
                             "edipack_tpu"], capture_output=True, text=True,
                            cwd=os.path.dirname(HERE)).stdout.strip()
    out = dict(source=f"edipack_tpu (last commit {commit}) on the CPU "
                      f"through the ed_* API (f64 KronMatvec, exact GF)",
               config=EXTRAS, hloc=EXTRAS_HLOC, nmats=NMATS,
               chi_beta_grid=CHI_BETA_GRID,
               t0=dict(config=CHI_ALL, reduced_mask=REDUCED_MASK, **t0),
               finite_t=dict(config=FINITE_T, solves=solves,
                             histogram=hist),
               total_ud=dict(config=TOTAL_UD, **total_ud),
               twobody=dict(terms=TWOBODY, **twobody))
    with open(OUT_EXTRAS, "w") as fh:
        json.dump(out, fh)
    print(f"wrote {OUT_EXTRAS}: {os.path.getsize(OUT_EXTRAS)} bytes")


def write_joint_golden():
    import joint_cases as jc
    pkg = jc.modules("edipack_tpu")
    out = dict(source="edipack_tpu ed_solve on the CPU through the ed_* "
                      "API (tests/joint_cases.py run_case; f64 JointMatvec)",
               nmats=jc.NMATS, cases={})
    for name, case in jc.CASES.items():
        res = jc.run_case(pkg, case)
        out["cases"][name] = jc.to_json(res)
        print(f"joint {name}: e0 {res['e0']}")
    with open(OUT_JOINT, "w") as fh:
        json.dump(out, fh)
    print(f"wrote {OUT_JOINT}: {os.path.getsize(OUT_JOINT)} bytes")


OUT_INEQ = os.path.join(HERE, "data", "torch_port_golden_ineq.json")
INEQ = dict(CONFIG, **DMFT)
INEQ_NSITES = 3
INEQ_HLOC = [0.1, 0.0, -0.1]             # site s: INEQ_HLOC[s] * 1
INEQ_ULOC = [[2.0, 2.0], [2.5, 2.5], [1.5, 1.5]]
INEQ_UST = [1.2, 1.5, 0.9]
INEQ_SUPERC = dict(norb=2, nbath=2, nspin=1, ed_mode="superc",
                   uloc=[-2.0, -2.0], ust=-1.0, jh=0.25, jx=0.25, jp=0.25,
                   deltasc=0.02)
INEQ_SUPERC_ULOC = [[-2.0, -2.0], [-1.5, -1.5]]
INEQ_CAPI = dict(CONFIG, lmats=NMATS)
INEQ_CAPI_NLAT, INEQ_CAPI_HSTAG = 2, 0.2


def _site_hloc(norb, values):
    return np.stack([np.eye(norb)[None, None] * v for v in values])


def _ineq_records(solver, z, full=True):
    out = []
    g = solver.get_gimp(z) if full else None
    sig = solver.get_sigma(z) if full else None
    for n, s in enumerate(solver.solvers):
        res = s.result
        rec = dict(e0=float(res.e0), dens=np.asarray(res.dens).tolist(),
                   docc=np.asarray(res.docc).tolist(),
                   energies=np.asarray(res.energies).tolist())
        if full:
            rec.update(evals=np.asarray(res.evals).tolist(),
                       gimp=pairs(g[n]), sigma=pairs(sig[n]))
        out.append(rec)
    return out


def _ineq_sites(cfg):
    from edipack_tpu.ineq import EDIneqSolver
    solver = EDIneqSolver(INEQ_NSITES, cfg)
    baths = solver.init_solver()
    solver.set_hloc(_site_hloc(cfg.norb, INEQ_HLOC))
    return solver, baths


def ineq_part(part, path, *inputs):
    """One part of the ineq golden, written to ``path`` as JSON. Each part
    runs in a process of its own, and drops JAX's compiled executables
    between its sweeps: the executables of several n2b4 sweeps in one
    process exhaust the process's memory maps (LLVM "Cannot allocate
    memory")."""
    import gc
    from edipack_tpu.config import set_config
    from edipack_tpu.ineq import EDIneqSolver
    over = dict(uloc_ii=np.array(INEQ_ULOC), ust_ii=np.array(INEQ_UST))
    if part in ("loop1", "loop2"):
        cfg = set_config(default_config(**INEQ, ed_verbose=0))
        z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
        solver, baths = _ineq_sites(cfg)
    if part == "loop1":
        # the statics-only call first: its adapted neigen_sector seeds the
        # full call, as in one EDIneqSolver's loop
        solver.solve(baths, flag_gf=False, **over)
        out = dict(bath=baths.tolist(),
                   statics=_ineq_records(solver, z, full=False))
        jax.clear_caches()
        gc.collect()
        solver.solve(baths, **over)
        out.update(loop1=_ineq_records(solver, z),
                   neigen=[s.result.neigen_sector.tolist()
                           for s in solver.solvers])
        delta = (WBAND / 2.0) ** 2 * solver.get_gimp()
        jax.clear_caches()
        gc.collect()
        out["fit"] = solver.fit_gf(delta, baths).tolist()
    elif part == "loop2":
        with open(inputs[0]) as fh:
            first = json.load(fh)
        fit = np.asarray(first["fit"])
        # the second iteration of the same solvers, as in one
        # EDIneqSolver's loop: the first's overrides stay in each site's
        # config, and its adapted neigen_sector seeds the sweep
        for s, u, ust, nev in zip(solver.solvers, INEQ_ULOC, INEQ_UST,
                                  first["neigen"]):
            s.cfg = s.cfg.replace(uloc=list(u), ust=ust)
            s.neigen_sector_override = np.asarray(nev, int)
        solver.solve(fit)
        out = dict(loop2=_ineq_records(solver, z))
    elif part == "superc":
        cfg = set_config(default_config(**INEQ_SUPERC, ed_verbose=0))
        z = 1j * np.pi / cfg.beta * (2 * np.arange(NMATS) + 1)
        solver = EDIneqSolver(2, cfg)
        baths = solver.init_solver()
        solver.set_hloc(_site_hloc(cfg.norb, [0.1, -0.1]))
        solver.solve(baths, uloc_ii=np.array(INEQ_SUPERC_ULOC))
        g, f = solver.get_gimp(z), solver.get_gimp(z, typ="a")
        out = dict(sites=[dict(e0=float(s.result.e0),
                               dens=np.asarray(s.result.dens).tolist(),
                               docc=np.asarray(s.result.docc).tolist(),
                               phi=np.asarray(s.result.phisc).tolist(),
                               gimp=pairs(g[n]), impf=pairs(f[n]))
                          for n, s in enumerate(solver.solvers)])
    elif part == "capi":
        cfg = set_config(default_config(**INEQ_CAPI, ed_verbose=0))
        nlat, h = INEQ_CAPI_NLAT, INEQ_CAPI_HSTAG
        solver = EDIneqSolver(nlat, cfg)
        baths = solver.init_solver()
        solver.set_hloc(_site_hloc(cfg.norb, [0.5 * (2 * s - nlat + 1) * h
                                              for s in range(nlat)]))
        solver.solve(baths)
        out = dict(dens=solver.get_dens().tolist(),
                   docc=solver.get_docc().tolist(),
                   eimp=solver.get_eimp().tolist(),
                   gimp=pairs(solver.get_gimp()))
    print(f"ineq {part}: done")
    with open(path, "w") as fh:
        json.dump(out, fh)


def write_ineq_golden():
    """The parts loop1 (the statics-only call, the full call and the fit),
    superc and capi run together, then loop2 from loop1's fitted baths."""
    import subprocess
    import tempfile

    def run(parts, paths, extra=()):
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "ineq_part", p, paths[p], *extra])
                 for p in parts]
        if any(proc.wait() != 0 for proc in procs):
            raise SystemExit("ineq golden: a part failed")

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {p: os.path.join(tmp, p + ".json") for p in
                 ("loop1", "loop2", "superc", "capi")}
        run(("loop1", "superc", "capi"), paths)
        run(("loop2",), paths, (paths["loop1"],))
        for p, path in paths.items():
            with open(path) as fh:
                res[p] = json.load(fh)
    commit = subprocess.run(["git", "log", "-1", "--format=%h", "--",
                             "edipack_tpu"], capture_output=True, text=True,
                            cwd=os.path.dirname(HERE)).stdout.strip()
    out = dict(source=f"edipack_tpu (last commit {commit}) EDIneqSolver on "
                      f"the CPU (f64 KronMatvec, exact GF; fits by "
                      f"L-BFGS-B, no mixing)",
               config=INEQ, nmats=NMATS, wband=WBAND, hloc=INEQ_HLOC,
               uloc_ii=INEQ_ULOC, ust_ii=INEQ_UST,
               **{k: res["loop1"][k] for k in ("bath", "statics", "loop1",
                                               "fit")},
               **res["loop2"],
               superc=dict(config=INEQ_SUPERC, hloc=[0.1, -0.1],
                           uloc_ii=INEQ_SUPERC_ULOC, **res["superc"]),
               capi=dict(config=INEQ_CAPI, nlat=INEQ_CAPI_NLAT,
                         hstag=INEQ_CAPI_HSTAG, **res["capi"]))
    with open(OUT_INEQ, "w") as fh:
        json.dump(out, fh)
    print(f"wrote {OUT_INEQ}: {os.path.getsize(OUT_INEQ)} bytes")


def main(modes):
    if modes[:1] == ["ineq"]:
        write_ineq_golden()
        return
    if modes[:1] == ["ineq_part"]:
        ineq_part(*modes[1:])
        return
    if modes[:1] == ["joint"]:
        write_joint_golden()
        return
    if modes[:1] == ["extras_part"]:
        extras_part(*modes[1:3])
        return
    if modes[:1] == ["extras"]:
        write_extras_golden(modes[1:])
        return
    for mode in modes or ("float64", "float32"):
        if mode == "dmft":
            write_dmft_golden()
        else:
            write_golden(mode)


if __name__ == "__main__":
    main(sys.argv[1:])
