"""The joint-sector operators of edipack_tpu_torch against edipack_tpu's on
the CPU: the host builder (models/joint.py), the padded-ELL JointMatvec,
the scatter-add JointMatvecDirect and the blocked-Kron JointKronMatvec
(with and without phonons, in chunks smaller than a sector), each against
JAX's JointSectorOp.to_dense() and its JointMatvec at 1e-12; then the
complex128 Lanczos, the GF weights of a complex eigenbasis and the superc
twin relabeling (mirrors the operator checks of tests/test_joint_kron.py
at small size)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edipack_tpu.bath.dmft_bath import init_bath as j_init_bath
from edipack_tpu.bath.replica import make_basis as j_make_basis
from edipack_tpu.config import default_config as j_config
from edipack_tpu.models.joint import build_joint_sector_op as j_build
from edipack_tpu.ops.matvec import JointMatvec as JJointMatvec
from edipack_tpu.sectors import SectorTable as JSectorTable
from edipack_tpu.umatrix import build_umatrix as j_umatrix

from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.bath.replica import make_basis
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.models.joint import build_joint_sector_op
from edipack_tpu_torch.models.joint_kron import build_joint_kron_op
from edipack_tpu_torch.ops import matvec as tmv
from edipack_tpu_torch.ops.lanczos import eigsh_lowest, lanczos_tridiag
from edipack_tpu_torch.sectors import SectorTable
from edipack_tpu_torch.solver.greens import _moments_from_phi
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
OP_TOL = 1e-12           # relative to the largest |H| element / |Hv|
SOC = np.zeros((2, 2, 2, 2), complex)
SOC[0, 1] = 0.1j * np.eye(2)
SOC[1, 0] = -0.1j * np.eye(2)
SOC[0, 0] = SOC[1, 1] = [[0.1, 0.05], [0.05, -0.1]]

# (model, sector quantum numbers, hloc, hloc_anomalous, replica basis)
CASES = {
    "superc": (dict(norb=2, nbath=1, ed_mode="superc", uloc=[-2.0, -1.5],
                    ust=-1.0, jh=0.25, jx=0.25, jp=0.25, deltasc=0.1),
               ("sz", 0), np.diag([0.1, -0.1])[None, None],
               np.array([[0.05, 0.02], [0.02, -0.03]]), None),
    "superc-sz1-hybrid": (dict(norb=2, nbath=2, ed_mode="superc",
                               bath_type="hybrid", uloc=[-1.0, -1.0],
                               deltasc=0.05), ("sz", 1),
                          np.zeros((1, 1, 2, 2)), None, None),
    "nonsu2": (dict(norb=2, nbath=1, nspin=2, ed_mode="nonsu2",
                    uloc=[2.0, 2.0], ust=1.2, jh=0.25, jx=0.25, jp=0.25,
                    spin_field_x=[0.1, 0.2], spin_field_y=[0.05, 0.0]),
               ("nt", 4), SOC, None, None),
    "nonsu2-replica": (dict(norb=2, nbath=1, nspin=2, ed_mode="nonsu2",
                            bath_type="replica", uloc=[1.0, 1.0]),
                       ("nt", 3), SOC, None, "spin"),
    "superc-replica": (dict(norb=2, nbath=1, ed_mode="superc",
                            bath_type="replica", uloc=[-1.0, -1.0]),
                       ("sz", 0), np.zeros((1, 1, 2, 2)), None, "nambu"),
    "superc-phonon": (dict(norb=1, nbath=2, ed_mode="superc", uloc=[-1.5],
                           deltasc=0.12, nph=3, g_ph=[0.3], w0_ph=0.7),
                      ("sz", 0), np.zeros((1, 1, 1, 1)), None, None),
    "nonsu2-phonon": (dict(norb=2, nbath=1, nspin=2, ed_mode="nonsu2",
                           uloc=[1.0, 1.0], ust=0.5, jh=0.1, nph=2,
                           g_ph=[0.2, 0.3], w0_ph=0.5), ("nt", 3), SOC,
                      None, None),
}


def _basis_ops(kind):
    if kind == "nambu":
        o1 = np.zeros((2, 2, 2, 2), complex)
        o1[0, 0] = np.diag([1.0, -1.0])
        o1[1, 1] = -o1[0, 0].T
        o2 = np.zeros((2, 2, 2, 2), complex)
        o2[0, 1] = o2[1, 0] = np.eye(2)
        return np.stack([o1, o2]), np.array([[0.4, 0.2]])
    eye = np.zeros((2, 2, 2, 2), complex)
    eye[0, 0] = eye[1, 1] = np.eye(2)
    return np.stack([eye, SOC]), np.array([[0.3, 0.5]])


def _build(name):
    """(JAX op, port op, port sector, port (cfg, hloc, um, bath, han))."""
    model, qn, hloc, han, bkind = CASES[name]
    jcfg, cfg = j_config(**model), default_config(**model)
    jb = b = None
    if bkind is not None:
        ops, lam = _basis_ops(bkind)
        jb = j_make_basis(ops, lam, nbath=cfg.nbath)
        b = make_basis(ops, lam, nbath=cfg.nbath)
    jbath, bath = j_init_bath(jcfg, jb), init_bath(cfg, b)
    jsec = JSectorTable(jcfg).by_qn(qn)
    sec = SectorTable(cfg).by_qn(qn)
    jop = j_build(jcfg, jsec, hloc, j_umatrix(jcfg), jbath,
                  hloc_anomalous=han)
    um = build_umatrix(cfg)
    op = build_joint_sector_op(cfg, sec, hloc, um, bath, hloc_anomalous=han)
    return jop, op, sec, (cfg, hloc, um, bath, han)


def _dense(mv, dim, internal=False):
    eye = torch.eye(dim, dtype=torch.complex128, device=mv.device)
    cols = []
    for i in range(dim):
        v = mv.to_internal_flat(eye[i]) if internal else eye[i]
        w = mv(v)
        cols.append(mv.from_internal_flat(w) if internal else w)
    return torch.stack(cols, 1).cpu().numpy()


@pytest.fixture(scope="module", params=list(CASES))
def built(request):
    return request.param, _build(request.param)


def test_host_builder_matches(built):
    """The port's copy of the host builder gives edipack_tpu's COO, diagonal
    and phonon terms exactly."""
    _, (jop, op, _, _) = built
    for k in ("rows", "cols", "vals", "diag", "ph_mat", "ph_x", "eph_diag",
              "eph_rows", "eph_cols", "eph_vals"):
        a, b = getattr(jop, k), getattr(op, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("route", ["ell", "direct", "kron"])
def test_operator_against_jax_dense(built, route, monkeypatch):
    """Each route's matrix (column by column through the matvec, in chunks
    of a few rows or terms) against JAX's to_dense(), and one random
    vector against JAX's JointMatvec."""
    name, (jop, op, sec, args) = built
    monkeypatch.setattr(tmv, "CHUNK_ELEMS", 64)     # several chunks
    want = jop.to_dense()
    if route == "kron":
        mv = build_joint_kron_op(args[0], sec, *args[1:4], CPU,
                                 hloc_anomalous=args[4])
    else:
        cls = tmv.JointMatvec if route == "ell" else tmv.JointMatvecDirect
        mv = cls(op, CPU)
    assert mv.dtype == torch.complex128 and mv.dim == want.shape[0]
    got = _dense(mv, mv.dim, internal=route == "kron")
    assert np.abs(got - want).max() <= OP_TOL * np.abs(want).max()
    rng = np.random.default_rng(4)
    v = rng.normal(size=mv.dim) + 1j * rng.normal(size=mv.dim)
    jw = np.asarray(JJointMatvec(jop)(jnp.asarray(v)))
    tv = torch.as_tensor(v)
    w = (mv.from_internal_flat(mv(mv.to_internal_flat(tv)))
         if route == "kron" else mv(tv)).numpy()
    assert np.abs(w - jw).max() <= OP_TOL * np.abs(jw).max()
    assert mv.nnz > 0 and mv.n_calls > 0


def test_ell_matvec_chunks(monkeypatch):
    """EllMatvec over a batch axis gives the same result in one chunk and
    in chunks of a few rows."""
    rng = np.random.default_rng(0)
    cols = rng.integers(0, 50, size=(50, 7)).astype(np.int32)
    vals = rng.normal(size=(50, 7)) + 1j * rng.normal(size=(50, 7))
    mv = tmv.EllMatvec(cols, vals, CPU)
    v = torch.as_tensor(rng.normal(size=(3, 50)) + 0j)
    one = mv.apply(v)
    monkeypatch.setattr(tmv, "CHUNK_ELEMS", 30)
    assert torch.equal(mv.apply(v), one)
    want = np.einsum("ik,pik->pi", vals, v.numpy()[:, cols])
    assert np.abs(one.numpy() - want).max() <= 1e-14 * np.abs(want).max()


def _hermitian(dim, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    return (a + a.conj().T) / 2


def test_complex_lanczos_lowest():
    """eigsh_lowest in complex128 on a dense Hermitian operator: the lowest
    levels of np.linalg.eigh and eigenvectors with residuals at rounding."""
    h = torch.as_tensor(_hermitian(300, 1))

    class Op:
        device, dim = CPU, 300

        def __call__(self, v):
            return h @ v

    vals, vecs = eigsh_lowest(Op(), 300, 3, dtype=torch.complex128, m=80,
                              tol=1e-13, max_restarts=40)
    want = np.linalg.eigvalsh(h.numpy())[:3]
    assert np.abs(vals - want).max() <= 1e-10
    assert vecs.dtype == torch.complex128
    for e, v in zip(vals, vecs):
        assert float(torch.linalg.norm(h @ v - e * v)) <= 1e-8


def test_complex_gf_moments():
    """GF weights of a complex eigenbasis are |<n|φ>|² (with the
    conjugate): the dense-eig route and the Lanczos route give the same
    moments Σ w E^k as the dense formula φ† H^k φ."""
    hn = _hermitian(200, 2)
    h = torch.as_tensor(hn)
    rng = np.random.default_rng(3)
    phi = torch.as_tensor(rng.normal(size=200) + 1j * rng.normal(size=200))
    evals, evecs = np.linalg.eigh(hn)
    w_d, e_d = _moments_from_phi(None, phi, 2, dense_eig=(
        evals, torch.as_tensor(evecs)))

    class Op:
        device, dim = CPU, 200

        def __call__(self, v):
            return h @ v

    w_l, e_l = _moments_from_phi(Op(), phi, 200)
    p = phi.numpy()
    for k in range(4):
        want = np.real(p.conj() @ np.linalg.matrix_power(hn, k) @ p)
        scale = abs(want) + np.linalg.norm(p) ** 2 \
            * np.abs(evals).max() ** k
        assert abs(np.sum(w_d * e_d ** k) - want) <= 1e-11 * scale
        assert abs(np.sum(w_l * e_l ** k) - want) <= 1e-9 * scale
    a, b, n0 = lanczos_tridiag(Op(), phi, 10)
    assert a.dtype == torch.float64 and b.dtype == torch.float64
    assert abs(float(n0) - np.linalg.norm(p)) <= 1e-12 * np.linalg.norm(p)


def test_superc_twin_state_against_jax():
    """The superc twin relabeling Sz -> -Sz (solver/diag.py
    _twin_state_joint) against edipack_tpu's on a random vector."""
    from edipack_tpu.solver.diag import _twin_state_joint as j_twin
    from edipack_tpu_torch.solver.diag import _twin_state_joint
    model = dict(norb=2, nbath=1, ed_mode="superc", nph=1)
    jt, t = JSectorTable(j_config(**model)), SectorTable(
        default_config(**model))
    rng = np.random.default_rng(5)
    for qn, qt in ((("sz", 1), ("sz", -1)), (("sz", 2), ("sz", -2))):
        sec, tw = t.by_qn(qn), t.by_qn(qt)
        v = rng.normal(size=sec.dim) + 1j * rng.normal(size=sec.dim)
        want = np.asarray(j_twin(jt.by_qn(qn), jt.by_qn(qt), jnp.asarray(v)))
        got = _twin_state_joint(sec, tw, torch.as_tensor(v)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.cuda
def test_kron_graph_replay_on_card():
    """On a CUDA tensor JointKronMatvec replays apply() as a CUDA graph, one
    for each input shape: two different vectors, and two different (3, dim)
    blocks, give apply()'s results (the static input buffer is refreshed),
    and the operator still matches JAX's dense matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    jop, _, sec, args = _build("nonsu2-phonon")
    dev = torch.device("cuda")
    mv = build_joint_kron_op(args[0], sec, *args[1:4], dev,
                             hloc_anomalous=args[4])
    rng = np.random.default_rng(6)
    for shape in ((mv.dim,), (mv.dim,), (3, mv.dim), (3, mv.dim)):
        v = torch.as_tensor(rng.normal(size=shape)
                            + 1j * rng.normal(size=shape), device=dev)
        want = mv.apply(v)
        got = mv(v)
        assert shape in mv._graphs and got.shape == shape
        assert float((got - want).abs().max()) <= 1e-14 * float(
            want.abs().max())
    dense = _dense(mv, mv.dim, internal=True)
    want = jop.to_dense()
    assert np.abs(dense - want).max() <= OP_TOL * np.abs(want).max()
