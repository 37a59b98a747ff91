"""The port's native host library (edipack_tpu_torch/native: its own copy
of edipack_native.cpp, built with g++ into build/ at first use) against
edipack_tpu.native's wrappers over the JAX package's copy and against the
port's NumPy functions (fock.py), exactly, on numpy-seeded registers of up
to 24 levels; fock.enumerate_states through it, and through NumPy under
EDIPACK_TPU_TORCH_NO_NATIVE=1; a source that does not compile raises with
the compiler's message."""
import numpy as np
import pytest

from edipack_tpu import native as j_native
from edipack_tpu_torch import fock, native

# (ns, n) registers: both enumerations of the NumPy path (ns <= 20 by a
# popcount mask, wider ones by the recursion), up to the 2,704,156 states
# of ns = 24, n = 12
REGISTERS = [(5, 2), (12, 6), (20, 10), (22, 7), (24, 3), (24, 12)]


@pytest.fixture
def numpy_path(monkeypatch):
    """fock.enumerate_states under EDIPACK_TPU_TORCH_NO_NATIVE=1 (the
    library loaded before, for the direct calls)."""
    native.load()
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    fock.enumerate_states.cache_clear()
    yield fock.enumerate_states
    fock.enumerate_states.cache_clear()


def _registers(ns, n, count, seed):
    """``count`` seeded states of ``ns`` levels and popcount ``n``, sorted,
    and as many seeded ones of any popcount (some outside the basis)."""
    rng = np.random.default_rng(seed)
    basis = native.enum_states(ns, n)
    pick = np.sort(rng.choice(len(basis), min(count, len(basis)),
                              replace=False))
    other = rng.integers(0, 1 << ns, size=count, dtype=np.int64)
    return basis[pick], other


def _ops(ns, seed, length=4):
    rng = np.random.default_rng(seed)
    return [(("c", "cdg")[int(k)], int(lvl))
            for k, lvl in zip(rng.integers(0, 2, length),
                              rng.integers(0, ns, length))]


def test_available_and_built_under_build():
    assert native.available() and j_native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("build", "edipack_tpu_torch",
                                           "native")


@pytest.mark.parametrize("ns, n", REGISTERS)
def test_enum_states(ns, n, numpy_path):
    got = native.enum_states(ns, n)
    assert np.array_equal(got, j_native.enum_states(ns, n))
    assert np.array_equal(got, numpy_path(ns, n))
    assert len(got) == fock.binom(ns, n) and np.all(np.diff(got) > 0)


@pytest.mark.parametrize("ns, n", REGISTERS[1:])
def test_apply_opstring_and_index(ns, n):
    """apply_opstring of seeded strings on seeded states, and the index
    search of seeded states (present or not) in a seeded basis."""
    basis, other = _registers(ns, n, 4000, seed=ns + n)
    for seed in range(4):
        ops = _ops(ns, seed)
        st, sg, ok = native.apply_opstring(basis, ops)
        jst, jsg, jok = j_native.apply_opstring(basis, ops)
        assert np.array_equal(st, jst) and np.array_equal(sg, jsg)
        assert np.array_equal(ok, jok)
        ref, rsg, rok = basis.copy(), np.ones(len(basis)), np.ones(
            len(basis), bool)
        for kind, lvl in ops:
            ref, s, v = (fock.apply_c if kind == "c" else fock.apply_cdg)(
                ref, lvl)
            rsg, rok = rsg * s, rok & v
        assert np.array_equal(ok, rok) and np.array_equal(sg, rsg)
        assert np.array_equal(st[ok], ref[ok])
        assert np.array_equal(st[~ok], basis[~ok])
    probe = np.concatenate([basis[::3], other])
    got = native.state_index(basis, probe)
    want = np.empty(len(probe), np.int64)
    j_native.load().edn_state_index(basis, len(basis), probe, len(probe),
                                     want)
    assert np.array_equal(got, want)
    assert np.array_equal(got, fock.state_index(basis, probe))
    assert (got >= 0).sum() >= len(basis[::3])


@pytest.mark.parametrize("ns, n", [(8, 4), (14, 5), (24, 3)])
def test_hop_elements(ns, n):
    basis = native.enum_states(ns, n)
    rng = np.random.default_rng(ns)
    pairs = [(0, ns - 1), (ns - 1, 0), (2, 2)] + [
        tuple(int(x) for x in rng.integers(0, ns, 2)) for _ in range(4)]
    for i, j in pairs:
        got = native.hop_elements(basis, i, j)
        for want in (j_native.hop_elements(basis, i, j),
                     fock.hop_elements(basis, ns, i, j)):
            for a, b in zip(got, want):
                assert np.array_equal(a, b), (i, j)


def test_fock_enumeration_goes_native(monkeypatch, numpy_path):
    """fock.enumerate_states calls native.enum_states while the library is
    on, and NumPy (same arrays) under EDIPACK_TPU_TORCH_NO_NATIVE=1."""
    by_numpy = [numpy_path(ns, n) for ns, n in REGISTERS]
    assert not native.available()
    monkeypatch.delenv(native.NO_NATIVE_ENV)
    fock.enumerate_states.cache_clear()
    calls = []
    real = native.enum_states
    monkeypatch.setattr(native, "enum_states",
                        lambda ns, n: calls.append((ns, n)) or real(ns, n))
    assert native.available()
    for (ns, n), want in zip(REGISTERS, by_numpy):
        assert np.array_equal(fock.enumerate_states(ns, n), want)
    assert calls == REGISTERS
    assert fock.enumerate_states(6, 0).tolist() == [0]
    assert fock.enumerate_states(6, 7).size == 0


def test_broken_source_raises(tmp_path, monkeypatch):
    """A source that does not compile: load() raises with g++'s message,
    and nothing is left in the build directory."""
    src = tmp_path / "edipack_native.cpp"
    src.write_text('extern "C" long edn_binom(int n, int k) { return n +; }\n')
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native library build failed"
                       ) as err:
        native.load()
    assert "error" in str(err.value)
    assert not any(p.is_file() for p in (tmp_path / "build").rglob("*"))
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(FileNotFoundError):
        native.load()
