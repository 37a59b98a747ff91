"""ed_profile_dir / EDIPACK_TPU_TORCH_PROFILE_DIR on the CPU: a normal-mode
solve with a trace directory writes one torch.profiler Chrome trace there
and returns the same e0, G and observables as the untraced solve; with
neither set no profiler is made and nothing is written."""
import json
import os

import numpy as np
import pytest
import torch

from edipack_tpu_torch import device as dev_mod
from edipack_tpu_torch.bath.dmft_bath import init_bath
from edipack_tpu_torch.config import default_config
from edipack_tpu_torch.solver.core import solve_impurity
from edipack_tpu_torch.umatrix import build_umatrix

torch.set_num_threads(1)
CPU = torch.device("cpu")
MODEL = dict(norb=1, nbath=3, nspin=1, uloc=[2.0], xmu=0.8, ed_verbose=0)
Z = 1j * np.pi / 1000.0 * (2 * np.arange(16) + 1)


def _solve(**kw):
    cfg = default_config(**MODEL, **kw)
    hloc = np.full((1, 1, 1, 1), 0.1)
    res = solve_impurity(cfg, hloc, build_umatrix(cfg), init_bath(cfg), CPU)
    return dict(e0=res.e0, gimp=res.get_gimp(Z), dens=res.dens,
                docc=res.docc, energies=res.energies), res


def _same(a, b):
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.fixture(scope="module")
def untraced():
    return _solve()[0]


def _one_trace(path):
    files = os.listdir(path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(path, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)      # CPU activity recorded


def test_profile_dir_field_writes_trace(untraced, tmp_path, monkeypatch):
    monkeypatch.delenv(dev_mod.PROFILE_ENV, raising=False)
    out, res = _solve(ed_profile_dir=str(tmp_path / "trace"))
    _same(out, untraced)
    _one_trace(tmp_path / "trace")
    assert set(res.timings) >= {"diagonalization", "greens_functions",
                                "observables"}


def test_profile_env_writes_trace(untraced, tmp_path, monkeypatch):
    monkeypatch.setenv(dev_mod.PROFILE_ENV, str(tmp_path))
    out, _ = _solve()
    _same(out, untraced)
    _one_trace(tmp_path)


def test_no_profile_dir_no_profiler(untraced, tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("a profiler was made without a trace dir")

    monkeypatch.delenv(dev_mod.PROFILE_ENV, raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    out, _ = _solve()
    _same(out, untraced)
    assert os.listdir(tmp_path) == []
