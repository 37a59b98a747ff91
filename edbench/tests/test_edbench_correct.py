"""The comparison that decides ``correct``, at a tiny size of each mode on
the CPU: the port passes against the plain reference; the control (the
reference in the precision below the configuration's) fails the cell's
limits; and a run whose timed path is broken underneath comes out not
correct, for each fault a cell can have."""

import numpy as np
import pytest
import torch

import edipack_tpu_torch.main as edmain
from edbench.core import check, traffic
from edbench.core.registry import Registry
from edbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("checkout")
    tiny.make(r)
    return r


CELLS = ["tiny_normal.restart_gf", "tiny_superc.restart_gf"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_passes(root, cell, capsys):
    rc, res = tiny.run(root, cell, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    """The reference in control_dtype in the program's place."""
    reg = Registry(root)
    c = reg.cell(cell)
    conf = reg.config(c["config"])
    mix = reg.traffic(c["traffic"])
    mod = check.load_reference(root, conf)
    torch.set_num_threads(2)
    bath = next(traffic.baths(mod.default_bath(conf["params"]), mix, 12345,
                              1))
    ref = mod.solve(conf, bath, getattr(torch, conf["reference_dtype"]), "cpu")
    ctl = mod.solve(conf, bath, getattr(torch, conf["control_dtype"]), "cpu")
    numbers = check.compare(ctl, ref)
    assert not check.verdict(numbers, c["limits"])


def _stale(monkeypatch):
    """A solve that returns its state unchanged: the previous answer."""
    real = edmain.ed_solve
    first = {}

    def solve(bath=None, flag_gf=True):
        if "res" not in first:
            first["res"] = real(bath, flag_gf=flag_gf)
        return first["res"]
    monkeypatch.setattr(edmain, "ed_solve", solve)


def _half_states(monkeypatch):
    """Half of the kept states left out, the mean taken over the rest."""
    from edipack_tpu_torch.solver import eigenspace
    real = eigenspace.StateList.boltzmann_weights

    def weights(self):
        w = np.asarray(real(self), float).copy()
        keep = max(1, len(w) // 2)
        w[keep:] = 0.0
        return w / w.sum()
    monkeypatch.setattr(eigenspace.StateList, "boltzmann_weights", weights)


def _altered(monkeypatch):
    """An answer altered where it is produced: every Källén-Lehmann weight
    of the solve's GF store off by 1e-6."""
    from edipack_tpu_torch.solver import greens
    real = greens.GFMatrix.add

    def add(self, key, weights, poles):
        return real(self, key, np.asarray(weights) * (1 + 1e-6), poles)
    monkeypatch.setattr(greens.GFMatrix, "add", add)


# the faults each cell can have: the superc cell keeps one state
FAULTS = [("tiny_normal.restart_gf", _stale),
          ("tiny_normal.restart_gf", _half_states),
          ("tiny_normal.restart_gf", _altered),
          ("tiny_superc.restart_gf", _stale),
          ("tiny_superc.restart_gf", _altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c.split('.')[0]}-{f.__name__[1:]}"
                              for c, f in FAULTS])
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, res = tiny.run(root, cell, seconds=4.0, capsys=capsys)
    assert rc == 0 and res["correct"] is False


def test_superc_keeps_one_state(root):
    """Why the superc cell has no half-states fault: its kept multiplet
    at this model is one level."""
    reg = Registry(root)
    conf = reg.config("tiny_superc")
    mix = reg.traffic("restart_gf")
    mod = check.load_reference(root, conf)
    bath = next(traffic.baths(mod.default_bath(conf["params"]), mix, 7, 1))
    torch.set_num_threads(2)
    ref = mod.solve(conf, bath, torch.complex128, "cpu", False)
    assert len(ref["kept"]) == 1
