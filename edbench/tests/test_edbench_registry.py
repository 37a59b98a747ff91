"""The harness finds cells, mixes, configurations and metric readers from
files alone; a cell, configuration, mix and metric dropped in as new files
and BENCHMARK.json entries are found and run without editing any file
that was there."""
import hashlib
import json
from pathlib import Path

import pytest

from edbench.core.registry import Registry
from edbench.tests import tiny


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "edbench").rglob("*")) if p.is_file()}


def test_repo_benchmark_is_complete():
    reg = Registry()
    bench = reg.benchmark
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        conf = reg.config(cell["config"])
        reg.traffic(cell["traffic"])
        assert (reg.root / conf["reference"]).is_file()
        for kind in ("end_to_end", "per_layer"):
            for m in reg.metrics(w["name"], kind):
                assert callable(reg.reader(m["name"]))
        names = {m["name"] for m in reg.metrics(w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert reg.metrics(w["name"], "per_layer")
    for c in bench["configs"]:
        assert c["file"].startswith("edbench/configs/")
        assert reg.config(c["name"]) == json.loads(
            (reg.root / c["file"]).read_text())


def test_dropped_in_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    tiny.make(root)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new mix, configuration, cell and metric: files and entries only
    mix = json.loads((root / "edbench/traffic/restart_gf.json").read_text())
    mix["bath_moves"] = {}
    (root / "edbench/traffic/still_bath.json").write_text(json.dumps(mix))
    conf = json.loads((root / "edbench/configs/tiny_normal.json").read_text())
    conf["params"]["uloc"] = [3.0, 3.0]
    (root / "edbench/configs/tiny_normal_u3.json").write_text(
        json.dumps(conf))
    cell = json.loads((root / "edbench/cells/"
                       "tiny_normal.restart_gf.json").read_text())
    cell.update(config="tiny_normal_u3", traffic="still_bath")
    (root / "edbench/cells/tiny_normal_u3.still_bath.json").write_text(
        json.dumps(cell))
    (root / "edbench/metrics/solves_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.solves))\n")
    bench["workloads"].append(dict(name="tiny_normal_u3.still_bath",
                                   config="tiny_normal_u3",
                                   traffic="still_bath", chips=1, why="new"))
    bench["configs"].append(dict(name="tiny_normal_u3", source="test",
                                 file="edbench/configs/tiny_normal_u3.json",
                                 reduced=[], why="new"))
    bench["per_layer"].append(dict(name="solves_in_window", unit="count",
                                   better="higher", source="program_counter",
                                   layer="API", moves="solve_s",
                                   workloads=["tiny_normal_u3.still_bath"]))
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("tiny_normal_u3.still_bath")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(root)
    assert reg.cell("tiny_normal_u3.still_bath")["traffic"] == "still_bath"
    assert reg.config("tiny_normal_u3")["params"]["uloc"] == [3.0, 3.0]
    names = [m["name"] for m in reg.metrics("tiny_normal_u3.still_bath",
                                            "per_layer")]
    assert names == ["solves_in_window"]
    ctx = type("Ctx", (), {"solves": [{}, {}, {}]})()
    assert reg.read_metrics("tiny_normal_u3.still_bath", "per_layer",
                            ctx)["solves_in_window"]["value"] == 3.0
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


def test_unknown_names_fail(tmp_path):
    root = tmp_path / "checkout"
    tiny.make(root)
    reg = Registry(root)
    with pytest.raises(SystemExit):
        reg.cell("no_such.cell")
    with pytest.raises(SystemExit):
        reg.reader("no_such_metric")


@pytest.mark.parametrize("src", ["tiny_normal", "tiny_superc"])
def test_dropped_in_full_scan_cell_runs(tmp_path, src, capsys):
    """A cell without a restart (every sector of the configuration, as a
    first DMFT iteration solves) added as files and entries alone: no
    restart file is written, the reference walks every sector, and the
    run is correct; a listed metric whose reader finds nothing is named
    under ``missing``."""
    root = tmp_path / "checkout"
    tiny.make(root)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / f"edbench/configs/{src}.json").read_text())
    conf["params"]["ed_sectors"] = False
    conf.pop("restart_sectors")
    name = f"{src}_scan"
    (root / f"edbench/configs/{name}.json").write_text(json.dumps(conf))
    cell = json.loads((root / f"edbench/cells/{src}.restart_gf.json")
                      .read_text())
    cell.update(config=name, check_solves=1)
    (root / f"edbench/cells/{name}.restart_gf.json").write_text(
        json.dumps(cell))
    (root / "edbench/metrics/never_read.py").write_text(
        "def read(ctx):\n    return None\n")
    bench["workloads"].append(dict(name=f"{name}.restart_gf", config=name,
                                   traffic="restart_gf", chips=1, why="new"))
    bench["configs"].append(dict(name=name, source="test",
                                 file=f"edbench/configs/{name}.json",
                                 reduced=[], why="new"))
    bench["end_to_end"].append(dict(name="never_read", unit="s",
                                    better="lower", source="host_clock",
                                    bound=0.1,
                                    workloads=[f"{name}.restart_gf"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from edbench.core import check
    reg = Registry(root)
    mod = check.load_reference(root, reg.config(name))
    assert mod.sectors(reg.config(name)) == mod.all_sectors(conf["params"])

    rc, res = tiny.run(root, f"{name}.restart_gf", seconds=1.0,
                       capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert res["missing"] == ["never_read"]
    assert list(res)[-2:] == ["missing", "checks"]
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
