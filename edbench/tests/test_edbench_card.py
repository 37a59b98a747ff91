"""On the card: one short run of each tiny cell through the harness's own
look for a chip, correct against the reference."""
import pytest

from edbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_normal.restart_gf",
                                  "tiny_superc.restart_gf"])
def test_tiny_cell_on_card(tmp_path, cell, capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from edbench import run as harness
    tiny.make(tmp_path)
    rc = harness.main(["--workload", cell, "--seed", "11", "--seconds", "2",
                       "--trace", "1"], root=tmp_path)
    import json
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["busy_s"] > 0
