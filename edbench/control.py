"""Readings that set the limits of a cell's correctness check, on the card.

    python3 edbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out FILE]

Lower readings: for each of ``--seeds``, the program solves the first
window bath of that seed (after the cell's set-up and warm-up, as a run
does), and each solve is compared with the plain reference in the
configuration's precision (``reference_dtype``). Upper readings: for each
of ``--control-seeds``, the control (the reference computed in the
configuration's ``control_dtype``, the nearest precision below, with TF32
off) takes the program's place and is compared the same way. Prints one
JSON object (and writes it to ``--out``): every seed's numbers and the
largest lower and smallest upper reading of each number. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]

    import gc
    import torch
    from edbench.core import check, traffic
    from edbench.core.registry import Registry
    from edbench.run import start_solver
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    reg = Registry(root)
    cell = reg.cell(args.workload)
    conf = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    ref = check.load_reference(root, conf)
    params = conf["params"]
    flag_gf = bool(mix.get("flag_gf", True))
    base = ref.default_bath(params)
    dev = torch.device(device)

    import edipack_tpu_torch.main as ed
    outdir = tempfile.mkdtemp(prefix="edbench_control_",
                              dir=os.environ.get("TMPDIR"))
    start_solver(ed, ref, conf, outdir, device)
    ed.ed_solve(ref.pack(next(traffic.baths(base, mix, seeds[0], 0))),
                flag_gf=flag_gf)
    progs, baths = {}, {}
    for s in sorted(set(seeds) | set(cseeds)):
        baths[s] = next(traffic.baths(base, mix, s, 1))
        if s in seeds:
            res = ed.ed_solve(ref.pack(baths[s]), flag_gf=flag_gf)
            progs[s] = ref.read_back(ed, res, params, flag_gf)
            res = None
    ed.ed_finalize_solver()
    shutil.rmtree(outdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref_dt = getattr(torch, conf["reference_dtype"])
    ctl_dt = getattr(torch, conf["control_dtype"])
    out = dict(workload=args.workload, lower={}, upper={}, seconds={})
    refs = {}
    for s in sorted(baths):
        t0 = time.perf_counter()
        refs[s] = ref.solve(conf, baths[s], ref_dt, dev, flag_gf)
        out["seconds"].setdefault("reference", []).append(
            time.perf_counter() - t0)
        if s in progs:
            out["lower"][s] = check.compare(progs[s], refs[s])
        if s in cseeds:
            t0 = time.perf_counter()
            ctl = ref.solve(conf, baths[s], ctl_dt, dev, flag_gf)
            out["seconds"].setdefault("control", []).append(
                time.perf_counter() - t0)
            out["upper"][s] = check.compare(ctl, refs[s])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    keys = next(iter(out["lower"].values())).keys()
    out["max_lower"] = {k: max(r[k] for r in out["lower"].values())
                        for k in keys}
    out["min_upper"] = {k: min(r[k] for r in out["upper"].values())
                        for k in keys}
    text = json.dumps(out, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return out


if __name__ == "__main__":
    main()
