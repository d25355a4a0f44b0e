#!/usr/bin/env python3
"""Does the sign of the line directions move the extraction's F-score?
On one NVIDIA GPU, from a finished run of scripts/torch_run_production.py.

    python3 scripts/torch_linedir_signs.py RUN_DIR [OUT.json]

The line direction of a candidate point is the smallest eigenvector of a
3x3 Gram matrix (extract/pointcloud.py), whose sign is the solver's
choice: cuSOLVER's on the card, LAPACK's on the host, where the JAX
package's CPU runs take it. This script runs `--mode extract_edge` of the
run's conf copy (RUN_DIR/<conf>_standin.conf) on its checkpoint three
times: as the port runs it (cuSOLVER's signs), with every smallest
eigenvector's sign flipped to agree with LAPACK's (torch.linalg.eigh of the
same matrices on the host), and as the port runs it again (the run's own
repeatability). Each is scored with the ABC protocol against the scene's
analytic wireframe; the lines print F@5/10/20mm, chamfer, the line and
curve counts, the picked threshold and how many signs were flipped, and
OUT.json (default RUN_DIR/linedir_signs.json) holds them. Nothing in the
package changes: the flip wraps torch.linalg.eigh in this process only.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def lapack_signed(eigh, counts: dict):
    """torch.linalg.eigh that, for a batch of 3x3 matrices on the card,
    turns each smallest eigenvector (column 0) to agree in sign with
    LAPACK's for the same matrix on the host; counts the matrices and the
    flips."""
    import torch

    def wrapped(m, *args, **kwargs):
        w, v = eigh(m, *args, **kwargs)
        if not (m.is_cuda and m.ndim == 3 and m.shape[-2:] == (3, 3)):
            return w, v
        host = eigh(m.cpu(), *args, **kwargs)[1][:, :, 0]
        dots = (v[:, :, 0].cpu() * host).sum(-1)
        flip = (dots < 0).to(m.device)
        counts["matrices"] += int(m.shape[0])
        counts["flipped"] += int(flip.sum())
        counts["apart"] += int((dots.abs() < 0.99).sum())
        v = v.clone()
        v[:, :, 0] = torch.where(flip[:, None], -v[:, :, 0], v[:, :, 0])
        return w, v

    return wrapped


def main(argv) -> int:
    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.cli import main as cli_main
    from emap_tpu_torch.eval.synthetic import score_extraction

    if not torch.cuda.is_available():
        raise SystemExit("torch_linedir_signs: needs a CUDA GPU")
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    run_dir = os.path.abspath(argv[0])
    out_path = argv[1] if len(argv) == 2 else os.path.join(
        run_dir, "linedir_signs.json")
    confs = glob.glob(os.path.join(run_dir, "*_standin.conf"))
    if len(confs) != 1:
        raise SystemExit(f"torch_linedir_signs: no single conf copy in "
                         f"{run_dir}: {confs}")
    conf = config.parse_file(confs[0])
    exp_dir = os.path.join(conf["general.base_exp_dir"],
                           str(conf["dataset.scan"]), conf["general.expname"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    eigh = torch.linalg.eigh
    rows = {}
    for name in ("cusolver", "lapack_signs", "cusolver_again"):
        counts = {"matrices": 0, "flipped": 0, "apart": 0}
        torch.linalg.eigh = (lapack_signed(eigh, counts)
                             if name == "lapack_signs" else eigh)
        try:
            cli_main(["--conf", confs[0], "--mode", "extract_edge"],
                     n_devices=1)
        finally:
            torch.linalg.eigh = eigh
        results = os.path.join(exp_dir, "results")
        with open(os.path.join(results, "parametric_edges.json")) as f:
            edges = json.load(f)
        with open(os.path.join(results, "threshold_selection.json")) as f:
            picked = json.load(f)["picked"]
        score = score_extraction(exp_dir, {
            "lines_end_pts": edges.get("lines_end_pts", []),
            "curves_ctl_pts": edges.get("curves_ctl_pts", [])}, "cube")
        rows[name] = {"picked": picked, "signs": counts,
                      **{k: score[k] for k in (
                          "fscore_0.005", "fscore_0.01", "fscore_0.02",
                          "chamfer", "n_lines", "n_curves")}}
        print(f"linedir {name}: {json.dumps(rows[name])}", flush=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "conf": confs[0], "runs": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
