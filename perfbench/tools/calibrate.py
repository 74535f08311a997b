"""The readings the limits of a cell are set from, on the card, in one
process: for each seed a run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the sampled iteration) and the compared numbers of
the program against the float64 reference, each frame's too, with the
pieces of ``reg_stall``; for the control seeds the control's (the reference
in TF32 in the program's place at the same iteration).

    python3 perfbench/tools/calibrate.py --workload twoset_dense.n131k \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 10 \
        --out chiprun_out/calibrate_twoset_dense.n131k.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def em_path(prob, snap, device):
    """The sampled iteration's EM in float64 step by step to its step limit:
    per step the relative free-energy change over the tolerance (the stop
    test's) and the program's GMM's distance from that step's (``em_err``)."""
    import numpy as np
    import torch

    from perfbench.reference import check as rc
    from perfbench.reference import gmm as rgmm

    cfg = prob["config"]
    t = lambda a: torch.as_tensor(np.asarray(a), device=device, dtype=torch.float64)  # noqa: E731
    x = t(snap["x1_before"])
    k, n, d = x.shape
    xf, mf = x.reshape(k * n, d), t(snap["inputs"]["xmask"]).reshape(k * n)
    if snap["it"] == 0:
        st = rc.start_state(prob, snap["inputs"], device, torch.float64)
    else:
        g = snap["gmm_before"]
        st = rgmm.State(mu=t(g["mu"]), w=t(g["w"]), sigma=t(g["sigma"]))
    out, last = [], None
    for i in range(cfg["loop"]["em"]["max_iterations"]):
        st, tg = rgmm.em_step(st, xf, mf, cfg["gmm"], "float64")
        fe = float(tg.fe)
        rel = abs(fe - last) / abs(last) / cfg["loop"]["em"]["tol"] if last else None
        out.append([i + 1, rel, rc._em_err(snap["gmm_after"], st, prob["extent"])])
        last = fe
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--em-path", action="store_true",
                    help="also record the float64 EM step by step (``em_path``)")
    args = ap.parse_args()

    import torch

    from perfbench.harness import window as win
    from perfbench.reference import check as rc

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    controls = {int(s) for s in args.control_seeds.split(",") if s}

    def frames(got, ref, extent):
        return {k: v.tolist() for k, v in rc.frame_errors(got, ref, extent).items()}

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c, entry, prob, reg = win.setup(args.workload, seed, "cuda")
        rec = win.window(entry, prob, reg, "cuda", args.seconds, seed, False)
        win.free(reg)
        del reg
        t1 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        snap = dict(rec["snapshot"], extent=prob["extent"])
        ref = rc.outputs(prob, snap, "float64", "cuda")
        t2 = time.perf_counter()
        row = {"seed": seed, "it": snap["it"], "em": snap["em"],
               "wall_s": rec["wall_s"], "evals": rec["evals"],
               "iteration_ends": rec["iteration_ends"],
               "reference_em_steps": [c for c, _, _ in ref["em"]],
               "frames": frames(rc.program_outputs(snap), ref, prob["extent"]),
               "iterations": rec["iterations"], "failed": rec["failed"],
               "registrations": rec["registrations"], "cohort": snap["inputs"]["cohort"],
               "f_before": ref["f_before"].tolist(), "f_after": ref["f_after"].tolist(),
               "sd_drop": ref["sd_drop"].tolist(),
               "reference_s": t2 - t1, "run_s": t1 - t0,
               "program": rc.numbers(rc.program_outputs(snap), ref, prob["extent"])}
        if snap["em"] and args.em_path:
            row["em_path"] = em_path(prob, snap, "cuda")
        if "cover" in ref:
            row.update(cover_band=ref["cover_band"], uncovered=int(snap["uncovered"].sum()),
                       uncovered_sure=int(ref["cover"][0].sum()),
                       uncovered_maybe=int(ref["cover"][1].sum()))
        if seed in controls:
            t3 = time.perf_counter()
            ctl = rc.outputs(prob, snap, "tf32", "cuda")
            row["control_s"] = time.perf_counter() - t3
            row["control"] = rc.numbers(rc.control_outputs(ctl), ref, prob["extent"])
            row["control_frames"] = frames(rc.control_outputs(ctl), ref, prob["extent"])
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ref
        torch.cuda.empty_cache()
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
