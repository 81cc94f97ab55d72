#!/usr/bin/env python3
"""Tell rounding from a fault in trevc_solve's gap to its plain version.

For several seeds, at chip_smoke.py's two trevc_solve inputs (config 4's
n = 1024, and n = 192 with a defective cluster of three) in float32 and
float64, runs the CUDA kernel and its plain version in the same type and,
as a witness, the plain version in float64 on the same rounded input with
the same thresholds. Columns are compared after scaling each to unit norm
(chip_smoke.py's ``unit_columns``). Per input it prints, over columns:

* ``kernel_plain``: max |kernel − plain|, what chip_smoke.py holds to TOL;
* ``kernel_f64`` and ``plain_f64``: each one's max distance to the witness;
* ``excess``: the largest ratio, column by column, of the kernel's
  distance to the witness over the plain version's (floored at eps). A
  column where the plain version happens to land near the witness makes
  it large even for a kernel that only rounds differently, so read it
  beside kernel_f64 against plain_f64: a fault sets those far apart;
* ``growth``: log10 of the largest unscaled column norm of the witness,
  a measure of how far the back substitution amplifies rounding;
* ``over_tol``: the columns where kernel_plain exceeds TOL.

The float64 rows have no higher-precision witness (their witness columns
are null). Needs one CUDA card; run from the repository root:

    python3 tools/trevc_witness.py [SEEDS]        (default 12)

One JSON line per input, then a summary line; the lines also go to
build/trevc_witness.jsonl (not committed).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from nd4js_tpu_torch.ops import trevc_solve as tv  # noqa: E402


def column_gap(x, y):
    """Per column, max over rows of |x − y| on both parts."""
    return torch.maximum((x[0] - y[0]).abs().amax(-2),
                         (x[1] - y[1]).abs().amax(-2))[0]


def one(rng, n, cluster, dtype):
    args = cs.triangular_pair(rng, n, cluster, dtype)
    xk = cs.unit_columns(tv.trevc_solve(*args))
    xp = cs.unit_columns(tv.trevc_solve_ref(*args))
    kp = column_gap(xk, xp)
    row = {"n": n, "cluster": cluster, "dtype": str(dtype),
           "kernel_plain": float(kp.max()),
           "over_tol": int((kp > cs.TOL[dtype]).sum()),
           "kernel_f64": None, "plain_f64": None, "excess": None,
           "growth": None}
    if dtype == torch.float32:
        wide = [a.double() if torch.is_tensor(a) else a for a in args]
        raw = tv.trevc_solve_ref(*wide)
        nrm = torch.sqrt((raw[0] ** 2 + raw[1] ** 2).sum(-2))
        xw = cs.unit_columns(raw)
        kw = column_gap((xk[0].double(), xk[1].double()), xw)
        pw = column_gap((xp[0].double(), xp[1].double()), xw)
        eps = torch.finfo(dtype).eps
        row |= {"kernel_f64": float(kw.max()), "plain_f64": float(pw.max()),
                "excess": float((kw / pw.clamp(min=eps)).max()),
                "growth": float(torch.log10(nrm.max()))}
    return row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("trevc_witness: needs a CUDA card")
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    rows = []
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "trevc_witness.jsonl"), "w") as f:
        for i in range(seeds):
            rng = np.random.default_rng(cs.SEED + i)
            for dtype in (torch.float32, torch.float64):
                for n, cluster in ((1024, False), (192, True)):
                    row = {"seed": cs.SEED + i} | one(rng, n, cluster, dtype)
                    rows.append(row)
                    line = json.dumps(row)
                    print(line, flush=True)
                    f.write(line + "\n")
        summary = {"inputs": len(rows)}
        for dtype in ("torch.float32", "torch.float64"):
            for n in (1024, 192):
                sel = [r for r in rows if r["dtype"] == dtype and r["n"] == n]
                key = f"{dtype[6:]} n={n}"
                summary[key] = {
                    "over_tol_inputs": sum(r["over_tol"] > 0 for r in sel),
                    "kernel_plain_max": max(r["kernel_plain"] for r in sel)}
                if dtype == "torch.float32":
                    summary[key] |= {
                        "kernel_f64_max": max(r["kernel_f64"] for r in sel),
                        "plain_f64_max": max(r["plain_f64"] for r in sel),
                        "excess_max": max(r["excess"] for r in sel)}
        line = json.dumps(summary)
        print(line, flush=True)
        f.write(line + "\n")


if __name__ == "__main__":
    main()
