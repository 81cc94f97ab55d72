#!/usr/bin/env python3
"""Time bulge_chase_steps and schur_small, and the general eigen paths
around them, in one or more checkouts of the repository on one card.

    python3 tools/eigen_ab.py [--check] [--no-walls] [--out FILE] ROOT ...

Each ROOT is a directory that holds ``nd4js_tpu_torch/`` and
``chip_smoke.py`` (the repository itself, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). Each runs in a process of its
own, in the order given, so that two versions compare on one card in
turns: parent, change, change, parent. A process builds only the kernels
of the general eigen path (``csrc/bulge_chase.cu``, ``schur_small.cu``
and ``trevc_solve.cu``, one nvcc call) and takes its inputs and timers
from that root's own ``chip_smoke.py``, at config 4's shapes:

* ``chase_ms``: one seeded 16-bulge slide of config 4's balanced
  Hessenberg matrix (W = 128, SL = 80), and ``chase_step_ms`` = that / SL;
* ``schur48_ms``, ``schur128_ms``, ``batch_ms``: schur_small on the AED
  window (1, 48, 48), small_win's (1, 128, 128) and the whole-matrix
  route's (256, 64, 64), each with ``*_step_ms`` = ms / the chase steps
  of the plain version's trajectory (for the batch, its slowest matrix
  of chip_smoke.SCHUR_SAMPLE);
* ``walls``: host-clock ms, three runs after a warm-up, of config 4's
  ``eigen`` (1024²), ``schur_decomp`` of its balanced matrix and
  ``eigen`` of the (256, 64, 64) batch.

With ``--check`` a process first runs that root's ``chip_smoke.py``
phase-2 checks of the two kernels in float32 and float64 (a failed check
prints its line and fails the root); ``--no-walls`` times the kernels
only. One JSON line per root, each beside the card's name and power limit,
on standard output and appended to FILE (default build/eigen_ab.jsonl).
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

KEEP = ("bulge_chase", "schur_small", "trevc_solve")


def chase_steps(moves) -> int:
    return sum(hi - lo - 2 for lo, hi in moves if hi - lo > 2)


def child(root: str, check: bool, walls: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from nd4js_tpu_torch import la
    from nd4js_tpu_torch.ops import _build, bulge_chase as bc, \
        schur_small as ss

    if not torch.cuda.is_available():
        raise SystemExit("eigen_ab: needs a CUDA card")
    # build only the general eigen path's kernels
    _build._sources = lambda: [p for p in sorted(_build._CSRC.glob("*.cu"))
                               if p.stem in KEEP]
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if any(s in k for s in KEEP)}
    _, seconds, log = _build.build()
    schur_mod = importlib.import_module("nd4js_tpu_torch.la.schur")
    out = {"root": root, "build_s": seconds,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "Compiling" in ln or "Used" in ln or "spill" in ln],
           "card": cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"]).splitlines()[0]}
    if check:
        rng = np.random.default_rng(cs.SEED)
        errs = {k: 0.0 for k in cs.KERNELS}
        for dtype in (torch.float32, torch.float64):
            cs.phase2_chase(rng, errs, dtype)
            cs.phase2_schur_small(rng, errs, dtype)
        out["checks"] = "passed"
    rng = np.random.default_rng(cs.SEED + 7)
    s = torch.from_numpy(rng.standard_normal((1024, 1024))).to(
        cs.DEVICE, torch.float32)
    ab = torch.from_numpy(rng.standard_normal((256, 64, 64))).to(
        cs.DEVICE, torch.float32)
    win48, win128, blk, shifts, _ = cs.eigen_kernel_inputs(s)
    _, bal_b = la.eigen_balance_pre(ab)
    hb = schur_mod._hessenberg_core(bal_b)[0].contiguous()
    W, nb = 128, 16
    sl = W - 3 * nb
    p0 = torch.zeros((nb, 3), device=cs.DEVICE)
    out["chase_ms"] = cs.cuda_ms(
        lambda: bc.bulge_chase_steps(blk, p0, shifts, 0, 0, W - 2, sl, True),
        20)
    out["chase_step_ms"] = out["chase_ms"] / sl
    for key, a, iters in (("schur48", win48, 20), ("schur128", win128, 5),
                          ("batch", hb, 5)):
        out[f"{key}_ms"] = cs.cuda_ms(lambda x=a: ss.schur_small(x), iters)
        steps = max(chase_steps(ss._schur_small_one(m, 40 * a.shape[-1])[4])
                    for m in a[:cs.SCHUR_SAMPLE].cpu())
        out[f"{key}_steps"] = steps
        out[f"{key}_step_ms"] = out[f"{key}_ms"] / steps
    _, bal = la.eigen_balance_pre(s)
    out["walls"] = {} if not walls else {
        "config 4 eigen (1024, 1024)": cs.wall_ms(
            lambda: la.eigen(s, split=True)),
        "schur_decomp (1024, 1024)": cs.wall_ms(lambda: la.schur_decomp(bal)),
        "eigen (256, 64, 64)": cs.wall_ms(lambda: la.eigen(ab, split=True))}
    if hasattr(bc, "plan"):
        out["chase_plan"] = list(bc.plan(W, nb, sl, torch.float32))
        out["schur_plans"] = {w: list(ss.plan(w, torch.float32))
                              for w in (48, 64, 128)}
    return out


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        print("EIGEN_AB " + json.dumps(child(args[1], args[2] == "1",
                                             args[3] == "1")), flush=True)
        return
    out = os.path.join("build", "eigen_ab.jsonl")
    if "--out" in args:
        out = args.pop(args.index("--out") + 1)
    flags = {"--check", "--no-walls", "--out"}
    roots = [a for a in args if a not in flags] or ["."]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    failed = 0
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root,
               str(int("--check" in args)), str(int("--no-walls" not in args))]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            lines = proc.stdout.splitlines()
            res = [ln[len("EIGEN_AB "):] for ln in lines
                   if ln.startswith("EIGEN_AB ")]
            if proc.returncode or not res:
                res = [json.dumps({"root": root, "rc": proc.returncode,
                                   "fails": [ln for ln in lines
                                             if "FAIL" in ln],
                                   "tail": (proc.stdout
                                            + proc.stderr)[-3000:]})]
                failed += 1
        except subprocess.TimeoutExpired:
            res = [json.dumps({"root": root, "rc": "timeout after 300 s"})]
            failed += 1
        print(res[0], flush=True)
        with open(out, "a") as f:
            f.write(res[0] + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
