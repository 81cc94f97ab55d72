#!/usr/bin/env python3
"""Tell rounding from a fault in sytrd_panel's float64 gap to its plain
version.

For several seeds, at chip_smoke.py's float64 input of phase2_sytrd (a
symmetric (3, 100, 100) batch, bk = 63), runs the CUDA kernel through its
wrapper and on each cluster size that phase2_sytrd runs (1-5), the plain
version on the card and on the host (float64, another order of
summation), and holds each to a witness in numpy's long double
(``chip_smoke.sytrd_panel_wide``, the plain version's arithmetic with an
11 bits wider significand). It also takes the spread: the largest change
of the witness's outputs over PERTURB symmetric eps-relative
perturbations C·(1 + eps·r), a measure of how far rounding of the input
alone moves each output. Per output (C_trailing, V, W, taus, d, e) and
seed, in units of phase2_sytrd's tolerance (SYTRD_C·eps·m, times max|C|
for the outputs that scale with C):

* ``kernel_plain``: max |kernel − plain on the card| over the launches;
* ``kernel``, ``plain``, ``host``: each one's distance to the witness
  (the kernel's the largest over its launches);
* ``spread``; ``ratio``: the kernel's distance over the larger of the two
  plain versions', what phase2_sytrd holds to SYTRD_R where the kernel
  stands more than one tolerance away.

A kernel that only rounds differently stands as far from the witness as
the plain version does in one order of summation or another, sometimes
nearer and sometimes further; a fault stands further on every seed. The
summary line gives, per output, the largest of each; the median and the
geometric mean of kernel over plain, kernel over host and host over
plain, and on how many seeds the first stood further; the largest ratio;
and the largest ratio where it binds.
Needs one CUDA card; builds only csrc/sytrd_panel.cu. From the
repository root:

    python3 tools/sytrd_witness.py [SEEDS] [OUT]    (64; build/...)

One JSON line per seed, then the summary; the lines also go to OUT
(default build/sytrd_witness.jsonl, not committed).
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from nd4js_tpu_torch.ops import _build  # noqa: E402
from nd4js_tpu_torch.ops import sytrd_panel as sp  # noqa: E402

NAMES = ("C_trailing", "V", "W", "taus", "d", "e")
SHAPE, BK, CLUSTERS, PERTURB = (3, 100, 100), 63, (1, 2, 3, 4, 5), 8


def gaps(got, wide, units):
    """Per output, max |got − wide| in tolerance units."""
    return [cs.wide_gap(g, w) / u for g, w, u in zip(got, wide, units)]


def one(seed):
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(cs.symmetric(rng, SHAPE)).to(cs.DEVICE)
    m = SHAPE[-1]
    eps = torch.finfo(torch.float64).eps
    cmax = cs.maxabs(c)
    unit = cs.SYTRD_C * eps * m
    units = [unit * s for s in (cmax, 1.0, cmax, 1.0, cmax, cmax)]
    wide = cs.sytrd_panel_wide(c, BK)
    spread = [0.0] * 6
    for _ in range(PERTURB):
        r = torch.from_numpy(rng.uniform(-1.0, 1.0, SHAPE))
        moved = cs.sytrd_panel_wide(c.cpu() * (1 + eps * (r + r.mT) / 2), BK)
        spread = [max(a, float(np.abs(o - w).max()) / u)
                  for a, o, w, u in zip(spread, moved, wide, units)]
    plain = sp.sytrd_panel_ref(c, BK)
    launches = [None] + [sp.launch_on(m, BK, c.dtype, k) for k in CLUSTERS]
    kp, kw = [0.0] * 6, [0.0] * 6
    for launch in launches:
        got = (sp.sytrd_panel(c, BK) if launch is None
               else sp._sytrd_panel_in(c, BK, launch))
        kp = [max(a, float((g - p).abs().max()) / u)
              for a, g, p, u in zip(kp, got, plain, units)]
        kw = [max(a, b) for a, b in zip(kw, gaps(got, wide, units))]
    pw = gaps(plain, wide, units)
    hw = gaps(sp.sytrd_panel_ref(c.cpu(), BK), wide, units)
    return {"seed": seed, "launches": len(launches),
            "kernel_plain": dict(zip(NAMES, kp)),
            "kernel": dict(zip(NAMES, kw)),
            "plain": dict(zip(NAMES, pw)),
            "host": dict(zip(NAMES, hw)),
            "spread": dict(zip(NAMES, spread)),
            "ratio": {n: a / max(b, c, 1e-6) for n, a, b, c in
                      zip(NAMES, kw, pw, hw)}}


def summary(rows):
    out = {"seeds": len(rows), "shape": list(SHAPE), "bk": BK,
           "perturbations": PERTURB,
           "long_double_eps": float(np.finfo(np.longdouble).eps)}
    for key in ("kernel_plain", "kernel", "plain", "host", "spread",
                "ratio"):
        out[key + "_max"] = {n: max(r[key][n] for r in rows) for n in NAMES}
    for a, b in (("kernel", "plain"), ("kernel", "host"),
                 ("host", "plain")):
        r = np.array([[row[a][n] / max(row[b][n], 1e-12) for n in NAMES]
                      for row in rows])
        out[f"{a}_over_{b}"] = {
            "median": dict(zip(NAMES, np.median(r, axis=0).tolist())),
            "geomean": dict(zip(NAMES, np.exp(np.log(r).mean(axis=0))
                                .tolist())),
            "max": dict(zip(NAMES, r.max(axis=0).tolist())),
            "further_seeds": dict(zip(NAMES, (r > 1).sum(axis=0).tolist()))}
    out["ratio_median"] = {n: float(np.median([r["ratio"][n] for r in rows]))
                           for n in NAMES}
    for who in ("kernel", "plain", "host"):
        out[who + "_over_spread_max"] = {
            n: max(r[who][n] / max(r["spread"][n], 1e-6) for r in rows)
            for n in NAMES}
    out["over_tolerance_seeds"] = {
        "kernel_plain": sum(max(r["kernel_plain"].values()) > 1
                            for r in rows),
        "kernel": sum(max(r["kernel"].values()) > 1 for r in rows),
        "plain": sum(max(r["plain"].values()) > 1 for r in rows),
        "host": sum(max(r["host"].values()) > 1 for r in rows)}
    # the ratio where it decides phase2_sytrd's check: the kernel more
    # than one tolerance from the witness
    out["binding_ratio_max"] = max(
        [r["ratio"][n] for r in rows for n in NAMES if r["kernel"][n] > 1]
        or [0.0])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sytrd_witness: needs a CUDA card")
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        "build", "sytrd_witness.jsonl")
    _build._sources = lambda: [_build._CSRC / "sytrd_panel.cu"]
    lib = ctypes.CDLL(str(_build.build()[0]))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    torch.set_num_threads(1)       # one summation order for the host runs
    rows = []
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        for i in range(seeds):
            rows.append(one(cs.SEED + i))
            line = json.dumps(rows[-1])
            print(line, flush=True)
            f.write(line + "\n")
        line = json.dumps(summary(rows))
        print(line, flush=True)
        f.write(line + "\n")


if __name__ == "__main__":
    main()
