#!/usr/bin/env python3
"""Time jacobi_sweeps and rrqr_kernel, and the paths around them, in one or
more checkouts of the repository on one card.

    python3 tools/jacobi_rrqr_ab.py [--no-walls] [--out FILE] ROOT ...

Each ROOT is a directory that holds ``nd4js_tpu_torch/`` and
``chip_smoke.py`` (the repository itself, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). Each runs in a process of its
own, in the order given, so that two versions compare on one card in
turns: parent, change, change, parent. First every distinct ROOT builds,
all at once, only the kernels those paths run (``csrc/jacobi_sweep.cu``,
``csrc/rrqr.cu`` and ``csrc/house_stripe.cu``, the Householder panels of
the SVD's pre-QR), one nvcc call each; the timed processes load those
builds. Inputs come from each root's own ``chip_smoke.py`` and from fixed
seeds, float32:

* ``jacobi_ms``: one sweep of jacobi_sweeps (through its public wrapper) on
  a (1024, 64, 64) W, lstsq's Rᵀ shape, and on a (8, 512, 512) W, config
  3's; ``rrqr_ms``: rrqr_kernel on config 2's SPD systems (1024, 128, 128)
  and on the (32, 512, 512) batch of rrqr_decomp;
* ``device_ms``: on the device (CUDA events around three calls), config
  3's ``svd_decomp(method="jacobi")`` + ``svd_lstsq``, ``lstsq`` of
  (1024, 128, 64), ``solve`` on config 2's systems and ``rrqr_decomp`` of
  the 512² batch;
* ``walls``: host-clock ms, three runs after a warm-up, of the same four.

One JSON line per root, each beside the card's name and power limit, on
standard output and appended to FILE (default build/jacobi_rrqr_ab.jsonl).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

TIMEOUT_S = 600
SOURCES = ("jacobi_sweep", "rrqr", "house_stripe")


def setup(root: str):
    """Import that root's package and chip_smoke.py, with the build
    restricted to the paths' sources."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from nd4js_tpu_torch.ops import _build

    csrc = _build._CSRC
    _build._sources = lambda: [csrc / f"{k}.cu" for k in SOURCES]
    return cs, _build


def lib_path(root: str) -> str:
    name = os.path.abspath(root).strip("/").replace("/", "_")
    return os.path.abspath(os.path.join("build", "jacobi_rrqr_ab",
                                        name + ".so"))


def build_child(root: str) -> dict:
    _, _build = setup(root)
    path, seconds, _ = _build.build()
    os.makedirs(os.path.dirname(lib_path(root)), exist_ok=True)
    shutil.copy(path, lib_path(root))
    return {"root": root, "sources": list(SOURCES), "build_s": seconds}


def time_child(root: str, walls: bool) -> dict:
    import ctypes
    from pathlib import Path

    import numpy as np
    import torch

    cs, _build = setup(root)
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_rrqr_ab: needs a CUDA card")
    lib = ctypes.CDLL(lib_path(root))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    _build._built = (Path(lib_path(root)), 0.0, "")
    from nd4js_tpu_torch import la
    from nd4js_tpu_torch.ops import jacobi_sweep as js, rrqr_kernel as rk

    dev = cs.DEVICE
    out = {"root": root,
           "card": cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"]).splitlines()[0]}
    rng = np.random.default_rng(cs.SEED + 12)
    w64 = torch.from_numpy(rng.standard_normal((1024, 64, 64))).to(
        dev, torch.float32)
    w512 = torch.from_numpy(rng.standard_normal((8, 512, 512))).to(
        dev, torch.float32)
    v64 = torch.eye(64, device=dev).repeat(1024, 1, 1)
    v512 = torch.eye(512, device=dev).repeat(8, 1, 1)
    out["jacobi_ms"] = {
        "(1024, 64, 64)": cs.cuda_ms(lambda: js.jacobi_sweeps(w64, v64, 1),
                                     10),
        "(8, 512, 512)": cs.cuda_ms(lambda: js.jacobi_sweeps(w512, v512, 1),
                                    3)}
    gen = torch.Generator().manual_seed(cs.SEED)
    a = torch.randn((32, 512, 512), generator=gen).to(dev)
    spd2, y2 = cs.config2_inputs(torch.Generator().manual_seed(cs.SEED + 2))
    out["rrqr_ms"] = {
        "(1024, 128, 128)": cs.cuda_ms(lambda: rk.rrqr_kernel(spd2), 10),
        "(32, 512, 512)": cs.cuda_ms(lambda: rk.rrqr_kernel(a), 3)}
    if hasattr(js, "card_plan"):
        out["plans"] = {
            "jacobi (8, 512, 512)": js.regime(*js.card_plan(
                8, 512, 512, torch.float32, w512.device)),
            "rrqr (32, 512, 512)": rk.regime(*rk.card_plan(
                32, 512, 512, torch.float32, a.device), 512)}
    a3, y3 = cs.config3_inputs(np.random.default_rng(cs.SEED + 3))
    gen = torch.Generator().manual_seed(cs.SEED + 6)
    small = torch.randn((1024, 128, 64), generator=gen).to(dev)
    ys = torch.randn((1024, 128, 1), generator=gen).to(dev)

    def cfg3():
        u, sv, v = la.svd_decomp(a3, method="jacobi")
        return la.svd_lstsq(u, sv, v, y3)

    paths = {"config 3 by one-sided Jacobi": cfg3,
             "lstsq (1024, 128, 64)": lambda: la.lstsq(small, ys),
             "solve (1024, 128, 128)": lambda: la.solve(spd2, y2),
             "rrqr_decomp (32, 512, 512)": lambda: la.rrqr_decomp(a)}
    out["device_ms"] = {k: cs.cuda_ms(f, 3) for k, f in paths.items()}
    out["walls"] = {k: cs.wall_ms(f) for k, f in paths.items()} \
        if walls else {}
    return out


def run(cmd, tag):
    """Run a child; its result line (tag + JSON), or a JSON failure."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return None, {"cmd": cmd[-2:], "rc": f"timeout after {TIMEOUT_S} s"}
    res = [ln[len(tag):] for ln in proc.stdout.splitlines()
           if ln.startswith(tag)]
    if proc.returncode or not res:
        return None, {"cmd": cmd[-2:], "rc": proc.returncode,
                      "tail": (proc.stdout + proc.stderr)[-3000:]}
    return json.loads(res[0]), None


def main():
    tag = "JACOBI_RRQR_AB "
    args = sys.argv[1:]
    if args and args[0] == "--build":
        print(tag + json.dumps(build_child(args[1])), flush=True)
        return
    if args and args[0] == "--time":
        print(tag + json.dumps(time_child(args[1], args[2] == "1")),
              flush=True)
        return
    out = os.path.join("build", "jacobi_rrqr_ab.jsonl")
    if "--out" in args:
        out = args.pop(args.index("--out") + 1)
    roots = [a for a in args if a not in ("--no-walls", "--out")] or ["."]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    me = os.path.abspath(__file__)
    # every distinct root builds at once, each in its own process
    procs = {r: subprocess.Popen([sys.executable, me, "--build", r],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for r in dict.fromkeys(roots)}
    failed = 0
    for r, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        line = [ln for ln in log.splitlines() if ln.startswith(tag)]
        if proc.returncode or not line:
            print(json.dumps({"root": r, "build": "failed",
                              "tail": log[-3000:]}), flush=True)
            failed += 1
        else:
            print(line[0][len(tag):], flush=True)
    if failed:
        sys.exit(1)
    for root in roots:
        res, err = run([sys.executable, me, "--time", root,
                        str(int("--no-walls" not in args))], tag)
        line = json.dumps(res if err is None else {"root": root} | err)
        failed += err is not None
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
