#!/usr/bin/env python3
"""Time chol_leaf and trevc_solve, and the paths around them, in one or more
checkouts of the repository on one card.

    python3 tools/leaf_trevc_ab.py [--no-walls] [--out FILE] ROOT ...

Each ROOT is a directory that holds ``nd4js_tpu_torch/`` and
``chip_smoke.py`` (the repository itself, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). Each runs in a process of its
own, in the order given, so that two versions compare on one card in
turns: parent, change, change, parent. First every distinct ROOT builds,
all at once, only the kernels those paths run (``csrc/chol_leaf.cu``,
``trevc_solve.cu``, ``lu_panel.cu`` and ``house_stripe.cu`` for config 2
and the Householder fallback of ``qr(auto)``, ``schur_small.cu`` and
``bulge_chase.cu`` for config 4's eigen), one nvcc call each; the timed
processes load those builds. Inputs come from each root's own
``chip_smoke.py`` and from fixed seeds, float32:

* ``chol_leaf_ms``: chol_leaf with L⁻¹ through its public wrapper at config
  2's first leaf (1024, 64, 64), the 512² batch's (32, 64, 64) and a batch
  of one (1, 64, 64): ``wrapper`` by CUDA events around 20 calls (host and
  device), ``device`` by a CUDA graph of 20 calls replayed (the device
  alone);
* ``trevc_ms``: trevc_solve on the triangular Tc of config 4's Schur form
  (1, 1024, 1024), CUDA events around 10 calls;
* ``device_ms``: on the device (CUDA events around three calls), the 512²
  ``cholesky_decomp``, config 2 (``lu_solve_fused``,
  ``cholesky_decomp(inv=True)``, ``cholesky_solve``) and
  ``qr_decomp(method="auto")`` of the 512² batch;
* ``walls``: host-clock ms, three runs after a warm-up, of those three and
  of config 4's ``eigen(split=True)`` of its 1024² matrix.

One JSON line per root, each beside the card's name and power limit, on
standard output and appended to FILE (default build/leaf_trevc_ab.jsonl).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

TIMEOUT_S = 900
SOURCES = ("chol_leaf", "trevc_solve", "lu_panel", "house_stripe",
           "schur_small", "bulge_chase")


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
    return os.path.abspath(os.path.join("build", "leaf_trevc_ab",
                                        name + ".so"))


def build_child(root: str) -> dict:
    _, _build = setup(root)
    path, seconds, _ = _build.build()
    os.makedirs(os.path.dirname(lib_path(root)), exist_ok=True)
    shutil.copy(path, lib_path(root))
    return {"root": root, "sources": list(SOURCES), "build_s": seconds}


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one fn() call: reps calls in a CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def time_child(root: str, walls: bool) -> dict:
    import ctypes
    from pathlib import Path

    import numpy as np
    import torch

    cs, _build = setup(root)
    if not torch.cuda.is_available():
        raise SystemExit("leaf_trevc_ab: needs a CUDA card")
    lib = ctypes.CDLL(lib_path(root))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    _build._built = (Path(lib_path(root)), 0.0, "")
    from nd4js_tpu_torch import la
    from nd4js_tpu_torch.ops import chol_leaf as cl, trevc_solve as tv

    dev = cs.DEVICE
    out = {"root": root,
           "card": cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"]).splitlines()[0]}
    gen = torch.Generator().manual_seed(cs.SEED)
    a = torch.randn((32, 512, 512), generator=gen).to(dev)
    spd512 = torch.matmul(a, a.mT) / 512 + 2 * torch.eye(512, device=dev)
    spd2, y2 = cs.config2_inputs(torch.Generator().manual_seed(cs.SEED + 2))
    out["chol_leaf_ms"] = {}
    for leaf in (spd2[:, :64, :64].contiguous(),
                 spd512[:, :64, :64].contiguous(),
                 spd512[:1, :64, :64].contiguous()):
        out["chol_leaf_ms"][str(tuple(leaf.shape))] = {
            "wrapper": cs.cuda_ms(lambda x=leaf: cl.chol_leaf(x, True), 20),
            "device": graph_ms(lambda x=leaf: cl.chol_leaf(x, True))}
    rng = np.random.default_rng(cs.SEED + 7)
    s = torch.from_numpy(rng.standard_normal((1024, 1024))).to(
        dev, torch.float32)
    trevc_in = cs.eigen_kernel_inputs(s)[-1]
    out["trevc_ms"] = {"(1, 1024, 1024)": cs.cuda_ms(
        lambda: tv.trevc_solve(*trevc_in), 10)}
    paths = {"cholesky_decomp (32, 512, 512)":
             lambda: la.cholesky_decomp(spd512),
             "config 2": lambda: cs.config2(spd2, y2),
             "qr_decomp(method='auto') (32, 512, 512)":
             lambda: la.qr_decomp(a, method="auto")}
    out["device_ms"] = {k: cs.cuda_ms(f, 3) for k, f in paths.items()}
    paths["config 4 eigen (1024, 1024)"] = lambda: la.eigen(s, split=True)
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
    tag = "LEAF_TREVC_AB "
    args = sys.argv[1:]
    if args and args[0] == "--build":
        print(tag + json.dumps(build_child(args[1])), flush=True)
        return
    if args and args[0] == "--time":
        print(tag + json.dumps(time_child(args[1], args[2] == "1")),
              flush=True)
        return
    out = os.path.join("build", "leaf_trevc_ab.jsonl")
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
