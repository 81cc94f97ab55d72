#!/usr/bin/env python3
"""Time lu_panel and lu_gesv, and the paths around them, in one or more
checkouts of the repository on one card.

    python3 tools/lu_ab.py [--no-walls] [--out FILE] ROOT ...

Each ROOT is a directory that holds ``nd4js_tpu_torch/`` and
``chip_smoke.py`` (the repository itself, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). Each runs in a process of its
own, in the order given, so that two versions compare on one card in
turns: parent, change, change, parent. First every distinct ROOT builds,
all at once, only the kernels those paths run (``csrc/lu_panel.cu``, and
``chol_leaf.cu`` for config 2's Cholesky), one nvcc call each; the timed
processes load those builds. Inputs come from each root's own
``chip_smoke.py`` and from fixed seeds, float32:

* ``lu_panel_ms``: lu_panel through its public wrapper on the 512²
  ``lu_decomp``'s four panel shapes (32, 512|384|256|128, 128), each
  ``device`` by a CUDA graph of 20 calls replayed (the device alone) and
  ``events`` by CUDA events around 10 calls (host and device), and their
  sums;
* ``lu_gesv_ms``: lu_gesv at config 2 (1024, 128, 128), K = 1, the same
  two ways;
* ``device_ms``: on the device (CUDA events around three calls), the 512²
  ``lu_decomp``, config 2 (``lu_solve_fused``,
  ``cholesky_decomp(inv=True)``, ``cholesky_solve``), config 2's
  ``lu_solve_fused`` alone and ``det`` of the 512² batch;
* ``walls``: host-clock ms, three runs after a warm-up, of those four.

One JSON line per root, each beside the card's name and power limit, on
standard output and appended to FILE (default build/lu_ab.jsonl).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

TIMEOUT_S = 900
SOURCES = ("lu_panel", "chol_leaf")


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
    return os.path.abspath(os.path.join("build", "lu_ab", name + ".so"))


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

    import torch

    cs, _build = setup(root)
    if not torch.cuda.is_available():
        raise SystemExit("lu_ab: needs a CUDA card")
    lib = ctypes.CDLL(lib_path(root))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    _build._built = (Path(lib_path(root)), 0.0, "")
    from nd4js_tpu_torch import la
    from nd4js_tpu_torch.ops import lu_panel as lp

    dev = cs.DEVICE
    out = {"root": root,
           "card": cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"]).splitlines()[0]}
    gen = torch.Generator().manual_seed(cs.SEED)
    a = torch.randn((32, 512, 512), generator=gen).to(dev)
    spd2, y2 = cs.config2_inputs(torch.Generator().manual_seed(cs.SEED + 2))
    out["lu_panel_ms"] = {}
    for k0 in range(0, 512, 128):
        p = a[:, k0:, k0:k0 + 128].contiguous()
        out["lu_panel_ms"][str(tuple(p.shape))] = {
            "device": graph_ms(lambda x=p: lp.lu_panel(x)),
            "events": cs.cuda_ms(lambda x=p: lp.lu_panel(x), 10)}
    panels = list(out["lu_panel_ms"].values())
    for how in ("device", "events"):
        out["lu_panel_ms"]["sum " + how] = sum(v[how] for v in panels)
    out["lu_gesv_ms"] = {
        "device": graph_ms(lambda: lp.lu_gesv(spd2, y2)),
        "events": cs.cuda_ms(lambda: lp.lu_gesv(spd2, y2), 10)}
    paths = {"lu_decomp (32, 512, 512)": lambda: la.lu_decomp(a),
             "config 2": lambda: cs.config2(spd2, y2),
             "config 2 lu_solve_fused": lambda: la.lu_solve_fused(spd2, y2),
             "det (32, 512, 512)": lambda: la.det(a)}
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
    tag = "LU_AB "
    args = sys.argv[1:]
    if args and args[0] == "--build":
        print(tag + json.dumps(build_child(args[1])), flush=True)
        return
    if args and args[0] == "--time":
        print(tag + json.dumps(time_child(args[1], args[2] == "1")),
              flush=True)
        return
    out = os.path.join("build", "lu_ab.jsonl")
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
