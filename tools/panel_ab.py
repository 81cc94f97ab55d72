#!/usr/bin/env python3
"""Time sytrd_panel and house_panel, and the paths around them, in one or
more checkouts of the repository on one card.

    python3 tools/panel_ab.py [--no-walls] [--out FILE] ROOT ...

Each ROOT is a directory that holds ``nd4js_tpu_torch/`` and
``chip_smoke.py`` (the repository itself, ``.``, or a ``git archive`` of
another commit unpacked under ``build/``). Each runs in a process of its
own, in the order given, so that two versions compare on one card in
turns: parent, change, change, parent. First every distinct ROOT builds,
all at once, only the kernels of the two panels (``csrc/sytrd_panel.cu``,
and ``csrc/house_panel.cu`` where the checkout has one, else
``csrc/house_stripe.cu``, whose body house_panel runs on), one nvcc call
each; the timed processes load those builds. Inputs and timers come from
each root's own ``chip_smoke.py``, float32:

* ``sytrd_1024_ms``: one panel (bk = 64) of config 4's (1, 1024, 1024)
  symmetric matrix; ``sytrd_gram_ms``: of the (32, 512, 512) Gram batch;
* ``house_ms``: house_panel on the headline's four panel shapes
  (32, 512|384|256|128, 128), and their sum;
* ``sytrd_device_ms``: config 4's whole ``sytrd`` on the device;
  ``headline_device_ms``: ``qr_decomp`` + ``qr_lstsq`` of the
  (32, 512, 512) batch on the device;
* ``gram_dc_device_ms``: ``eigh_tridiag_dc`` of the Gram batch on the
  device;
* ``walls``: host-clock ms, three runs after a warm-up, of config 4's
  ``eigh``, of the headline and of the Gram batch's ``eigh_tridiag_dc``.

One JSON line per root, each beside the card's name and power limit, on
standard output and appended to FILE (default build/panel_ab.jsonl).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

TIMEOUT_S = 400


def setup(root: str):
    """Import that root's package and chip_smoke.py, with the build
    restricted to the two panels' sources."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from nd4js_tpu_torch.ops import _build

    csrc = _build._CSRC
    keep = ["sytrd_panel"] + (["house_panel"] if (csrc / "house_panel.cu")
                              .exists() else ["house_stripe"])
    _build._sources = lambda: [csrc / f"{k}.cu" for k in keep]
    return cs, _build, keep


def lib_path(root: str) -> str:
    name = os.path.abspath(root).strip("/").replace("/", "_")
    return os.path.abspath(os.path.join("build", "panel_ab", name + ".so"))


def build_child(root: str) -> dict:
    _, _build, keep = setup(root)
    path, seconds, _ = _build.build()
    os.makedirs(os.path.dirname(lib_path(root)), exist_ok=True)
    shutil.copy(path, lib_path(root))
    return {"root": root, "sources": keep, "build_s": seconds}


def time_child(root: str, walls: bool) -> dict:
    import ctypes
    from pathlib import Path

    import numpy as np
    import torch

    cs, _build, keep = setup(root)
    if not torch.cuda.is_available():
        raise SystemExit("panel_ab: needs a CUDA card")
    lib = ctypes.CDLL(lib_path(root))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    _build._built = (Path(lib_path(root)), 0.0, "")
    from nd4js_tpu_torch import la
    from nd4js_tpu_torch.la import sytrd as sytrd_mod
    from nd4js_tpu_torch.ops import house_panel as hp, sytrd_panel as sp

    out = {"root": root, "sources": keep,
           "card": cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"]).splitlines()[0]}
    rng = np.random.default_rng(cs.SEED + 4)
    sym = torch.from_numpy(cs.symmetric(rng, (1024, 1024))).to(
        cs.DEVICE, torch.float32)
    g = cs.gram(rng, (32, 512, 512))
    c4 = ((sym + sym.mT) * 0.5)[None].contiguous()
    cg = ((g + g.mT) * 0.5).contiguous()
    out["sytrd_1024_ms"] = cs.cuda_ms(lambda: sp.sytrd_panel(c4, 64), 20)
    out["sytrd_gram_ms"] = cs.cuda_ms(lambda: sp.sytrd_panel(cg, 64), 20)
    if hasattr(sp, "card_plan"):
        out["sytrd_plans"] = [list(sp.card_plan(*c.shape[:2], 64, c.dtype,
                                                c.device)) for c in (c4, cg)]
    gen = torch.Generator().manual_seed(cs.SEED)
    a = torch.randn((32, 512, 512), generator=gen).to(cs.DEVICE)
    y = torch.randn((32, 512, 1), generator=gen).to(cs.DEVICE)
    out["house_ms"] = [cs.cuda_ms(lambda p=a[:, k:, k:k + 128].contiguous():
                                  hp.house_panel(p), 20)
                       for k in range(0, 512, 128)]
    out["house_sum_ms"] = sum(out["house_ms"])

    def headline():
        q, r = la.qr_decomp(a)
        return la.qr_lstsq(q, r, y)

    out["sytrd_device_ms"] = cs.cuda_ms(lambda: sytrd_mod.sytrd(sym), 5)
    out["headline_device_ms"] = cs.cuda_ms(headline, 5)
    out["gram_dc_device_ms"] = cs.cuda_ms(lambda: la.eigh_tridiag_dc(g), 3)
    out["walls"] = {} if not walls else {
        "config 4 eigh (1024, 1024)": cs.wall_ms(lambda: la.eigh(sym)),
        "qr_decomp + qr_lstsq": cs.wall_ms(headline),
        "eigh_tridiag_dc Gram (32, 512, 512)":
            cs.wall_ms(lambda: la.eigh_tridiag_dc(g))}
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
    args = sys.argv[1:]
    if args and args[0] == "--build":
        print("PANEL_AB " + json.dumps(build_child(args[1])), flush=True)
        return
    if args and args[0] == "--time":
        print("PANEL_AB " + json.dumps(time_child(args[1], args[2] == "1")),
              flush=True)
        return
    out = os.path.join("build", "panel_ab.jsonl")
    if "--out" in args:
        out = args.pop(args.index("--out") + 1)
    roots = [a for a in args if a not in ("--no-walls", "--out")] or ["."]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    me = os.path.abspath(__file__)
    # every distinct root builds at once, each in its own process
    procs = {r: subprocess.Popen([sys.executable, me, "--build", r],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
             for r in dict.fromkeys(roots)}
    failed = 0
    for r, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        line = [ln for ln in log.splitlines() if ln.startswith("PANEL_AB ")]
        if proc.returncode or not line:
            print(json.dumps({"root": r, "build": "failed",
                              "tail": log[-3000:]}), flush=True)
            failed += 1
        else:
            print(line[0][len("PANEL_AB "):], flush=True)
    if failed:
        sys.exit(1)
    for root in roots:
        res, err = run([sys.executable, me, "--time", root,
                        str(int("--no-walls" not in args))], "PANEL_AB ")
        line = json.dumps(res if err is None else {"root": root} | err)
        failed += err is not None
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
