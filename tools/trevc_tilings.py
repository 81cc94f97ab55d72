#!/usr/bin/env python3
"""Time trevc_solve at (1, 1024, 1024) in float32 on several tilings, in
turns, in several processes, on one card.

    python3 tools/trevc_tilings.py [PROCESSES] [OUT]

Builds only ``csrc/trevc_solve.cu`` (one nvcc call, in the first process;
the others load that build), then runs PROCESSES processes (default 4) one
after another. Each makes the seeded triangular input of ``chip_smoke.py``'s
``phase2_trevc`` (``triangular_pair``, seed 7, no cluster), runs every
tiling once, then times each in turns over 5 rounds by CUDA events around
10 calls: the plan's tiles (``card_plan``), uniform tiles of 1, 3, 4, 6 and
8 columns, and FORMER, the tiles that the plan chose at this shape when it
modeled each tile's cost (1 column wide at the right, 8 at the left), kept
here as data to compare against. The several processes show whether a
tiling's time changes when its blocks are placed anew. Each process prints
one JSON line, beside the card's name and power limit, appended to OUT
(default build/trevc_tilings.jsonl).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N = 1024
ROUNDS = 5
CALLS = 10
# (width, tiles of that width) from the right: the cost-model plan's tiles
FORMER = ((1, 71), (2, 28), (3, 16), (4, 10), (5, 7), (6, 5), (7, 4),
          (8, 89), (4, 1))


def former_tiles() -> tuple:
    out, k1 = [], N
    for w, count in FORMER:
        for _ in range(count):
            out.append((k1 - w, w))
            k1 -= w
    assert k1 == 0
    return tuple(out)


def child(proc: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nd4js_tpu_torch.ops import _build
    from nd4js_tpu_torch.ops import trevc_solve as tv

    if not torch.cuda.is_available():
        raise SystemExit("trevc_tilings: needs a CUDA card")
    _build._sources = lambda: [_build._CSRC / "trevc_solve.cu"]
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if k.startswith("nd4js_trevc_solve")}
    args = cs.triangular_pair(np.random.default_rng(7), N, False,
                              torch.float32)
    tilings = {"plan": tv.card_plan(1, N, torch.float32, args[0].device),
               "former": former_tiles()}
    for w in (1, 3, 4, 6, 8):
        tilings[f"tiles of {w}"] = cs.uniform_tiles(N, w)
    for t in tilings.values():
        tv._trevc_solve_in(*args, t)
    torch.cuda.synchronize()
    ms = {k: [] for k in tilings}
    for _ in range(ROUNDS):
        for k, t in tilings.items():
            ms[k].append(cs.cuda_ms(lambda t=t: tv._trevc_solve_in(*args, t),
                                    CALLS))
    card = cs.run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
    return {"proc": proc, "card": card,
            "tiles": {k: len(t) for k, t in tilings.items()}, "ms": ms}


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        print(json.dumps(child(args[1])))
        return
    procs = int(args[0]) if args else 4
    out = Path(args[1]) if len(args) > 1 else ROOT / "build" / \
        "trevc_tilings.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for p in range(1, procs + 1):
        res = subprocess.run([sys.executable, __file__, "--child", str(p)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"trevc_tilings: process {p} failed")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
