#!/usr/bin/env python3
"""Record, on a card, how many clusters of each launch of ``jacobi_sweeps``
and ``rrqr_kernel`` the card holds at once, for every shape whose plan asks
the card: the main path's (8, 512, 512) Jacobi sweeps and (32, 512, 512)
RRQR, and the card tests' shapes that do not fit one block, in float32 and
float64.

    python3 tools/jacobi_rrqr_resident.py [OUT]

It builds only ``csrc/jacobi_sweep.cu`` and ``csrc/rrqr.cu`` and asks
cudaOccupancyMaxActiveClusters (``resident_clusters`` of each wrapper) for
every placement of each shape. It writes a JSON object (default
``tests/h100_jacobi_rrqr_resident.json``): the card's name and power limit,
and for each kernel and dtype a map "m n" → [[cluster, vglobal, clusters
held], ...] (Jacobi) or [[cluster, clusters held], ...] (RRQR), which
``tests/test_torch_jacobi_rrqr_plan.py`` hands to the plans on the CPU, so
that the CPU tests run the rule the card runs on the card's numbers.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (m, n) of W for jacobi_sweeps and of A for rrqr_kernel
JACOBI = ((512, 512), (256, 256), (128, 128))
RRQR = ((512, 512), (300, 260))


def main():
    import torch

    from nd4js_tpu_torch.ops import _build
    from nd4js_tpu_torch.ops import jacobi_sweep as js
    from nd4js_tpu_torch.ops import rrqr_kernel as rk

    if not torch.cuda.is_available():
        raise SystemExit("jacobi_rrqr_resident: needs a CUDA card")
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "h100_jacobi_rrqr_resident.json")
    _build._sources = lambda: [_build._CSRC / "jacobi_sweep.cu",
                               _build._CSRC / "rrqr.cu"]
    lib = ctypes.CDLL(str(_build.build()[0]))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    table = {"card": card, "jacobi": {}, "rrqr": {}}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        table["jacobi"][name] = {
            f"{m} {n}": [[c, int(vg), k] for (c, vg), k in
                         js._resident_on(m, n, dtype, 0)]
            for m, n in JACOBI}
        table["rrqr"][name] = {
            f"{m} {n}": [[c, k] for c, k in rk._resident_on(m, n, dtype, 0)]
            for m, n in RRQR}
    # one line a shape
    text = json.dumps(table, separators=(",", ":"))
    text = text.replace(':{"', ':{\n"').replace('],"', '],\n"')
    with open(out, "w") as f:
        f.write(text + "\n")
    print(json.dumps(table))


if __name__ == "__main__":
    main()
