#!/usr/bin/env python3
"""Record, on a card, how many clusters of each launch of ``lu_panel`` the
card holds at once, for every panel shape the main path and the card checks
launch, in float32 and float64.

    python3 tools/lu_resident.py [OUT]

It builds only ``csrc/lu_panel.cu`` and asks cudaOccupancyMaxActiveClusters
(``lu_panel.resident_clusters``) for every placement of each shape (each
cluster size, rows in shared and in global memory). It writes a JSON object
(default ``tests/h100_lu_resident.json``): the card's name and power limit,
and for each dtype a map "m b" → [[cluster, shared, clusters held], ...],
which ``tests/test_torch_lu_plan.py`` hands to the plan on the CPU, so that
the CPU tests run the rule the card runs on the card's numbers. Rerun it
when the kernel's layout, threads or registers change.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (m, b) of every lu_panel launch of the main path (lu_decomp's four panels
# of the 512² batch) and of the card checks
PANELS = ((512, 128), (384, 128), (256, 128), (128, 128), (136, 40),
          (16, 16))


def main():
    import torch

    from nd4js_tpu_torch.ops import _build
    from nd4js_tpu_torch.ops import lu_panel as lp

    if not torch.cuda.is_available():
        raise SystemExit("lu_resident: needs a CUDA card")
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "h100_lu_resident.json")
    _build._sources = lambda: [_build._CSRC / "lu_panel.cu"]
    lib = ctypes.CDLL(str(_build.build()[0]))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    table = {"card": card}
    for dtype in (torch.float32, torch.float64):
        table[str(dtype).removeprefix("torch.")] = {
            f"{m} {b}": [[c, int(sh), k] for (c, sh), k in
                         lp._resident_on(m, b, dtype, 0)]
            for m, b in PANELS}
    # one line a shape
    text = json.dumps(table, separators=(",", ":"))
    text = text.replace(':{"', ':{\n"').replace('],"', '],\n"')
    with open(out, "w") as f:
        f.write(text + "\n")
    print(json.dumps(table))


if __name__ == "__main__":
    main()
