#!/usr/bin/env python3
"""Record, on a card, how many clusters of each size ``sytrd_panel``'s
column loop the card holds at once, for every panel of the main path:
config 4's sixteen of a 1024² ``eigh`` and the Gram batch's eight of a
(32, 512, 512) ``eigh_tridiag_dc``, in float32 and float64.

    python3 tools/sytrd_resident.py [OUT]

It builds only ``csrc/sytrd_panel.cu`` and asks
cudaOccupancyMaxActiveClusters (``ops.sytrd_panel.resident_clusters``)
for each placeable cluster size in each panel's launch. It writes a JSON
object (default ``tests/h100_sytrd_resident.json``): the card's name and
power limit, and for each dtype a map "m bk" → [[cluster, clusters held],
...], which ``tests/test_torch_sytrd_plan.py`` hands to ``plan`` on the
CPU, so that the CPU tests run the rule the card runs on the card's
numbers.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PANELS = sorted({(1024 - k, min(64, 1023 - k)) for k in range(0, 1023, 64)}
                | {(512 - k, min(64, 511 - k)) for k in range(0, 511, 64)},
                reverse=True)


def main():
    import torch

    from nd4js_tpu_torch.ops import _build
    from nd4js_tpu_torch.ops import sytrd_panel as sp

    if not torch.cuda.is_available():
        raise SystemExit("sytrd_resident: needs a CUDA card")
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "h100_sytrd_resident.json")
    _build._sources = lambda: [_build._CSRC / "sytrd_panel.cu"]
    lib = ctypes.CDLL(str(_build.build()[0]))
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if hasattr(lib, k)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    table = {"card": card}
    for dtype in (torch.float32, torch.float64):
        table[str(dtype).removeprefix("torch.")] = {
            f"{m} {bk}": [list(p) for p in sp._resident_on(m, bk, dtype, 0)]
            for m, bk in PANELS}
    # one line a panel
    text = json.dumps(table, separators=(",", ":"))
    text = text.replace(':{"', ':{\n"').replace('],"', '],\n"')
    with open(out, "w") as f:
        f.write(text + "\n")
    print(json.dumps(table))


if __name__ == "__main__":
    main()
