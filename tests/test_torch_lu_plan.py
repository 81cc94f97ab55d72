"""The launch plans of the port's ``lu_panel`` and ``lu_gesv`` kernels, on
the CPU.

``lu_panel``'s plan chooses a cluster size and where a block's rows live
(shared or global memory) from the clusters the card holds at once; here
it is given the ones an H100 reported (``h100_lu_resident.json``, written
by ``tools/lu_resident.py``), so the rule under test is the one the card
runs. ``lu_gesv``'s plan chooses its layout (registers, shared or global
memory) from the shape and type alone. Every launch must fit one Hopper
block (at most 232448 bytes of shared memory) and count the bytes of the
kernel's own layout; the kernel's constants and byte formulas are read
from ``csrc/lu_panel.cu``. Pure Python, no JAX; about a second.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import lu_panel as lp

SRC = (Path(lp.__file__).resolve().parent.parent / "csrc" / "lu_panel.cu") \
    .read_text()
DTYPES = [torch.float32, torch.float64]
# clusters held at once, for each placement, by dtype and "m b", as an
# NVIDIA H100 80GB HBM3 reported them
H100 = json.loads((Path(__file__).parent / "h100_lu_resident.json")
                  .read_text())
# (Nb, M, B) of every lu_panel launch of the main path (the 512² lu_decomp's
# four panels), chip_smoke.py and the card tests
PANELS = [(32, 512, 128), (32, 384, 128), (32, 256, 128), (32, 128, 128),
          (2, 512, 128), (2, 384, 128), (3, 136, 40), (2, 16, 16)]
# (Nb, N, K, dtype, layout) of every lu_gesv launch of the main path
# (config 2), chip_smoke.py and the card tests, and empty batches
GESV = [(1024, 128, 1, torch.float32, "registers"),
        (1024, 128, 1, torch.float64, "shared"),
        (64, 128, 4, torch.float32, "registers"),
        (64, 128, 4, torch.float64, "shared"),
        (2, 128, 4, torch.float32, "registers"),
        (4, 128, 1, torch.float64, "shared"),
        (1, 128, 160, torch.float32, "shared"),
        (1, 128, 160, torch.float64, "global"),
        (3, 13, 3, torch.float32, "registers"),
        (3, 13, 3, torch.float64, "shared"),
        (1, 8, 1, torch.float32, "registers"),
        (1, 4, 1, torch.float64, "shared"),
        (0, 128, 1, torch.float32, "registers"),
        (0, 128, 1, torch.float64, "shared")]


def _name(dtype):
    return str(dtype).removeprefix("torch.")


def _res(m, b, dtype):
    return tuple(((c, bool(sh)), k) for c, sh, k in
                 H100[_name(dtype)][f"{m} {b}"])


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", SRC).group(1))


def _up(x, d):
    return -(-x // d)


def test_plans_match_the_kernel_source():
    assert lp.MAX_THREADS == _constant("kMaxThreads") == 512
    assert lp.CLUSTER_SIZES == tuple(range(1, _constant("kMaxCluster") + 1))
    assert (lp.REG_WARPS, lp.REG_ROWS, lp.REG_COLS) == (
        _constant("kRegWarps"), _constant("kRegRows"), _constant("kRegCols"))
    assert _build.SMEM_MAX == _constant("kSmemMax") == 232448
    # the byte counts the plans mirror, as the source states them
    assert ("  const size_t lists = (rmax + nw - 1) / nw * nw;\n  return "
            "(shared ? align16(elem * rmax * (size_t)(ncols | 1)) : 0) +\n"
            "         align16(elem * (2 * ncand + lists)) +\n         "
            "sizeof(int) * (2 * ncand + lists + (shared ? rmax + (size_t)m : "
            "0) +\n                        (solve ? (size_t)steps : 0));") \
        in SRC
    assert ("return sizeof(float) * ((area + 3) / 4 * 4 + (size_t)n * k + 3 * "
            "32 * kRegRows) +\n         sizeof(int) * 2;") in SRC


@pytest.mark.parametrize("m,ncols,steps,cs,warps,shared,solve", [
    (512, 128, 128, 3, 16, True, False), (128, 128, 128, 1, 16, True, False),
    (512, 128, 128, 16, 4, False, False), (136, 40, 40, 4, 5, True, False),
    (128, 129, 128, 1, 16, True, True), (128, 288, 128, 1, 16, False, True),
    (13, 16, 13, 1, 2, True, True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_smem_bytes_counts_the_layout(m, ncols, steps, cs, warps, shared,
                                      solve, dtype):
    elem = torch.finfo(dtype).bits // 8
    rows = _up(m, cs)
    lists = _up(rows, warps) * warps
    want = (_up(elem * rows * (ncols | 1), 16) * 16 if shared else 0) \
        + _up(elem * (2 * cs * warps + lists), 16) * 16 \
        + 4 * (2 * cs * warps + lists + (rows + m if shared else 0)
               + (steps if solve else 0))
    assert lp.smem_bytes(m, ncols, steps, cs, warps, shared, solve,
                         dtype) == want


@pytest.mark.parametrize("n,k", [(128, 1), (128, 4), (13, 3), (100, 32),
                                 (1, 1), (0, 1)])
def test_gesv_regs_bytes_counts_the_layout(n, k):
    area = max(n * (n + 1) // 2, 32 * ((n + k) | 1))
    assert lp.gesv_regs_bytes(n, k) == \
        4 * (_up(area, 4) * 4 + n * k + 3 * 128) + 4 * 2


@pytest.mark.parametrize("m,b", sorted({(m, b) for _, m, b in PANELS}))
@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_table_covers_every_placement(m, b, dtype):
    assert [p for p, _ in _res(m, b, dtype)] == lp.placements(m, b, dtype)


@pytest.mark.parametrize("shape", PANELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_plan_fits_a_block_and_takes_the_fewest_waves(shape, dtype):
    nb, m, b = shape
    res = _res(m, b, dtype)
    cluster, threads, shared, smem = lp.plan(nb, m, b, dtype, resident=res)
    rows = _up(m, cluster)
    assert smem == lp.smem_bytes(m, b, b, cluster, threads // 32,
                                 bool(shared), False, dtype) \
        <= _build.SMEM_MAX
    assert threads % 32 == 0 and 32 <= threads <= lp.MAX_THREADS
    assert threads // 32 == min(16, _up(rows, lp.ROWS_PER_WARP))
    assert cluster == 1 or rows >= lp.MIN_ROWS
    # rows in shared memory wherever a cluster the card holds places
    # them, then the fewest waves, then the smallest cluster whose blocks
    # hold at most MAX_ROWS rows (the largest if none does)
    holds = {p: k for p, k in res if k}
    assert bool(shared) == any(sh for _, sh in holds)
    mine = {c: k for (c, sh), k in holds.items() if sh == bool(shared)}
    waves = _up(nb, mine[cluster])
    assert waves == min(_up(nb, k) for k in mine.values())
    tied = [c for c, k in mine.items() if _up(nb, k) == waves]
    short = [c for c in tied if _up(m, c) <= lp.MAX_ROWS]
    assert cluster == (min(short) if short else max(tied))


def test_panel_main_path_plans():
    """lu_decomp's four float32 panels of the 512² batch: rows in shared
    memory, in one wave, on clusters of 3, 3 and 2 blocks and one block."""
    got = []
    for m in (512, 384, 256, 128):
        res = _res(m, 128, torch.float32)
        cluster, threads, shared, _ = lp.plan(32, m, 128, torch.float32,
                                              resident=res)
        assert shared == 1 and dict(res)[cluster, True] >= 32
        got.append((cluster, threads))
    assert got == [(3, 512), (3, 512), (2, 512), (1, 512)]


@pytest.mark.parametrize("m,b", [(512, 128), (136, 40), (16, 16), (40, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_placements(m, b, dtype):
    """Every cluster size whose blocks hold MIN_ROWS rows, in global memory
    always and in shared memory where 227 KB holds the slab."""
    places = lp.placements(m, b, dtype)
    sizes = sorted({c for c, _ in places})
    assert sizes == list(range(1, max(1, m // lp.MIN_ROWS) + 1))
    for c in sizes:
        assert (c, False) in places
        fits = lp.smem_bytes(m, b, b, c, lp.warps_for(_up(m, c)), True,
                             False, dtype) <= _build.SMEM_MAX
        assert ((c, True) in places) == fits
        launch = lp.launch_on(m, b, dtype, c, False)
        assert launch[:3] == (c, 32 * lp.warps_for(_up(m, c)), 0)


def test_panel_plan_refusals():
    with pytest.raises(ValueError):
        lp.plan(1, 4, 6, torch.float32)
    with pytest.raises(ValueError):
        lp.launch_on(512, 128, torch.float32, 17, False)
    with pytest.raises(ValueError):
        lp.launch_on(512, 128, torch.float64, 2, True)
    # a card that holds none of the launches
    none = tuple((p, 0) for p in lp.placements(512, 128, torch.float32))
    with pytest.raises(ValueError):
        lp.plan(32, 512, 128, torch.float32, resident=none)
    with pytest.raises(ValueError):
        lp.plan(32, 512, 128, torch.float32)


def test_empty_panel_batch_has_a_plan():
    """The wrapper launches nothing for an empty batch; the plan still
    places the shape."""
    res = _res(512, 128, torch.float32)
    assert lp.plan(0, 512, 128, torch.float32, resident=res)[2] == 1


@pytest.mark.parametrize("nb,n,k,dtype,layout", GESV)
def test_gesv_plan(nb, n, k, dtype, layout):
    """Registers for float32 systems of N ≤ 128, N + K ≤ 136 (eight warps);
    else one elimination block a system, [A | y] in shared memory where
    227 KB holds it and in global memory otherwise."""
    the_plan = lp.gesv_plan(nb, n, k, dtype)
    assert lp.LAYOUTS[the_plan[0]] == layout
    assert the_plan == lp.gesv_layouts(n, k, dtype)[0]
    code, threads, smem = the_plan
    assert smem <= _build.SMEM_MAX
    if layout == "registers":
        assert (threads, smem) == (256, lp.gesv_regs_bytes(n, k))
    else:
        warps = lp.warps_for(n)
        assert threads == 32 * warps
        assert smem == lp.smem_bytes(n, n + k, n, 1, warps, code == 1, True,
                                     dtype)


@pytest.mark.parametrize("n,k", [(128, 1), (128, 4), (128, 8), (128, 9),
                                 (129, 1), (128, 160), (13, 3), (300, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gesv_layouts_are_every_launch_that_takes_the_shape(n, k, dtype):
    layouts = [lp.LAYOUTS[code] for code, _, _ in lp.gesv_layouts(n, k, dtype)]
    regs = dtype == torch.float32 and n <= 128 and n + k <= 136
    shared = lp.smem_bytes(n, n + k, n, 1, lp.warps_for(n), True, True,
                           dtype) <= _build.SMEM_MAX
    assert layouts == (["registers"] * regs + ["shared"] * shared
                       + ["global"])


def test_gesv_plan_refusals():
    with pytest.raises(ValueError):
        lp.gesv_plan(1, -1, 1, torch.float32)
