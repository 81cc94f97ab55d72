"""The launch plan (``plan``) of the port's ``sytrd_panel`` kernel, on the
CPU: config 4's sixteen panels of a 1024² eigh and the Gram batch's eight
of a (32, 512, 512) eigh_tridiag_dc, in float32 and float64, and the
shapes the kernel cannot take.

``plan`` chooses a cluster size from the clusters the card holds at once;
here it is given the ones an H100 reported for each of those panels
(``h100_sytrd_resident.json``, written by ``tools/sytrd_resident.py``), so
the rule under test is the one the card runs. Every launch must fit one
Hopper block (at most 232448 bytes of shared memory), count the bytes of
the kernel's own layout, cover the m rows with its blocks' slabs exactly
once, run in one wave where any placeable cluster does, and take the
largest such cluster. The kernel's constants and its shared-memory layout
are read from ``csrc/sytrd_panel.cu``, so the plan cannot drift from them.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import sytrd_panel as sp

CSRC = Path(sp.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "sytrd_panel.cu").read_text()
DTYPES = [torch.float32, torch.float64]
# config 4's panels of one 1024² matrix, the Gram batch's of 32 of 512²
CONFIG4 = [(1, 1024 - k, min(64, 1023 - k)) for k in range(0, 1023, 64)]
GRAM = [(32, 512 - k, min(64, 511 - k)) for k in range(0, 511, 64)]
# (cluster size, clusters held at once) for each placeable size, by dtype
# and panel "m bk", as an NVIDIA H100 80GB HBM3 reported them
H100 = json.loads((Path(__file__).parent / "h100_sytrd_resident.json")
                  .read_text())


def _resident(m, bk, dtype):
    return tuple(map(tuple, H100[str(dtype).removeprefix("torch.")]
                     [f"{m} {bk}"]))


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", SOURCE).group(1))


def _layout_elements(m, bk, rows, ncs, csize):
    """The total of ``layout()`` in the .cu source, evaluated term by term
    from its ``o += ...;`` lines."""
    body = SOURCE[SOURCE.index("inline Layout layout("):]
    body = body[:body.index("L.total = o;")]
    env = {"m": m, "bk": bk, "rows": rows, "ncs": ncs, "csize": csize,
           "ldr": rows | 1, "kRed": _constant("kRed")}
    terms = re.findall(r"o \+= ([^;]+);", body)
    assert len(terms) == 16
    return sum(eval(t.replace("(size_t)", "").replace("L.", ""), {}, env)
               for t in terms)


def _elem(dtype):
    return torch.finfo(dtype).bits // 8


def test_plan_matches_the_kernel_source():
    assert sp.MAX_BK == _constant("kMaxBk") == 64
    assert sp.MAX_THREADS == _constant("kMaxThreads")
    assert sp.CLUSTER_SIZES[-1] == _constant("kMaxCluster") == 16
    assert sp.RED == _constant("kRed")
    assert _build.SMEM_MAX == _constant("kSmemMax") == 232448


@pytest.mark.parametrize("m,bk,rows,ncs,csize", [
    (1024, 64, 64, 716, 16), (512, 64, 128, 308, 4), (100, 63, 25, 100, 4),
    (3, 2, 3, 3, 1), (97, 9, 13, 40, 8)])
def test_smem_elements_is_the_kernel_layout(m, bk, rows, ncs, csize):
    assert sp.smem_elements(m, bk, rows, ncs, csize) \
        == _layout_elements(m, bk, rows, ncs, csize)


@pytest.mark.parametrize("nb,m,bk", CONFIG4 + GRAM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_places_every_main_path_panel(nb, m, bk, dtype):
    resident = _resident(m, bk, dtype)
    cluster, threads, rows, ncs, smem = sp.plan(nb, m, bk, dtype, resident)
    e = _elem(dtype)
    assert smem == e * _layout_elements(m, bk, rows, ncs, cluster)
    assert smem <= 232448
    # the columns C leaves in L2 are there because shared memory is full
    assert ncs == m or smem + e * rows * (16 // e) > 232448
    assert 0 <= ncs <= m and ncs % (16 // e) in (0, m % (16 // e))
    # the blocks' slabs cover the m rows exactly once
    slabs = [range(b * rows, min(m, (b + 1) * rows)) for b in range(cluster)]
    assert sorted(i for s in slabs for i in s) == list(range(m))
    assert all(len(s) > 0 for s in slabs)
    # one wave, the largest placeable cluster that keeps it
    holds = dict(resident)
    assert sorted(holds) == sp.placeable_sizes(m, bk, dtype)
    assert nb <= holds[cluster]
    bigger = [c for c in holds if c > cluster]
    assert all(nb > holds[c] or -(-m // c) < sp.MIN_ROWS for c in bigger)
    assert threads % 32 == 0 and 128 <= threads <= sp.MAX_THREADS
    assert 2 * threads // 32 >= rows or threads == sp.MAX_THREADS


def test_plan_main_path():
    """Config 4's first panel on a cluster of 16 (64 rows a block, 716 of
    its 1024 columns in shared memory); the Gram batch's on 32 clusters of
    3, as the H100 holds only 30 clusters of 4 at once (its SMs come in
    groups that a cluster may not span); config 3's 8 matrices on clusters
    of 16."""
    gram = _resident(512, 64, torch.float32)
    assert dict(gram)[4] == 30 and dict(gram)[3] >= 32
    assert sp.plan(1, 1024, 64, torch.float32,
                   _resident(1024, 64, torch.float32)) \
        == (16, 1024, 64, 716, 231944)
    assert sp.plan(32, 512, 64, torch.float32, gram)[0] == 3
    assert sp.plan(8, 512, 64, torch.float32, gram)[0] == 16
    # a float64 slab is twice as large: more of it from L2
    f32, f64 = (sp.plan(1, 1024, 64, d, _resident(1024, 64, d))
                for d in DTYPES)
    assert f64[0] == 16 and f64[3] < f32[3] / 2


def test_plan_when_no_cluster_keeps_one_wave():
    """More matrices than the card holds clusters of any size: the
    smallest placeable cluster, in several waves."""
    resident = _resident(1024, 64, torch.float32)
    assert sp.plan(1000, 1024, 64, torch.float32, resident)[0] == 3


def test_forced_cluster_sizes():
    """Every placeable size can be asked for; below 3 blocks (6 in
    float64) m = 1024 does not place, its rows of V and W too large for
    one block. A slab of more rows than 1024 threads on one block a
    matrix."""
    assert sp.placeable_sizes(1024, 64, torch.float32) == list(range(3, 17))
    assert sp.placeable_sizes(1024, 64, torch.float64) == list(range(6, 17))
    for c in range(3, 17):
        assert sp.launch_on(1024, 64, torch.float32, c)[0] == c
    with pytest.raises(ValueError, match="does not place"):
        sp.launch_on(1024, 64, torch.float32, 2)
    assert sp.launch_on(1100, 16, torch.float32, 1)[1:3] == (1024, 1100)


@pytest.mark.parametrize("m,bk,dtype,match", [
    (200, 65, torch.float32, "bk"), (10, 10, torch.float32, "bk"),
    (10, 0, torch.float32, "bk"), (8192, 64, torch.float64, "holds"),
    (16384, 64, torch.float32, "holds")])
def test_plan_refuses_what_the_kernel_cannot_take(m, bk, dtype, match):
    """bk above 64 or above m − 1, and an m whose rows of V and W do not
    fit a block even on a cluster of 16."""
    with pytest.raises(ValueError, match=match):
        sp.plan(1, m, bk, dtype, ((16, 1),))
    with pytest.raises(ValueError, match=match):
        sp.launch_on(m, bk, dtype, 16)
