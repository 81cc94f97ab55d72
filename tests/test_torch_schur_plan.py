"""The launch layouts (``plan``) of the port's ``bulge_chase_steps`` and
``schur_small`` kernels, on the CPU: the main path's shapes and the edges.

Every layout must fit one Hopper block (at most 232448 bytes of shared
memory, at most the kernel's warps), keep B/V_acc and T/Q at an odd
leading dimension (a column of 32 rows then hits 32 banks), give each
group enough threads for its bulges, columns and rows, and count the
bytes the kernel's layout takes. Shapes the kernels cannot take are
refused with ValueError. The kernels' own constants are read from their
sources, so the plans cannot drift from them.
"""
import re
from pathlib import Path

import pytest
import torch

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import bulge_chase as bc
from nd4js_tpu_torch.ops import schur_small as ss

CSRC = Path(bc.__file__).resolve().parent.parent / "csrc"
DTYPES = [torch.float32, torch.float64]


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def _elem(dtype):
    return torch.finfo(dtype).bits // 8


def test_plans_match_the_kernel_sources():
    assert _build.SMEM_MAX == _constant("bulge_chase.cu", "kSmemMax") \
        == _constant("schur_small.cu", "kSmemMax") == 232448
    assert 32 * bc.MAX_WARPS == _constant("bulge_chase.cu", "kMaxThreads")
    assert ss.MAX_W == _constant("schur_small.cu", "kMaxW")
    assert ss.MAX_WARPS == ss.MAX_W // 32


# (W, NB, SL): config 4's multishift slide, the classic chase, the small
# windows of the card tests, NB = 16 at W = 64, and one step
CHASE_SHAPES = [(128, 16, 80), (128, 1, 125), (100, 16, 52), (64, 16, 16),
                (64, 4, 52), (32, 4, 20), (32, 1, 29), (8, 1, 5), (4, 1, 1),
                (128, 42, 2), (128, 16, 0)]


@pytest.mark.parametrize("W,NB,SL", CHASE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chase_plan_fits_one_block(W, NB, SL, dtype):
    ld, nref, nupd, nacc, v_in_smem, smem = bc.plan(W, NB, SL, dtype)
    assert ld % 2 == 1 and W <= ld <= W + 1
    assert 32 * nref >= NB and 32 * nupd >= W and 32 * nacc >= W
    assert nupd <= max(bc.MAX_UPDATE, -(-W // 32))
    assert nref + nupd + nacc <= bc.MAX_WARPS
    e = _elem(dtype)
    assert smem == e * (W * ld * (2 if v_in_smem else 1) + SL * NB * 4) + 16
    assert smem <= 232448
    # V_acc leaves shared memory only when it does not fit beside B
    if not v_in_smem:
        assert smem + e * W * ld > 232448


def test_chase_plan_main_path():
    """Config 4's slide: 16 update warps (4 items a thread), V_acc beside B
    in float32 (152592 bytes), in global memory in float64 (B and the log
    alone take 173072)."""
    assert bc.plan(128, 16, 80, torch.float32) == (129, 1, 16, 4, True,
                                                   152592)
    assert bc.plan(128, 16, 80, torch.float64) == (129, 1, 16, 4, False,
                                                   173072)


@pytest.mark.parametrize("W,NB,SL", [(3, 1, 0), (128, 0, 80), (128, 16, -1),
                                     (128, 16, 81), (32, 11, 0),
                                     (300, 1, 10)])
def test_chase_plan_refuses_what_the_kernel_cannot_take(W, NB, SL):
    """sl + 3·NB > W, W < 4, no bulge, a negative slide, and a block whose
    B alone exceeds 227 KB (the most warps a plan asks for, 3 reflector +
    8 update + 8 accumulator at W = 240, stays within MAX_WARPS)."""
    with pytest.raises(ValueError):
        bc.plan(W, NB, SL, torch.float32)


def test_chase_plan_refuses_b_and_log_over_227kb_in_float64():
    bc.plan(168, 1, 10, torch.float64)
    with pytest.raises(ValueError):
        bc.plan(170, 1, 10, torch.float64)


@pytest.mark.parametrize("NB,SL,nref,nupd", [(26, 20, 1, 15), (70, 2, 3, 13)])
def test_chase_plan_shrinks_update_warps_to_the_kernel(NB, SL, nref, nupd):
    """W = 236 in float32 (B and the log still fit 227 KB) needs 8 warps for
    its rows of V_acc and at least 8 for its columns; the update warps take
    what MAX_WARPS leaves beside the reflector warps."""
    assert bc.plan(236, NB, SL, torch.float32)[1:4] == (nref, nupd, 8)
    assert nref + nupd + 8 == bc.MAX_WARPS


@pytest.mark.parametrize("W", [1, 2, 8, 31, 32, 33, 48, 64, 100, 127, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_schur_plan_fits_one_block(W, dtype):
    ld, nwarps, q_in_smem, smem = ss.plan(W, dtype)
    assert ld % 2 == 1 and W <= ld <= W + 1
    assert 32 * nwarps >= W > 32 * (nwarps - 1) and nwarps <= ss.MAX_WARPS
    e = _elem(dtype)
    core = e * (W * ld + W + ss.MAX_WARPS + 8) + 4 * ss.MAX_WARPS
    assert smem == core + (e * W * ld if q_in_smem else 0) <= 232448
    assert q_in_smem == (core + e * W * ld <= 232448)


def test_schur_plan_main_path():
    """The AED window, the whole-matrix batch's 64² and small_win's 128²
    in float32 keep Q in shared memory; float64 at 128 moves it out."""
    assert ss.plan(48, torch.float32) == (49, 2, True, 19072)
    assert ss.plan(64, torch.float32) == (65, 2, True, 33600)
    assert ss.plan(128, torch.float32) == (129, 4, True, 132672)
    assert ss.plan(128, torch.float64) == (129, 4, False, 133232)
    assert ss.plan(8, torch.float64) == (9, 1, True, 1328)


@pytest.mark.parametrize("W", [0, -1, 129, 256])
def test_schur_plan_refuses_widths_outside_the_kernel(W):
    with pytest.raises(ValueError):
        ss.plan(W, torch.float32)


def test_schur_small_refuses_129_before_any_launch():
    with pytest.raises(ValueError):
        ss.schur_small(torch.zeros((1, 129, 129)))
