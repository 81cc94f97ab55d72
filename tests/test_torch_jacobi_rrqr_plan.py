"""The launch plans of the port's ``jacobi_sweeps`` and ``rrqr_kernel``
kernels, and the seat ring of the Jacobi kernel, on the CPU.

Each plan chooses a cluster size (one block a matrix where it fits) from
the clusters the card holds at once; here it is given the ones an H100
reported (``h100_jacobi_rrqr_resident.json``, written by
``tools/jacobi_rrqr_resident.py``), so the rule under test is the one the
card runs. Every launch must fit one Hopper block (at most 232448 bytes of
shared memory), count the bytes of the kernel's own layout, and run in the
fewest waves any placement gives. The kernels' constants and layout
formulas are read from ``csrc/jacobi_sweep.cu`` and ``csrc/rrqr.cu``.

The Jacobi kernel keeps each matrix's columns in circular buffers of slots
(one run of seats a buffer), moves a run's last column into the next run's
spare slot, on a peer block, and shifts by an offset. ``_Ring`` below
transcribes that integer logic (``ring_of``, ``seat_loc``, ``seat_state``,
``step_back`` and the destination slot of a pushed column) and plays it
through whole sweeps: every round must pair the
columns of the Brent-Luk tournament in their roles, a pushed column must
land in a slot nobody reads that round, and every column must be back at
its seat after each sweep. No JAX; about 2 s.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import jacobi_sweep as js
from nd4js_tpu_torch.ops import rrqr_kernel as rk

CSRC = Path(js.__file__).resolve().parent.parent / "csrc"
JSRC = (CSRC / "jacobi_sweep.cu").read_text()
RSRC = (CSRC / "rrqr.cu").read_text()
DTYPES = [torch.float32, torch.float64]
# clusters held at once, for each placement, by kernel, dtype and "m n", as
# an NVIDIA H100 80GB HBM3 reported them
H100 = json.loads((Path(__file__).parent / "h100_jacobi_rrqr_resident.json")
                  .read_text())


def _name(dtype):
    return str(dtype).removeprefix("torch.")


def _jres(m, n, dtype):
    return tuple(((c, bool(vg)), k) for c, vg, k in
                 H100["jacobi"][_name(dtype)][f"{m} {n}"])


def _rres(m, n, dtype):
    return tuple((c, k) for c, k in H100["rrqr"][_name(dtype)][f"{m} {n}"])


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))


# ------------------------------------------------------------- the ring


class _Ring:
    """``ring_of(b, cs, h)`` of the .cu: rank b's seats lo..hi−1, its runs
    (base, len, mod), the fixed slot of top seat 0, its slot count, and
    where each run's last seat goes (rank, run)."""

    def __init__(self, b, cs, h):
        self.lo, self.hi = b * h // cs, (b + 1) * h // cs
        s = self.hi - self.lo
        self.fixed, self.dst = -1, [None, None]
        if cs == 1:
            self.seg = [(0, 2 * h - 1, 2 * h - 1)]
            self.fixed, self.nslots = 2 * h - 1, 2 * h
            return
        self.seg = [_first_seg(b, cs, h)]
        if b == 0:
            self.fixed, self.nslots = 2 * s, 2 * s + 1
            self.dst[0] = (1, _first_seg(1, cs, h))
        elif b == cs - 1:
            self.nslots = 2 * s + 1
            self.dst[0] = (cs - 2, _bottom_seg(cs - 2, cs, h))
        else:
            self.seg.append((s + 1, s, s + 1))
            self.nslots = 2 * s + 2
            self.dst = [(b + 1, _first_seg(b + 1, cs, h)),
                        (b - 1, _bottom_seg(b - 1, cs, h))]

    def seat_loc(self, cs, h, t, bottom):
        s = self.hi - self.lo
        if not bottom and t == 0:
            return -1, 0
        if cs == 1:
            return 0, (2 * h - 2 - t if bottom else t - 1)
        if self.lo == 0:
            return 0, (s - 1 - t if bottom else s - 1 + t)
        if self.hi == h:
            return 0, (s + (self.hi - 1 - t) if bottom else t - self.lo)
        return (1, self.hi - 1 - t) if bottom else (0, t - self.lo)

    def seat_state(self, cs, h, t, bottom):
        """[slot, base, mod, rank] at shift 0, and the run: rank ≥ 0 for a
        run's last seat on a cluster, whose column moves on to that peer."""
        sg, ps = self.seat_loc(cs, h, t, bottom)
        if sg < 0:
            return [self.fixed, self.fixed, 1, -1], 0
        base, ln, mod = self.seg[sg]
        rank = self.dst[sg][0] if cs > 1 and ps == ln - 1 else -1
        return [base + ps, base, mod, rank], sg

    def destination(self, run, rt):
        """The peer's slot that takes run ``run``'s last column in round
        ``rt``: its run's position 0 after the shift."""
        _, (dbase, _, dmod) = self.dst[run]
        return dbase + dmod - 1 - rt % dmod


def _first_seg(b, cs, h):
    s = (b + 1) * h // cs - b * h // cs
    if b == 0:
        return (0, 2 * s - 1, 2 * s)
    if b == cs - 1:
        return (0, 2 * s, 2 * s + 1)
    return (0, s, s + 1)


def _bottom_seg(b, cs, h):
    if b == 0:
        return _first_seg(0, cs, h)
    s = (b + 1) * h // cs - b * h // cs
    return (s + 1, s, s + 1)


def _step_back(slot, base, mod):
    return slot + mod - 1 if slot == base else slot - 1


def _tournament(n, rounds):
    """The (p, q) column pairs of each round (``jacobi_sweeps_ref``'s
    shuffle on column indices)."""
    h = n // 2
    top, bot = list(range(h)), list(range(h, n))
    out = []
    for _ in range(rounds):
        out.append(list(zip(top, bot)))
        if h > 1:
            top, bot = [top[0], bot[0]] + top[1:h - 1], bot[1:] + [top[h - 1]]
    return out


def _play(n, cs, sweeps):
    """Play the kernel's slots through ``sweeps`` sweeps; check each round's
    pairs, the pushes' targets and the columns' return."""
    h = n // 2
    rings = [_Ring(b, cs, h) for b in range(cs)]
    mem = [[None] * max(r.nslots for r in rings) for _ in range(cs)]
    state = {}
    for b, r in enumerate(rings):
        for t in range(r.lo, r.hi):
            for bottom in (False, True):
                st, run = r.seat_state(cs, h, t, bottom)
                assert mem[b][st[0]] is None
                mem[b][st[0]] = h + t if bottom else t
                state[b, t, bottom] = st, run
    want = _tournament(n, (n - 1) * sweeps)
    for rt in range((n - 1) * sweeps):
        pairs = {}
        read = {(b, st[0]) for (b, _, _), (st, _) in state.items()}
        for b, r in enumerate(rings):
            for t in range(r.lo, r.hi):
                pairs[t] = (mem[b][state[b, t, False][0][0]],
                            mem[b][state[b, t, True][0][0]])
        assert [pairs[t] for t in range(h)] == want[rt], (n, cs, rt)
        new = [row[:] for row in mem]
        for (b, _, _), (st, run) in state.items():
            if st[3] >= 0:
                dst = (st[3], rings[b].destination(run, rt))
                assert dst not in read, (n, cs, rt)
                new[dst[0]][dst[1]] = mem[b][st[0]]
        mem = new
        for st, _ in state.values():
            st[0] = _step_back(st[0], st[1], st[2])
        if (rt + 1) % (n - 1) == 0:
            for (b, t, bottom), (st, _) in state.items():
                assert mem[b][st[0]] == (h + t if bottom else t)


RING_CASES = [(2, 1), (4, 1), (4, 2), (6, 3), (16, 1), (16, 4), (16, 8),
              (22, 5), (64, 1), (64, 16), (100, 7), (128, 16), (512, 9),
              (512, 16)]


@pytest.mark.parametrize("n,cs", RING_CASES)
def test_ring_plays_the_tournament(n, cs):
    _play(n, cs, 1 if n > 200 else 2)


@pytest.mark.parametrize("n,cs", RING_CASES)
def test_slots_is_the_ring_layout(n, cs):
    h = n // 2
    assert js.slots(cs, h) == max(_Ring(b, cs, h).nslots for b in range(cs))


# ------------------------------------------------------- the kernel sources


def test_plans_match_the_kernel_sources():
    assert js.MAX_THREADS == _constant(JSRC, "kMaxThreads")
    assert js.ENTRIES == _constant(JSRC, "kEntries")
    assert js.ALIGN == _constant(JSRC, "kAlign")
    assert js.RED == _constant(JSRC, "kRed")
    assert js.PASSES == _constant(JSRC, "kPasses")
    assert js.CLUSTER_SIZES[-1] == _constant(JSRC, "kMaxCluster") == 16
    assert rk.MAX_THREADS == _constant(RSRC, "kMaxThreads")
    assert rk.ALIGN == _constant(RSRC, "kAlign")
    assert rk.RED == _constant(RSRC, "kRed")
    assert rk.CLUSTER_SIZES[-1] == _constant(RSRC, "kMaxCluster") == 16
    assert _build.SMEM_MAX == _constant(JSRC, "kSmemMax") \
        == _constant(RSRC, "kSmemMax") == 232448
    # the byte counts the plans mirror, as the sources state them
    assert ("const size_t stride = (size_t)round_up(m) + (vglobal ? 0 : "
            "(size_t)round_up(n));") in JSRC
    assert ("return elem * (nslots * stride + nslots + kRed + kMaxCluster) "
            "+ sizeof(int) * nslots;") in JSRC
    assert ("return elem * ((size_t)ncs * ldm + ldm + 1 + ncmax + kMaxCluster"
            " + 2 * kRed) +\n         sizeof(int) * (2 * (size_t)n + kMaxCluster"
            " + kRed + 3 * ncmax + 2);") in RSRC


@pytest.mark.parametrize("m,n,cs,vg", [(64, 64, 1, False), (512, 512, 16, False),
                                       (512, 512, 9, True), (96, 64, 1, True),
                                       (100, 30, 3, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_smem_bytes_counts_the_layout(m, n, cs, vg, dtype):
    elem = torch.finfo(dtype).bits // 8
    up = lambda x: -(-x // 32) * 32  # noqa: E731
    nsl = max(_Ring(b, cs, n // 2).nslots for b in range(cs))
    stride = up(m) + (0 if vg else up(n))
    assert js.smem_bytes(m, n, cs, vg, dtype) == \
        elem * (nsl * stride + nsl + 32 + 16) + 4 * nsl


@pytest.mark.parametrize("m,n,cs,ncs", [(128, 128, 1, 128), (512, 512, 3, 109),
                                        (300, 260, 8, 33), (24, 16, 1, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rrqr_smem_bytes_counts_the_layout(m, n, cs, ncs, dtype):
    elem = torch.finfo(dtype).bits // 8
    ldm = -(-m // 4) * 4
    assert rk.smem_bytes(m, n, cs, ncs, dtype) == \
        elem * (ncs * ldm + ldm + 1 + -(-n // cs) + 16 + 64) \
        + 4 * (2 * n + 16 + 32 + 3 * -(-n // cs) + 2)


# ---------------------------------------------------------- jacobi's plan

# (Nb, M, n) of every jacobi_sweeps launch the main path and the card tests
# make: lstsq's Rᵀ, config 3's, and the card tests' shapes
JACOBI = [(1024, 64, 64), (8, 512, 512), (5, 16, 16), (3, 96, 64),
          (2, 128, 128), (2, 256, 256), (8, 128, 128), (2, 512, 512)]


def _jplan(nb, m, n, dtype):
    if js.small_regime(m, n, dtype):
        return js.plan(nb, m, n, dtype)
    return js.plan(nb, m, n, dtype, resident=_jres(m, n, dtype))


@pytest.mark.parametrize("shape", JACOBI)
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_plan_fits_a_block_and_takes_the_fewest_waves(shape, dtype):
    nb, m, n = shape
    cluster, vglobal, threads, lanes, smem = _jplan(nb, m, n, dtype)
    assert smem == js.smem_bytes(m, n, cluster, vglobal, dtype) \
        <= _build.SMEM_MAX
    assert threads % 32 == 0 and threads % lanes == 0
    assert threads <= js.MAX_THREADS
    pairs = -(-(n // 2) // cluster)
    assert pairs <= js.PASSES * (threads // lanes)
    if js.small_regime(m, n, dtype):
        assert (cluster, vglobal) == (1, False)
        return
    holds = dict(_jres(m, n, dtype))
    # V in shared memory wherever a cluster holds it, then the fewest
    # waves, then the largest cluster
    assert vglobal == all(vg for (_, vg), k in holds.items() if k)
    mine = {p: k for p, k in holds.items() if k and p[1] == vglobal}
    waves = -(-nb // holds[cluster, vglobal])
    assert waves == min(-(-nb // k) for k in mine.values())
    assert cluster == max(c for (c, _), k in mine.items()
                          if -(-nb // k) == waves)


def test_jacobi_main_path_plans():
    """lstsq's (1024, 64, 64): one block of 128 threads a matrix, four lanes
    a pair; config 3's (8, 512, 512): clusters of 16, W and V in shared
    memory, a warp a pair, in two waves (an H100 holds 7 at once)."""
    assert _jplan(1024, 64, 64, torch.float32)[:4] == (1, False, 128, 4)
    assert _jplan(8, 512, 512, torch.float32)[:4] == (16, False, 512, 32)
    assert dict(_jres(512, 512, torch.float32))[16, False] == 7


@pytest.mark.parametrize("m,n", [(64, 64), (128, 128), (512, 512), (96, 64),
                                 (1024, 64), (64, 256), (6, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_lanes_hold_a_column_in_registers(m, n, dtype):
    g = js.lanes_for(m, n)
    assert g in (4, 8, 16, 32)
    if g < 32:
        assert -(-m // g) <= js.ENTRIES and -(-n // g) <= js.ENTRIES
        assert g == 4 or -(-m // (g // 2)) > js.ENTRIES \
            or -(-n // (g // 2)) > js.ENTRIES
    for cs, vg in js.placements(m, n, dtype):
        assert cs == 1 or (n // 2) // cs >= js.MIN_PAIRS
        assert not vg or n % (16 // (torch.finfo(dtype).bits // 8)) == 0


def test_jacobi_plan_refusals_and_the_round_launches():
    with pytest.raises(ValueError):
        js.plan(1, 4, 3, torch.float32)
    with pytest.raises(ValueError):
        js.launch_on(512, 512, torch.float32, 16, False) and \
            js.launch_on(512, 512, torch.float32, 4, False)
    # a card that holds none of the cluster launches
    none = tuple((p, 0) for p in js.placements(512, 512, torch.float32))
    with pytest.raises(ValueError):
        js.plan(8, 512, 512, torch.float32, resident=none)
    # what no cluster of 16 holds runs one launch a round
    for dtype in DTYPES:
        assert js.placements(1024, 1024, dtype) == []
        assert js.plan(1, 1024, 1024, dtype) == js.ROUNDS


# ------------------------------------------------------------ rrqr's plan

# (Nb, M, N) of every rrqr_kernel launch the main path and the card tests
# make: config 2's systems by solve, the 512² rrqr_decomp, and the card
# tests' shapes
RRQR = [(1024, 128, 128), (32, 512, 512), (4, 512, 512), (3, 24, 16),
        (2, 16, 24), (4, 128, 128), (2, 300, 260), (3, 100, 60)]


def _rplan(nb, m, n, dtype):
    if rk.small_regime(m, n, dtype):
        return rk.plan(nb, m, n, dtype)
    return rk.plan(nb, m, n, dtype, resident=_rres(m, n, dtype))


@pytest.mark.parametrize("shape", RRQR)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rrqr_plan_fits_a_block_and_takes_the_fewest_waves(shape, dtype):
    nb, m, n = shape
    cluster, threads, ncs, smem = _rplan(nb, m, n, dtype)
    ncmax = -(-n // cluster)
    assert smem == rk.smem_bytes(m, n, cluster, ncs, dtype) <= _build.SMEM_MAX
    assert 32 <= threads <= rk.MAX_THREADS and threads % 32 == 0
    # as many of a block's columns in shared memory as fit
    assert 0 <= ncs <= ncmax
    assert ncs == ncmax or rk.smem_bytes(m, n, cluster, ncs + 1, dtype) \
        > _build.SMEM_MAX
    if rk.small_regime(m, n, dtype):
        assert (cluster, ncs) == (1, n)
        return
    # the fewest columns left in L2, then the fewest waves, then the
    # smallest cluster
    holds = {c: k for c, k in _rres(m, n, dtype) if k}
    left = {c: -(-n // c) - rk._columns_in_smem(m, n, c, dtype) for c in holds}
    assert left[cluster] == min(left.values())
    mine = [c for c in holds if left[c] == left[cluster]]
    waves = -(-nb // holds[cluster])
    assert waves == min(-(-nb // holds[c]) for c in mine)
    assert cluster == min(c for c in mine if -(-nb // holds[c]) == waves)
    assert cluster == 1 or n // cluster >= rk.MIN_COLS


def test_rrqr_main_path_plans():
    """config 2's systems: one block of 256 threads a matrix, every column in
    shared memory; the 512² batch: the smallest cluster that holds every
    column in shared memory in the fewest waves."""
    assert _rplan(1024, 128, 128, torch.float32) == \
        (1, 256, 128, rk.smem_bytes(128, 128, 1, 128, torch.float32))
    cluster, _, ncs, _ = _rplan(32, 512, 512, torch.float32)
    assert ncs == -(-512 // cluster) and cluster == 5


def test_rrqr_plan_refusals():
    with pytest.raises(ValueError):
        rk.plan(1, 0, 4, torch.float32)
    with pytest.raises(ValueError):
        rk.launch_on(512, 512, torch.float32, 17)
    none = tuple((c, 0) for c in rk.placements(512, 512, torch.float32))
    with pytest.raises(ValueError):
        rk.plan(32, 512, 512, torch.float32, resident=none)


@pytest.mark.parametrize("m,n", [(24, 16), (16, 24), (128, 128), (100, 60),
                                 (300, 260), (512, 512)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_small_regimes_are_one_block_plans(m, n, dtype):
    """small_regime is the plans' shared regime: every column of one matrix
    in one block's shared memory."""
    small = rk.small_regime(m, n, dtype)
    assert small == (rk.smem_bytes(m, n, 1, n, dtype) <= _build.SMEM_MAX)
    small = js.small_regime(m, n + n % 2, dtype)
    assert small == ((1, False) in js.placements(m, n + n % 2, dtype)
                     and js.smem_bytes(m, n + n % 2, 1, False, dtype)
                     <= _build.SMEM_MAX)
