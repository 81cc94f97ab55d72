"""Whole sweeps of one-sided (Hestenes) Jacobi rotations: the CUDA kernel
``csrc/jacobi_sweep.cu`` (the port of
``nd4js_tpu/ops/jacobi_sweep.py::jacobi_sweeps``), its plain PyTorch
version, and a launch counter.

W (Nb, M, n) and V (Nb, n, n), n even, are split into column halves:
pair i of a round rotates the column at top seat i (role p) against the
one at bottom seat i (role q), then the Brent-Luk shuffle

    top = [t0, b0, t1, …, t_{h−2}],  bottom = [b1, …, b_{h−1}, t_{h−1}]

moves every column but t0 one seat along a ring of n − 1 seats. A sweep
is n − 1 rounds, so every column ends where it started. The column norms
are computed once at the start of each sweep and carried through the
rotations (app' = c²·app − 2cs·apq + s²·aqq), clamped at 0 before each
use; only apq is reduced afresh each round. A pair is left alone when
|apq| ≤ tiny; t = 1 for τ = 0; c = rsqrt(1 + t²). ``off`` is the largest
|apq| / (√app·√aqq + tiny) seen before a rotation, over all rounds of
all sweeps of the call.

The kernel runs all of a call's sweeps in one launch, each matrix on one
thread-block cluster (one block where W and V fit its shared memory):
:func:`plan` chooses the cluster size, whether V stays in global memory,
the threads and the lanes a pair from the clusters the card holds at
once, and :func:`launch_on` lays a given choice out. What no cluster
holds runs one launch a round.
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["CLUSTER_SIZES", "ROUNDS", "card_plan", "jacobi_sweeps",
           "jacobi_sweeps_ref", "lanes_for", "launch_on", "placements",
           "plan", "regime", "resident_clusters", "slots", "small_regime",
           "smem_bytes"]

CLUSTER_SIZES = tuple(range(1, 17))  # up to kMaxCluster; above 8 non-portable
MAX_THREADS = 512                    # kMaxThreads of the ring kernel
ENTRIES = 16                         # kEntries: rows of a column a lane holds
PASSES = 2                           # kPasses: pairs a group of lanes takes a round
ALIGN = 32                           # kAlign
RED = 32                             # kRed
# fewest pairs a block of a cluster holds: below that a round is all barrier
MIN_PAIRS = 2
# the launch-a-round path's plan: no cluster holds the matrix
ROUNDS = (0, False, 0, 0, 0)

# Kernel launches since the last reset; only jacobi_sweeps' CUDA branch
# adds to it, one per call (one call is ``sweeps`` whole sweeps).
launches = 0


def _up(x: int) -> int:
    return -(-x // ALIGN) * ALIGN


def _seats(cs: int, h: int):
    """Pairs each rank of a cluster of cs holds (``seat_lo`` of the .cu)."""
    return [(b + 1) * h // cs - b * h // cs for b in range(cs)]


def slots(cs: int, h: int) -> int:
    """Column slots a block lays out (``max_slots``): the whole ring and top
    seat 0 on one block; on a cluster each run of seats with one spare slot,
    and rank 0's top seat 0."""
    if cs == 1:
        return 2 * h
    return max(2 * s + (1 if b in (0, cs - 1) else 2)
               for b, s in enumerate(_seats(cs, h)))


def smem_bytes(m: int, n: int, cs: int, vglobal: bool,
               dtype: torch.dtype) -> int:
    """Shared memory of one block of the ring kernel (``ring_bytes``): the
    slots (W's column, and V's unless V stays in global memory, each from a
    multiple of 32 elements), a norm a slot, the block's and the cluster's
    off, and a column index a slot."""
    elem = torch.finfo(dtype).bits // 8
    nsl = slots(cs, n // 2)
    stride = _up(m) + (0 if vglobal else _up(n))
    return elem * (nsl * stride + nsl + RED + CLUSTER_SIZES[-1]) + 4 * nsl


def lanes_for(m: int, n: int) -> int:
    """Lanes a pair: the fewest (4 to 32) that hold both columns of W and of
    V in ENTRIES registers a lane; 32 (the columns streamed) beyond."""
    for g in (4, 8, 16, 32):
        if -(-m // g) <= ENTRIES and -(-n // g) <= ENTRIES:
            return g
    return 32


def small_regime(m: int, n: int, dtype: torch.dtype) -> bool:
    """True when W, V and the carried norms of one matrix fit one block's
    shared memory: the plan then runs a matrix a block, all its sweeps
    there (the shared regime)."""
    return smem_bytes(m, n, 1, False, dtype) <= _build.SMEM_MAX


def _threads(m: int, n: int, cs: int) -> int:
    """A group of lanes for each pair of the largest rank, at most
    MAX_THREADS, in whole warps."""
    g = lanes_for(m, n)
    return -(-min(-(-(n // 2) // cs), MAX_THREADS // g) * g // 32) * 32


def placements(m: int, n: int, dtype: torch.dtype):
    """(cluster size, V in global memory) of every ring launch whose blocks
    fit 227 KB and whose groups of lanes take at most PASSES pairs a round:
    one block, or clusters whose ranks hold MIN_PAIRS pairs or more. V in
    global memory is read 16 bytes a lane, so it needs n a multiple of 4
    in float32."""
    h = n // 2
    vec = 16 // (torch.finfo(dtype).bits // 8)
    return [(cs, vg) for cs in CLUSTER_SIZES for vg in (False, True)
            if (cs == 1 or h // cs >= MIN_PAIRS) and cs <= h
            and -(-h // cs) <= PASSES * (_threads(m, n, cs)
                                         // lanes_for(m, n))
            and not (vg and n % vec)
            and smem_bytes(m, n, cs, vg, dtype) <= _build.SMEM_MAX]


def launch_on(m: int, n: int, dtype: torch.dtype, cluster: int,
              vglobal: bool):
    """The ring launch of (·, m, n) on clusters of ``cluster`` blocks, V in
    global memory when ``vglobal``: (cluster, vglobal, threads a block,
    lanes a pair, shared-memory bytes a block). Threads: a group of lanes
    for each pair of the largest rank, at most MAX_THREADS (a group then
    takes up to PASSES pairs a round)."""
    if (cluster, vglobal) not in placements(m, n, dtype):
        raise ValueError(f"jacobi_sweeps: a cluster of {cluster} with V in "
                         f"{'global' if vglobal else 'shared'} memory does "
                         f"not place m={m}, n={n} ({dtype})")
    return (cluster, bool(vglobal), _threads(m, n, cluster),
            lanes_for(m, n), smem_bytes(m, n, cluster, vglobal, dtype))


@functools.lru_cache(maxsize=256)
def plan(nb: int, m: int, n: int, dtype: torch.dtype, resident: tuple = ()):
    """Launch of the kernel on ``nb`` matrices W (m, n) on a card that holds
    ``resident`` (((C, vglobal), clusters), ... for each placement, from
    :func:`resident_clusters`) at once: a :func:`launch_on` tuple, or
    :data:`ROUNDS`.

    The rule: one block a matrix with W and V in its shared memory where
    they fit (the card need not be asked); else a cluster launch, V in
    shared memory before V in global memory, then the fewest waves
    (ceil(nb / clusters held at once)), then the largest cluster; one
    launch a round where no cluster places. An H100 holds 7 clusters of
    10-16 blocks at once, so (8, 512, 512) in float32, whose W and V need
    clusters of 10 or more, runs in two waves of clusters of 16: that took
    2.67 ms a sweep, against 3.20 for the best single wave, V through L2 on
    clusters of 9 (NVIDIA H100 80GB HBM3, 700 W). Raises ValueError for a
    card that places none of the launches.
    """
    if n < 2 or n % 2 or m < 1:
        raise ValueError(f"jacobi_sweeps: needs m >= 1 and n even, got "
                         f"m={m}, n={n}")
    if small_regime(m, n, dtype):
        return launch_on(m, n, dtype, 1, False)
    places = placements(m, n, dtype)
    if not places:
        return ROUNDS
    holds = dict(resident)
    fit = [p for p in places if holds.get(p, 0) > 0]
    if not fit:
        raise ValueError(f"jacobi_sweeps: the card holds none of the "
                         f"cluster launches of m={m}, n={n} ({dtype})")
    best = min(fit, key=lambda p: (p[1], -(-nb // holds[p]), -p[0]))
    return launch_on(m, n, dtype, *best)


def regime(cluster: int, vglobal: bool, threads: int, lanes: int,
           smem: int) -> str:
    """A plan in words, for the card's printouts."""
    if cluster == 0:
        return "global memory, one launch a round"
    where = "V in global memory" if vglobal else "W and V in shared memory"
    what = "one block a matrix" if cluster == 1 else f"a cluster of {cluster}"
    return (f"{what}, {where}, {threads} threads, {lanes} lanes a pair, "
            f"{smem} bytes")


def resident_clusters(the_plan, dtype: torch.dtype) -> int:
    """Clusters of a ring launch in ``the_plan`` that the card holds at once,
    from cudaOccupancyMaxActiveClusters (needs the card and the built
    kernel library): nb matrices take ceil(nb / that) waves."""
    cluster, vglobal, threads, _, smem = the_plan
    k = _build.library().nd4js_jacobi_clusters(
        int(dtype == torch.float64), int(vglobal), cluster, threads, smem)
    if k < 0:
        raise RuntimeError(f"jacobi_sweeps: cudaOccupancyMaxActiveClusters "
                           f"failed with CUDA error {-k}")
    return k


def card_plan(nb: int, m: int, n: int, dtype: torch.dtype, device):
    """:func:`plan` with the clusters that the card of ``device`` holds at
    once (asked only when the plan needs them): the launch
    :func:`jacobi_sweeps` makes."""
    if small_regime(m, n, dtype):
        return plan(nb, m, n, dtype)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan(nb, m, n, dtype, resident=_resident_on(m, n, dtype, index))


@functools.lru_cache(maxsize=256)
def _resident_on(m: int, n: int, dtype: torch.dtype, index: int) -> tuple:
    """((C, vglobal), clusters the card holds at once) for each placement."""
    with torch.cuda.device(index):
        return tuple((p, resident_clusters(launch_on(m, n, dtype, *p), dtype))
                     for p in placements(m, n, dtype))


def _shuffle(t, b):
    """Brent-Luk step on the two seat rows (``nd4js_tpu/la/svd_jac.py:57-65``)."""
    h = t.shape[-1]
    if h == 1:
        return t, b
    nt = torch.cat([t[..., :1], b[..., :1], t[..., 1:h - 1]], -1)
    nb = torch.cat([b[..., 1:], t[..., h - 1:]], -1)
    return nt, nb


def jacobi_sweeps_ref(w: torch.Tensor, v: torch.Tensor, sweeps: int = 1):
    """Plain PyTorch version of the kernel: ``_sweep_kernel``
    (``nd4js_tpu/ops/jacobi_sweep.py:56-118``) with the batch axis
    written out. Returns (W, V, off (Nb,))."""
    nb, _, n = w.shape
    h = n // 2
    tiny = torch.finfo(w.dtype).tiny
    wt, wb = w[..., :h], w[..., h:]
    vt, vb = v[..., :h], v[..., h:]
    off = w.new_zeros((nb,))
    for _ in range(sweeps):
        app = (wt * wt).sum(1)
        aqq = (wb * wb).sum(1)
        for _ in range(n - 1):
            apq = (wt * wb).sum(1)
            app = torch.clamp(app, min=0.0)
            aqq = torch.clamp(aqq, min=0.0)
            denom = torch.sqrt(app) * torch.sqrt(aqq) + tiny
            off = torch.maximum(off, (apq.abs() / denom).amax(1))
            small = apq.abs() <= tiny
            safe = torch.where(small, 1.0, apq)
            tau = (aqq - app) / (2 * safe)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
            t = torch.where(tau == 0, 1.0, t)
            t = torch.where(small, 0.0, t)
            c = torch.rsqrt(1 + t * t)
            s = t * c
            c3, s3 = c[:, None, :], s[:, None, :]
            nwt, nwb = c3 * wt - s3 * wb, s3 * wt + c3 * wb
            nvt, nvb = c3 * vt - s3 * vb, s3 * vt + c3 * vb
            c2, s2, cs2 = c * c, s * s, 2 * c * s
            napp = c2 * app - cs2 * apq + s2 * aqq
            naqq = s2 * app + cs2 * apq + c2 * aqq
            app, aqq = _shuffle(napp, naqq)
            wt, wb = _shuffle(nwt, nwb)
            vt, vb = _shuffle(nvt, nvb)
    return torch.cat([wt, wb], -1), torch.cat([vt, vb], -1), off


def jacobi_sweeps(w: torch.Tensor, v: torch.Tensor, sweeps: int = 1):
    """``sweeps`` whole one-sided Jacobi sweeps on W (Nb, M, n), n even,
    accumulating the rotations into V (Nb, n, n). Returns (W, V, off):
    the columns of W and V are where they started (a sweep takes each
    once round the tournament), off (Nb,) is the largest relative
    off-diagonal measure seen.

    A CUDA tensor runs the kernel in the launch of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`jacobi_sweeps_ref`. The kernel
    returns W and V as transposed views of column-major buffers, which the
    next call reads without a copy.
    """
    on_card = _build.check_operand(w, "jacobi_sweeps", 3)
    _build.check_operand(v, "jacobi_sweeps", 3)
    nb, m, n = w.shape
    if n % 2 or n < 2 or tuple(v.shape) != (nb, n, n) or v.dtype != w.dtype \
            or v.device != w.device or sweeps < 0:
        raise ValueError(f"jacobi_sweeps: needs W (Nb, M, n) with n even, "
                         f"V (Nb, n, n) of its dtype and device and "
                         f"sweeps >= 0, got {tuple(w.shape)}, "
                         f"{tuple(v.shape)}, sweeps={sweeps}")
    if not on_card:
        return jacobi_sweeps_ref(w, v, sweeps)
    return _jacobi_in(w, v, sweeps, card_plan(nb, m, n, w.dtype, w.device))


def _jacobi_in(w: torch.Tensor, v: torch.Tensor, sweeps: int, the_plan):
    """:func:`jacobi_sweeps` on CUDA tensors in the launch ``the_plan`` (a
    :func:`launch_on` tuple, or :data:`ROUNDS`), counted in ``launches``;
    one the card cannot place raises."""
    global launches
    nb, m, n = w.shape
    wt_in = w.mT.contiguous()
    vt_in = v.mT.contiguous()
    wt = torch.empty_like(wt_in)
    vt = torch.empty_like(vt_in)
    off = w.new_empty((nb,))
    # the launch-a-round path's carried norms
    nrm = w.new_empty((nb, n) if the_plan[0] == 0 else (1,))
    cluster, vglobal, threads, lanes, smem = the_plan
    _build.launch("nd4js_jacobi_sweeps_f64" if w.dtype == torch.float64 else
                  "nd4js_jacobi_sweeps_f32", w.device, wt_in, vt_in, wt, vt,
                  off, nrm, nb, m, n, sweeps, cluster, int(vglobal), threads,
                  lanes, smem)
    launches += 1
    return wt.mT, vt.mT, off
