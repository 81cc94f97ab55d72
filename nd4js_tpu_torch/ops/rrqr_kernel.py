"""Column-pivoted Householder QR with downdated column norms: the CUDA
kernel ``csrc/rrqr.cu`` (the port of
``nd4js_tpu/ops/rrqr_kernel.py::rrqr_kernel``), its plain PyTorch version,
and a launch counter.

For each step j < K = min(M, N): the squared column norms (computed once
on entry) are clamped at 0; the pivot is the trailing column (index ≥ j)
of largest norm, the lowest index on a tie; columns, perm entries and
norms j and p swap; the reflector of column j (rows ≥ j) has
β = −sign(x₀)·‖x‖ and τ = (β − x₀)/β, τ = 0 for a zero column, v₀ = 1;
it is applied to the columns > j; column j becomes β at row j above
zeros; and the norms of the columns > j lose the square of their new
row-j entry. Outputs (R_packed (Nb, M, N), V (Nb, M, K) with a unit
diagonal and zeros above, taus (Nb, K), perm (Nb, N) int32), with
A[:, perm] = H_0···H_{K−1}·triu(R_packed).

The kernel runs all K steps in one launch, each matrix on one thread-block
cluster (one block where the matrix fits its shared memory): :func:`plan`
chooses the cluster size and threads from the clusters the card holds at
once, and :func:`launch_on` lays out how many of a block's columns stay in
shared memory (the rest in an L2-resident scratch copy).
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["CLUSTER_SIZES", "card_plan", "launch_on", "placements", "plan",
           "regime", "resident_clusters", "rrqr_kernel", "rrqr_kernel_ref",
           "small_regime", "smem_bytes"]

CLUSTER_SIZES = tuple(range(1, 17))  # up to kMaxCluster; above 8 non-portable
MAX_THREADS = 512                    # kMaxThreads
MANY_THREADS = 256                   # kManyThreads: several blocks an SM
ALIGN = 4                            # kAlign
RED = 32                             # kRed
# columns a warp takes: one of the kernel's chunks of eight, or two in a
# matrix that one block holds whole (several blocks then share an SM); and
# the fewest a block of a cluster holds: below that a step is all barriers
COLS_PER_WARP = 8
MIN_COLS = 32

# Kernel launches since the last reset; only rrqr_kernel's CUDA branch adds
# to it, one per call.
launches = 0


def smem_bytes(m: int, n: int, cs: int, ncs: int, dtype: torch.dtype) -> int:
    """Shared memory of one block (``rrqr_bytes`` of the .cu): ncs columns
    of M rounded up to 4, v and τ, the norms of the block's columns, the
    cluster's and the warps' candidates, the warps' parts of σ, and in
    ints the maps pos and phys,
    the candidates' indices, the two lists of active columns, each
    column's place in its list and the lists' lengths."""
    elem = torch.finfo(dtype).bits // 8
    ldm = -(-m // ALIGN) * ALIGN
    ncmax = -(-n // cs)
    return (elem * (ncs * ldm + ldm + 1 + ncmax + CLUSTER_SIZES[-1] + 2 * RED)
            + 4 * (2 * n + CLUSTER_SIZES[-1] + RED + 3 * ncmax + 2))


def _columns_in_smem(m: int, n: int, cs: int, dtype: torch.dtype) -> int:
    """Columns a block keeps in shared memory: all of its ceil(n / cs), or
    as many as 227 KB leaves (−1: not even v and the maps fit)."""
    elem = torch.finfo(dtype).bits // 8
    ldm = -(-m // ALIGN) * ALIGN
    room = _build.SMEM_MAX - smem_bytes(m, n, cs, 0, dtype)
    return -1 if room < 0 else min(-(-n // cs), room // (elem * ldm))


def small_regime(m: int, n: int, dtype: torch.dtype) -> bool:
    """True when one matrix, its reflector, its norms and the maps fit one
    block's shared memory: the plan then runs a matrix a block with every
    column there (the shared regime)."""
    return _columns_in_smem(m, n, 1, dtype) == n


def placements(m: int, n: int, dtype: torch.dtype):
    """Cluster sizes whose blocks hold v and the maps in 227 KB (their
    columns may all come from L2): one block, or clusters whose ranks hold
    MIN_COLS columns or more."""
    return [cs for cs in CLUSTER_SIZES
            if (cs == 1 or n // cs >= MIN_COLS)
            and _columns_in_smem(m, n, cs, dtype) >= 0]


def launch_on(m: int, n: int, dtype: torch.dtype, cluster: int):
    """The launch of (·, m, n) on clusters of ``cluster`` blocks: (cluster,
    threads a block, columns a block in shared memory, shared-memory bytes
    a block). Threads: a warp for each COLS_PER_WARP columns of the largest
    rank, up to MAX_THREADS; a matrix one block holds whole takes twice the
    columns a warp, up to MANY_THREADS, so that several blocks share an
    SM."""
    if cluster not in placements(m, n, dtype):
        raise ValueError(f"rrqr_kernel: a cluster of {cluster} does not "
                         f"place m={m}, n={n} ({dtype})")
    ncmax = -(-n // cluster)
    ncs = _columns_in_smem(m, n, cluster, dtype)
    if cluster == 1 and ncs == n:
        warps = max(1, min(MANY_THREADS // 32, -(-n // (2 * COLS_PER_WARP))))
    else:
        warps = max(1, min(MAX_THREADS // 32, -(-ncmax // COLS_PER_WARP)))
    return (cluster, 32 * warps, ncs, smem_bytes(m, n, cluster, ncs, dtype))


@functools.lru_cache(maxsize=256)
def plan(nb: int, m: int, n: int, dtype: torch.dtype, resident: tuple = ()):
    """Launch of the kernel on ``nb`` matrices (m, n) on a card that holds
    ``resident`` ((C, clusters), ... for each placeable C, from
    :func:`resident_clusters`) at once: a :func:`launch_on` tuple.

    The rule: one block a matrix with every column in its shared memory
    where they fit (the card need not be asked); else the cluster that
    leaves the fewest columns a block in L2, then the fewest waves
    (ceil(nb / clusters held at once)), then the smallest cluster. The
    (32, 512, 512) float32 batch (32 MB, against 132 × 227 KB of shared
    memory) cannot run in one wave with every column in shared memory:
    clusters of 3 hold 39 at once but leave 63 of a block's 171 columns in
    L2, and took 8.32 ms against 7.76 for two waves of clusters of 5 with
    none (NVIDIA H100 80GB HBM3, 700 W). Raises ValueError for a shape no
    launch places.
    """
    if m < 1 or n < 1:
        raise ValueError(f"rrqr_kernel: needs m, n >= 1, got m={m}, n={n}")
    if small_regime(m, n, dtype):
        return launch_on(m, n, dtype, 1)
    places = placements(m, n, dtype)
    holds = dict(resident)
    fit = [c for c in places if holds.get(c, 0) > 0]
    if not fit:
        raise ValueError(f"rrqr_kernel: no cluster the card holds places "
                         f"m={m}, n={n} ({dtype})")

    def cost(c):
        return (-(-n // c) - _columns_in_smem(m, n, c, dtype), -(-nb // holds[c]), c)

    return launch_on(m, n, dtype, min(fit, key=cost))


def regime(cluster: int, threads: int, ncs: int, smem: int, n: int) -> str:
    """A plan of a matrix of n columns in words, for the card's printouts."""
    ncmax = -(-n // cluster)
    what = "one block a matrix" if cluster == 1 else f"a cluster of {cluster}"
    l2 = ("all in shared memory" if ncs >= ncmax
          else f"{ncmax - ncs} of {ncmax} columns a block in L2")
    return f"{what}, {threads} threads, {l2}, {smem} bytes"


def resident_clusters(the_plan, dtype: torch.dtype) -> int:
    """Clusters of a launch in ``the_plan`` that the card holds at once, from
    cudaOccupancyMaxActiveClusters (needs the card and the built kernel
    library): nb matrices take ceil(nb / that) waves."""
    cluster, threads, _, smem = the_plan
    k = _build.library().nd4js_rrqr_clusters(int(dtype == torch.float64),
                                             cluster, threads, smem)
    if k < 0:
        raise RuntimeError(f"rrqr_kernel: cudaOccupancyMaxActiveClusters "
                           f"failed with CUDA error {-k}")
    return k


def card_plan(nb: int, m: int, n: int, dtype: torch.dtype, device):
    """:func:`plan` with the clusters that the card of ``device`` holds at
    once (asked only when the plan needs them): the launch
    :func:`rrqr_kernel` makes."""
    if small_regime(m, n, dtype):
        return plan(nb, m, n, dtype)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan(nb, m, n, dtype, resident=_resident_on(m, n, dtype, index))


@functools.lru_cache(maxsize=256)
def _resident_on(m: int, n: int, dtype: torch.dtype, index: int) -> tuple:
    """(C, clusters the card holds at once) for each placeable C."""
    with torch.cuda.device(index):
        return tuple((c, resident_clusters(launch_on(m, n, dtype, c), dtype))
                     for c in placements(m, n, dtype))


def rrqr_kernel_ref(a: torch.Tensor):
    """Plain PyTorch version of the kernel: ``_rrqr_kernel``
    (``nd4js_tpu/ops/rrqr_kernel.py:33-110``) with the batch axis written
    out. Returns (R_packed, V, taus, perm)."""
    nb, m, n = a.shape
    k = min(m, n)
    r = a.clone()
    V = a.new_zeros((nb, m, k))
    taus = a.new_zeros((nb, k))
    perm = torch.arange(n, dtype=torch.int32, device=a.device).repeat(nb, 1)
    norms = (a * a).sum(1)
    lanes = torch.arange(n, device=a.device)
    rows = torch.arange(m, device=a.device)
    batch = torch.arange(nb, device=a.device)
    for j in range(k):
        norms = torch.clamp(norms, min=0.0)
        cand = torch.where(lanes >= j, norms, -1.0)
        # argmax with the lowest index on a tie
        cmax = cand.amax(1, keepdim=True)
        p = torch.where(cand == cmax, lanes, n).amin(1)
        p = torch.where(p == n, j, p)          # all-NaN trailing norms
        colj, colp = r[:, :, j].clone(), r[batch, :, p].clone()
        r[:, :, j], r[batch, :, p] = colp, colj
        pj, pp = perm[:, j].clone(), perm[batch, p].clone()
        perm[:, j], perm[batch, p] = pp, pj
        nj, np_ = norms[:, j].clone(), norms[batch, p].clone()
        norms[:, j], norms[batch, p] = np_, nj
        x = colp
        x0 = x[:, j]
        sigma = (x[:, j + 1:] ** 2).sum(1)
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > j, x / safe_den[:, None], 0.0)
        v[:, j] = 1.0
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(nrm == 0, 0.0, (beta - x0) / safe_beta)
        w = tau[:, None] * (r[:, :, j + 1:] * v[:, :, None]).sum(1)
        r[:, :, j + 1:] -= v[:, :, None] * w[:, None, :]
        r[:, j + 1:, j] = 0.0
        r[:, j, j] = beta
        V[:, :, j] = v
        taus[:, j] = tau
        rrow = r[:, j, j + 1:]
        norms[:, j + 1:] = norms[:, j + 1:] - rrow * rrow
    return r, V, taus, perm


def rrqr_kernel(a: torch.Tensor):
    """Column-pivoted Householder factorisation of (Nb, M, N) → (R_packed,
    V, taus, perm), as the module docstring says.

    A CUDA tensor runs the kernel in the launch of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`rrqr_kernel_ref`. The kernel returns
    R_packed and V as transposed views of column-major buffers.
    """
    if not _build.check_operand(a, "rrqr_kernel", 3):
        return rrqr_kernel_ref(a)
    nb, m, n = a.shape
    return _rrqr_in(a, card_plan(nb, m, n, a.dtype, a.device))


def _rrqr_in(a: torch.Tensor, the_plan):
    """:func:`rrqr_kernel` on a CUDA tensor in the launch ``the_plan``,
    counted in ``launches``; one the card cannot place raises."""
    global launches
    nb, m, n = a.shape
    k = min(m, n)
    cluster, threads, ncs, smem = the_plan
    at = a.mT.contiguous()
    rt = torch.empty_like(at)
    vt = a.new_empty((nb, k, m))
    taus = a.new_empty((nb, k))
    perm = torch.empty((nb, n), dtype=torch.int32, device=a.device)
    # the columns a block leaves in L2 live in a scratch copy of A
    work = torch.empty_like(at) if ncs < -(-n // cluster) else None
    _build.launch("nd4js_rrqr_f64" if a.dtype == torch.float64 else
                  "nd4js_rrqr_f32", a.device, at, rt, vt, taus, perm, work,
                  nb, m, n, cluster, threads, ncs, smem)
    launches += 1
    return rt.mT, vt.mT, taus, perm
