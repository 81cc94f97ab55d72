"""Partial-pivot LU with virtual pivoting: the CUDA kernels
``csrc/lu_panel.cu`` (the port of ``lu_panel`` and ``lu_gesv`` in
``nd4js_tpu/ops/lu_panel.py``), their plain PyTorch versions, their launch
plans, and launch counters.

Both eliminate column by column without moving rows. Step j picks as
pivot the row, among those not yet used, with the largest |A[row, j]|,
ties going to the lowest row index; it divides the other unused rows'
entries of column j by the pivot (by 1 where the pivot is 0, so a zero
column gives a zero L column) and subtracts their multiple of the pivot
row from their later columns. ``rank[row]`` records the step at which a
row became pivot, B if it never did. The TPU kernels' transposed panels,
stripes of 8, deferred stripe updates and bf16 splits were Mosaic
devices and are not ported: this is plain right-looking elimination, in
full float32/float64.

``lu_panel`` runs each matrix on a thread-block cluster of 1-16 blocks,
each block a slab of rows in its shared memory (in global memory where
no cluster holds the matrix): :func:`plan` chooses the cluster from the
clusters the card holds at once. ``lu_gesv`` (:func:`gesv_plan`) runs a
float32 system of N ≤ 128 (N + K ≤ 136) in the registers of a block of
eight warps, two blocks an SM, and any other system on one block of the
panel's kernel, with the back substitution after it.
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["CLUSTER_SIZES", "LAYOUTS", "card_plan", "gesv_layouts",
           "gesv_plan", "gesv_regs_bytes", "launch_on", "lu_gesv",
           "lu_gesv_ref", "lu_panel", "lu_panel_ref", "placements", "plan",
           "regime", "resident_clusters", "smem_bytes", "warps_for"]

CLUSTER_SIZES = tuple(range(1, 17))  # up to kMaxCluster; above 8 non-portable
MAX_THREADS = 512                    # kMaxThreads
# rows a warp of the elimination takes; the fewest a block of a cluster of
# more than one block holds (below that a step is all barrier); and the
# most a block of the plan's cluster holds (see plan)
ROWS_PER_WARP = 8
MIN_ROWS = 32
MAX_ROWS = 176
# lu_gesv in registers: warps a system, row slots a lane, column slots a
# warp (kRegWarps, kRegRows, kRegCols): N <= 128 and N + K <= 136
REG_WARPS, REG_ROWS, REG_COLS = 8, 4, 17
# lu_gesv's layouts, as the C function numbers them
LAYOUTS = ("registers", "shared", "global")

# Kernel launches since the last reset; only each wrapper's CUDA branch
# adds to its count.
launches = {"lu_panel": 0, "lu_gesv": 0}


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_bytes(m: int, ncols: int, steps: int, cs: int, warps: int,
               shared: bool, solve: bool, dtype: torch.dtype) -> int:
    """Shared memory of one block of the elimination (``elim_bytes`` of
    the .cu): its ceil(m / cs) rows at the odd stride ncols | 1 (in the
    shared regime), the candidates' double buffer (cs·warps values and
    rows), each warp's list of its live rows and their multipliers
    (ceil(rows / warps) a warp), its rows' ranks (shared regime), each
    step's pivot row (when solving) and each row's block and place
    (shared regime)."""
    elem = torch.finfo(dtype).bits // 8
    rmax = -(-m // cs)
    ncand = cs * warps
    lists = -(-rmax // warps) * warps
    return ((_align16(elem * rmax * (ncols | 1)) if shared else 0)
            + _align16(elem * (2 * ncand + lists))
            + 4 * (2 * ncand + lists + (rmax + m if shared else 0)
                   + (steps if solve else 0)))


def gesv_regs_bytes(n: int, k: int) -> int:
    """Shared memory of one block of lu_gesv in registers (``regs_bytes`` of
    the .cu): U packed (or the load's staging tile of 32 rows at an odd
    stride, the larger), z, the multipliers' double buffer, the stash of
    the next column and the pivots' double buffer."""
    area = max(n * (n + 1) // 2, 32 * ((n + k) | 1))
    return 4 * (-(-area // 4) * 4 + n * k + 3 * 32 * REG_ROWS) + 4 * 2


def warps_for(rows: int) -> int:
    """Warps of an elimination block of ``rows`` rows: one for each
    ROWS_PER_WARP, up to MAX_THREADS // 32."""
    return min(MAX_THREADS // 32, max(1, -(-rows // ROWS_PER_WARP)))


def placements(m: int, b: int, dtype: torch.dtype):
    """(cluster size, rows in shared memory) of every launch that places a
    panel (·, m, b): each size whose blocks hold MIN_ROWS rows or more (one
    block always), with the rows in shared memory where 227 KB holds them
    and in global memory always."""
    out = []
    for cs in CLUSTER_SIZES:
        if cs > max(1, m // MIN_ROWS):
            break
        warps = warps_for(-(-m // cs))
        if smem_bytes(m, b, b, cs, warps, True, False, dtype) \
                <= _build.SMEM_MAX:
            out.append((cs, True))
        out.append((cs, False))
    return out


def launch_on(m: int, b: int, dtype: torch.dtype, cluster: int,
              shared: bool):
    """The launch of a panel (·, m, b) on clusters of ``cluster`` blocks,
    rows in shared or in global memory: (cluster, threads a block, shared
    as 0/1, shared-memory bytes a block)."""
    if (cluster, shared) not in placements(m, b, dtype):
        raise ValueError(f"lu_panel: a cluster of {cluster} "
                         f"({'shared' if shared else 'global'} memory) does "
                         f"not place m={m}, b={b} ({dtype})")
    warps = warps_for(-(-m // cluster))
    return (cluster, 32 * warps, int(shared),
            smem_bytes(m, b, b, cluster, warps, shared, False, dtype))


@functools.lru_cache(maxsize=256)
def plan(nb: int, m: int, b: int, dtype: torch.dtype, resident: tuple = ()):
    """Launch of lu_panel on ``nb`` panels (m, b) on a card that holds
    ``resident`` (((C, shared), clusters), ... for each placement, from
    :func:`resident_clusters`) at once: a :func:`launch_on` tuple.

    The rule: rows in shared memory wherever a cluster the card holds
    places them; then the fewest waves (ceil(nb / clusters held at once));
    then the smallest cluster whose blocks hold at most MAX_ROWS rows (the
    largest if none does). A step costs a fixed chain (the pivot's search,
    its row, the multipliers, the barrier: a cluster barrier costs about
    1000 cycles more than a block's) plus its block's update, so a cluster
    pays only where a block's slab is long: on lu_decomp's (32, 512|384|
    256|128, 128) float32 panels clusters of 3 were the fastest or within
    5% of it at 512, 384 and 256 rows, one block at 128 (20% ahead of any
    cluster), and clusters of 8-16 10-20% slower (NVIDIA H100 80GB HBM3,
    700 W; chip_smoke.py's lu_breakdown). Raises ValueError for a shape no
    launch places."""
    if m < 1 or b < 1 or m < b:
        raise ValueError(f"lu_panel: needs m >= b >= 1, got m={m}, b={b}")
    holds = {p: k for p, k in resident if k > 0}
    fit = [p for p in placements(m, b, dtype) if p in holds]
    if not fit:
        raise ValueError(f"lu_panel: no cluster the card holds places "
                         f"m={m}, b={b} ({dtype})")
    if any(sh for _, sh in fit):
        fit = [p for p in fit if p[1]]
    waves = min(-(-nb // holds[p]) for p in fit)
    fit = [p for p in fit if -(-nb // holds[p]) == waves]
    short = [p for p in fit if -(-m // p[0]) <= MAX_ROWS]
    best = min(short) if short else max(fit)
    return launch_on(m, b, dtype, *best)


def regime(cluster: int, threads: int, shared: int, smem: int, m: int) -> str:
    """A panel plan of m rows in words, for the card's printouts."""
    what = "one block a matrix" if cluster == 1 else f"a cluster of {cluster}"
    return (f"{what}, {threads} threads, {-(-m // cluster)} rows a block in "
            f"{'shared' if shared else 'global'} memory, {smem} bytes")


def resident_clusters(the_plan, dtype: torch.dtype) -> int:
    """Clusters of a launch in ``the_plan`` that the card holds at once, from
    cudaOccupancyMaxActiveClusters (needs the card and the built kernel
    library): nb panels take ceil(nb / that) waves."""
    cluster, threads, shared, smem = the_plan
    k = _build.library().nd4js_lu_panel_clusters(
        int(dtype == torch.float64), shared, cluster, threads, smem)
    if k < 0:
        raise RuntimeError(f"lu_panel: cudaOccupancyMaxActiveClusters "
                           f"failed with CUDA error {-k}")
    return k


def card_plan(nb: int, m: int, b: int, dtype: torch.dtype, device):
    """:func:`plan` with the clusters that the card of ``device`` holds at
    once: the launch :func:`lu_panel` makes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan(nb, m, b, dtype, resident=_resident_on(m, b, dtype, index))


@functools.lru_cache(maxsize=256)
def _resident_on(m: int, b: int, dtype: torch.dtype, index: int) -> tuple:
    """((C, shared), clusters the card holds at once) for each placement."""
    with torch.cuda.device(index):
        return tuple((p, resident_clusters(launch_on(m, b, dtype, *p), dtype))
                     for p in placements(m, b, dtype))


def gesv_layouts(n: int, k: int, dtype: torch.dtype):
    """Every launch of lu_gesv that takes systems (n, n) with k right-hand
    sides, the fastest first: (layout, threads a block, shared-memory bytes
    a block), layouts numbered as in LAYOUTS. ``registers`` (float32, n ≤
    128, n + k ≤ 136): eight warps hold [A | y] in registers, two blocks
    an SM; ``shared``: a block of the elimination, one warp a ROWS_PER_WARP
    rows, with [A | y] in shared memory where 227 KB holds it; ``global``:
    the same with [A | y] in global memory, always."""
    if n < 0 or k < 0:
        raise ValueError(f"lu_gesv: needs n, k >= 0, got n={n}, k={k}")
    out = []
    if dtype == torch.float32 and n <= 32 * REG_ROWS \
            and n + k <= REG_WARPS * REG_COLS:
        out.append((0, 32 * REG_WARPS, gesv_regs_bytes(n, k)))
    warps = warps_for(n)
    shared = smem_bytes(n, n + k, n, 1, warps, True, True, dtype)
    if shared <= _build.SMEM_MAX:
        out.append((1, 32 * warps, shared))
    out.append((2, 32 * warps,
                smem_bytes(n, n + k, n, 1, warps, False, True, dtype)))
    return out


def gesv_plan(nb: int, n: int, k: int, dtype: torch.dtype):
    """Launch of lu_gesv on ``nb`` systems (n, n) with k right-hand sides:
    the first of :func:`gesv_layouts`, one system a block in every layout.
    In registers an SM holds two systems of 128 × 129 (125 registers a
    thread of 256); the former kernel's 66 KB of shared memory a system
    held three, with every update a read and a write of shared memory
    (1.747 ms at config 2, against 0.812 in registers; tools/lu_ab.py
    on an NVIDIA H100 80GB HBM3, 700 W)."""
    return gesv_layouts(n, k, dtype)[0]


def _eliminate(a: torch.Tensor, steps: int, rank: torch.Tensor) -> None:
    """``steps`` elimination steps in place on a (Nb, M, C) and its rank
    (Nb, M), which enters as all ``steps`` (unused)."""
    nb, m, _ = a.shape
    rows = torch.arange(m, device=a.device)
    batch = torch.arange(nb, device=a.device)
    for j in range(steps):
        unused = rank == steps
        col = a[:, :, j]
        cand = torch.where(unused, col.abs(), -torch.ones_like(col))
        cmax = cand.amax(dim=1, keepdim=True)
        # the lowest row holding the maximum; none (p = M) if it is NaN
        p = torch.where(cand == cmax, rows, m).amin(dim=1)
        is_p = rows == p[:, None]
        piv = torch.where(is_p, col, torch.zeros_like(col)).sum(dim=1)
        safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        live = unused & ~is_p
        l = torch.where(live, col / safe[:, None], torch.zeros_like(col))
        a[:, :, j] = torch.where(live, l, col)
        u = a[batch, p.clamp(max=m - 1), j + 1:]                 # pivot row
        u = torch.where((p < m)[:, None], u, torch.zeros_like(u))
        a[:, :, j + 1:] = torch.where(live[:, :, None],
                                      a[:, :, j + 1:] - l[:, :, None]
                                      * u[:, None, :], a[:, :, j + 1:])
        rank.masked_fill_(is_p, j)


def lu_panel_ref(panel: torch.Tensor):
    """Plain PyTorch version of the ``lu_panel`` kernel: (factored panel
    with rows in input order, rank int32)."""
    out = panel.clone()
    nb, m, b = panel.shape
    rank = torch.full((nb, m), b, dtype=torch.int32, device=panel.device)
    _eliminate(out, b, rank)
    return out, rank


def lu_panel(panel: torch.Tensor):
    """Partial-pivot LU of a batched panel (Nb, M, B), M ≥ B, with
    virtual pivoting → (panel_factored (Nb, M, B), rank (Nb, M) int32).

    Rows stay in input order: the pivot row of step j (rank j) holds U's
    row j from column j on, and every other row holds its L multipliers
    in the columns of the steps before it became pivot. Sorting rows by
    (rank, index) gives the LAPACK-packed panel.

    A CUDA tensor runs the kernel in the launch of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`lu_panel_ref`.
    """
    on_card = _build.check_operand(panel, "lu_panel", 3)
    nb, m, b = panel.shape
    if m < b:
        raise ValueError(f"lu_panel: needs M >= B, got {tuple(panel.shape)}")
    if not on_card:
        return lu_panel_ref(panel)
    if nb == 0 or b == 0:
        return panel.clone(), torch.full((nb, m), b, dtype=torch.int32,
                                         device=panel.device)
    return _lu_panel_in(panel, card_plan(nb, m, b, panel.dtype, panel.device))


def _lu_panel_in(panel: torch.Tensor, the_plan):
    """:func:`lu_panel` on a CUDA tensor in the launch ``the_plan`` (the
    card's checks run every placement), counted in ``launches``."""
    nb, m, b = panel.shape
    out = panel.clone(memory_format=torch.contiguous_format)
    rank = torch.empty((nb, m), dtype=torch.int32, device=panel.device)
    f64 = panel.dtype == torch.float64
    _build.launch("nd4js_lu_panel_f64" if f64 else "nd4js_lu_panel_f32",
                  panel.device, out, rank, nb, m, b, *the_plan)
    launches["lu_panel"] += 1
    return out, rank


def lu_gesv_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``lu_gesv`` kernel: elimination of
    [A | y], then back substitution on the rows sorted by rank."""
    nb, n, _ = a.shape
    buf = torch.cat([a, y], dim=-1)
    rank = torch.full((nb, n), n, dtype=torch.int32, device=a.device)
    _eliminate(buf, n, rank)
    order = torch.argsort(rank, dim=1)
    buf = torch.gather(buf, 1, order[:, :, None].expand(buf.shape))
    z = buf[:, :, n:].clone()
    x = torch.empty_like(z)
    for j in range(n - 1, -1, -1):
        # a zero pivot yields inf/nan, as in the kernel and lu.js
        x[:, j] = z[:, j] / buf[:, j, j, None]
        z[:, :j] -= buf[:, :j, j, None] * x[:, None, j]
    return x


def lu_gesv(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve the square systems A·x = y, a (Nb, N, N), y (Nb, N, K) →
    x (Nb, N, K), by partial-pivot LU in ONE launch: the right-hand sides
    ride the elimination and back substitution runs in the kernel.
    Singular pivots give inf/nan and do not raise.

    A CUDA tensor runs the kernel in the launch of :func:`gesv_plan` (or
    raises); a CPU tensor runs :func:`lu_gesv_ref`.
    """
    on_card = _build.check_operand(a, "lu_gesv", 3)
    _build.check_operand(y, "lu_gesv", 3)
    nb, n, n2 = a.shape
    if n != n2 or y.shape[:2] != (nb, n):
        raise ValueError(f"lu_gesv: needs a (Nb, N, N) and y (Nb, N, K), got "
                         f"{tuple(a.shape)} and {tuple(y.shape)}")
    if y.dtype != a.dtype or y.device != a.device:
        raise ValueError("lu_gesv: a and y must share dtype and device")
    if not on_card:
        return lu_gesv_ref(a, y)
    return _lu_gesv_in(a, y, gesv_plan(nb, n, y.shape[-1], a.dtype))


def _lu_gesv_in(a: torch.Tensor, y: torch.Tensor, the_plan):
    """:func:`lu_gesv` on CUDA tensors in the launch ``the_plan``, counted
    in ``launches``: the registers read a and y as they are; the other
    layouts eliminate a copy of [A | y] (in global memory, with a scratch
    of the rows' steps)."""
    nb, n, _ = a.shape
    k = y.shape[-1]
    layout, threads, smem = the_plan
    a, y = a.contiguous(), y.contiguous()
    x = a.new_empty((nb, n, k))
    buf = work = None
    if layout != 0:
        buf = torch.cat([a, y], dim=-1).contiguous()
    if layout == 2:
        work = torch.empty((nb, n), dtype=torch.int32, device=a.device)
    f64 = a.dtype == torch.float64
    _build.launch("nd4js_lu_gesv_f64" if f64 else "nd4js_lu_gesv_f32",
                  a.device, a, y, buf, work, x, nb, n, k, layout, threads,
                  smem)
    launches["lu_gesv"] += 1
    return x
