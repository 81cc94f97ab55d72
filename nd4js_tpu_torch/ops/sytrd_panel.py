"""One latrd panel of symmetric tridiagonalisation with its rank-2b update:
the CUDA kernel ``csrc/sytrd_panel.cu`` (the port of
``nd4js_tpu/ops/sytrd_panel.py::sytrd_panel``), its plain PyTorch
version, and a launch counter.

For each of the ``bk`` leading columns j of a batch of symmetric blocks C
(Nb, m, m), column j of the panel-updated matrix C − V·Wᵀ − W·Vᵀ gives
d[j] = its diagonal entry and a Householder reflector H_j = I − τ·v·vᵀ
(unit at row j + 1, zeros above) that zeroes it below the subdiagonal,
with e[j] = β; then w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)), less ½τ(wᵀv)·v, as
in LAPACK's latrd. A column already zero below the subdiagonal gives τ = 0
and β = its subdiagonal entry. The trailing block of C − V·Wᵀ − W·Vᵀ is
returned exactly symmetric: each entry (i, j ≥ i) is computed once as
(c_ij − x_ij) − x_ji with X = V·Wᵀ and mirrored, so that the next panel
may read a column of it as a row. (The TPU kernel computes the full block
as c − X − Xᵀ, whose two triangles round differently.)

The kernel runs each matrix on one thread-block cluster; :func:`plan`
chooses its size from the clusters the card holds at once, and
:func:`launch_on` lays out the rows each block holds, how many of their
columns stay in shared memory (the rest come from L2 once a step) and the
threads of a block.
"""
from __future__ import annotations

import functools

import torch

from ..core.mm import mm, mt
from . import _build

__all__ = ["CLUSTER_SIZES", "MAX_BK", "card_plan", "launch_on",
           "placeable_sizes", "plan", "regime", "resident_clusters",
           "smem_elements", "sytrd_panel", "sytrd_panel_ref"]

MAX_BK = 64        # widest panel the kernel takes (kMaxBk)
CLUSTER_SIZES = tuple(range(1, 17))  # up to kMaxCluster; above 8 non-portable
MAX_THREADS = 1024                 # kMaxThreads
RED = 32                           # kRed: block_sum's scratch
# fewest rows of C a block of a raised cluster holds: below that a step is
# all barriers
MIN_ROWS = 16

# Kernel launches since the last reset; only sytrd_panel's CUDA branch adds
# to it.
launches = 0


def sytrd_panel_ref(c: torch.Tensor, bk: int):
    """Plain PyTorch version of the kernel: ``_sytrd_panel``
    (``nd4js_tpu/la/sytrd.py:43-88``) with the batch axis written out,
    then the mirrored rank-2b update. Returns (C_trailing, V, W, taus, d,
    e)."""
    nb, m, _ = c.shape
    rows = torch.arange(m, device=c.device)
    V = c.new_zeros((nb, m, bk))
    W = c.new_zeros((nb, m, bk))
    taus, dd, ee = (c.new_zeros((nb, bk)) for _ in range(3))
    for j in range(bk):
        # finished column j of the panel-updated matrix
        col = c[:, :, j] - mm(V, W[:, j, :, None])[..., 0] \
            - mm(W, V[:, j, :, None])[..., 0]
        dd[:, j] = col[:, j]
        x0 = col[:, j + 1]
        sigma = torch.where(rows > j + 1, col * col, 0.0).sum(dim=1)
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        beta = torch.where(sigma == 0, x0, beta)     # no-op reflector
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > j + 1, col / safe_den[:, None], 0.0)
        v[:, j + 1] = 1.0
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(sigma == 0, 0.0, (beta - x0) / safe_beta)
        ee[:, j] = beta
        taus[:, j] = tau
        # w = τ·(C·v − V·Wᵀ·v − W·Vᵀ·v);  w −= ½·τ·(wᵀ·v)·v
        vc = v[..., None]
        cv = mm(c, vc) - mm(V, mm(mt(W), vc)) - mm(W, mm(mt(V), vc))
        w = tau[:, None] * cv[..., 0]
        w = w - (0.5 * tau * (w * v).sum(dim=1))[:, None] * v
        V[:, :, j] = v
        W[:, :, j] = w
    x = mm(V[:, bk:], mt(W[:, bk:]))
    full = c[:, bk:, bk:] - x - mt(x)
    # the upper triangle, mirrored: exactly symmetric, as the kernel's
    trail = torch.triu(full) + mt(torch.triu(full, 1))
    return trail, V, W, taus, dd, ee


def smem_elements(m: int, bk: int, rows: int, ncs: int, cluster: int) -> int:
    """Shared memory of one block of the column loop, in elements: ``layout``
    of ``csrc/sytrd_panel.cu`` (C's rows·ncs, V and W at an odd leading
    dimension, the column of the whole matrix, the slab's column of C, v
    and w, eight vectors of bk, this block's partial sums before they are
    pushed and each rank's after, and the block sum's scratch)."""
    return (m + rows * ncs + 2 * bk * (rows | 1) + 3 * rows + 8 * bk + 1
            + cluster * (2 * bk + 2) + 1 + RED)


def placeable_sizes(m: int, bk: int, dtype: torch.dtype):
    """The cluster sizes whose blocks hold their rows of V and W and the
    step's vectors in 227 KB (C's rows may all come from L2)."""
    cap = _build.SMEM_MAX // (torch.finfo(dtype).bits // 8)
    return [c for c in CLUSTER_SIZES
            if smem_elements(m, bk, -(-m // c), 0, c) <= cap]


@functools.lru_cache(maxsize=256)
def plan(nb: int, m: int, bk: int, dtype: torch.dtype, resident: tuple):
    """Launch of the kernel on ``nb`` blocks (m, m), a panel of ``bk``, on a
    card that holds ``resident`` ((C, clusters), ... for each placeable
    cluster size C, from :func:`resident_clusters`) at once: (cluster size,
    threads a block, rows a block, columns of them in shared memory,
    shared-memory bytes a block), as :func:`launch_on` lays it out.

    The rule: the smallest placeable cluster, raised as far as the launch
    still runs in one wave (nb clusters resident at once) and every block
    holds at least MIN_ROWS rows; the smallest placeable one when no larger
    keeps one wave. The H100 holds 30 clusters of 4 such blocks at once, not
    132 / 4 = 33, as its SMs come in groups that a cluster may not span.
    Raises ValueError for a panel the kernel does not take and for a shape
    no cluster places.
    """
    placeable = _placeable(m, bk, dtype)
    holds = dict(resident)
    wave = [c for c in placeable if nb <= holds[c]
            and (c == placeable[0] or -(-m // c) >= MIN_ROWS)]
    return launch_on(m, bk, dtype, max(wave) if wave else placeable[0])


def launch_on(m: int, bk: int, dtype: torch.dtype, cluster: int):
    """The launch of a panel of ``bk`` on blocks (m, m) on clusters of
    ``cluster`` blocks, a placeable size (the card's checks run each one):
    (cluster, threads a block, rows a block, columns of them in shared
    memory, shared-memory bytes a block). A block holds ceil(m / cluster)
    rows of C; they take what shared memory its rows of V and W and the
    step's vectors leave, their last columns first: a float64 slab is twice
    as large, so more of it comes from L2. Threads: two rows a warp, 4 to
    32 warps (a slab of more than 1024 rows has more rows than threads)."""
    if cluster not in _placeable(m, bk, dtype):
        raise ValueError(f"sytrd_panel: a cluster of {cluster} does not "
                         f"place m={m}, bk={bk} ({dtype})")
    elem = torch.finfo(dtype).bits // 8
    cap = _build.SMEM_MAX // elem
    rows = -(-m // cluster)
    # a multiple of 16 bytes, so that the kernel's loads of C stay aligned
    vec = 16 // elem
    ncs = min(m, (cap - smem_elements(m, bk, rows, 0, cluster)) // rows)
    ncs -= ncs % vec
    warps = 4
    while warps < 32 and 2 * warps < rows:
        warps *= 2
    return (cluster, 32 * warps, rows, ncs,
            elem * smem_elements(m, bk, rows, ncs, cluster))


def _placeable(m: int, bk: int, dtype: torch.dtype):
    """:func:`placeable_sizes`, or ValueError for a panel the kernel does
    not take or that no cluster places."""
    if not 1 <= bk <= min(MAX_BK, m - 1):
        raise ValueError(f"sytrd_panel: needs 1 <= bk <= min({MAX_BK}, "
                         f"m - 1), got m={m}, bk={bk}")
    placeable = placeable_sizes(m, bk, dtype)
    if not placeable:
        raise ValueError(f"sytrd_panel: no cluster of up to "
                         f"{CLUSTER_SIZES[-1]} blocks holds the rows of V and "
                         f"W of m={m}, bk={bk} ({dtype})")
    return placeable


def resident_clusters(the_plan, dtype: torch.dtype) -> int:
    """Clusters of a launch in ``the_plan`` that the card holds at once,
    from cudaOccupancyMaxActiveClusters (needs the card and the built
    kernel library): nb matrices take ceil(nb / that) waves."""
    cluster, threads, _, _, smem = the_plan
    n = _build.library().nd4js_sytrd_panel_clusters(
        int(dtype == torch.float64), cluster, threads, smem)
    if n < 0:
        raise RuntimeError(f"sytrd_panel: cudaOccupancyMaxActiveClusters "
                           f"failed with CUDA error {-n}")
    return n


def regime(cluster: int, threads: int, rows: int, ncs: int, smem: int,
           m: int) -> str:
    """A plan of a panel of m rows in words, for the card's printouts."""
    return (f"cluster of {cluster}, {threads} threads, {rows} rows a block, "
            f"{m - ncs} of {m} columns from L2, {smem} bytes")


def _launch(c, trail, vt, wt, taus, dd, ee, the_plan, stages=3):
    """The kernel on contiguous CUDA tensors in ``the_plan``, counted in
    ``launches``. ``stages`` 1 runs only the column loop and 2 only the
    trailing update (on V and W from an earlier launch), to time them
    apart."""
    global launches
    nb, m, _ = c.shape
    bk = vt.shape[1]
    f64 = c.dtype == torch.float64
    _build.launch("nd4js_sytrd_panel_f64" if f64 else "nd4js_sytrd_panel_f32",
                  c.device, c, trail, vt, wt, taus, dd, ee, nb, m, bk,
                  *the_plan, stages)
    launches += 1


def sytrd_panel(c: torch.Tensor, bk: int):
    """One latrd panel of ``bk`` columns on a batch of exactly symmetric
    blocks C (Nb, m, m), 1 ≤ bk ≤ min(MAX_BK, m − 1) → (C_trailing
    (Nb, m − bk, m − bk), V (Nb, m, bk), W (Nb, m, bk), taus, d, e (Nb,
    bk)), with C_trailing = (C − V·Wᵀ − W·Vᵀ)[:, bk:, bk:], exactly
    symmetric.

    A CUDA tensor runs the kernel in the launch of :func:`card_plan` (or
    raises); a CPU tensor runs :func:`sytrd_panel_ref`. The kernel returns
    V and W as transposed views of its (Nb, bk, m) panels.
    """
    on_card = _build.check_operand(c, "sytrd_panel", 3)
    nb, m, m2 = c.shape
    if m != m2 or not 1 <= bk <= min(MAX_BK, m - 1):
        raise ValueError(f"sytrd_panel: needs square blocks and 1 <= bk <= "
                         f"min({MAX_BK}, m - 1), got {tuple(c.shape)}, "
                         f"bk={bk}")
    if not on_card:
        return sytrd_panel_ref(c, bk)
    return _sytrd_panel_in(c, bk, card_plan(nb, m, bk, c.dtype, c.device))


def _sytrd_panel_in(c: torch.Tensor, bk: int, the_plan):
    """:func:`sytrd_panel` on a CUDA tensor in the launch ``the_plan`` (the
    card's checks run every cluster size); one the card cannot place
    raises."""
    nb, m, _ = c.shape
    c = c.contiguous()
    trail = c.new_empty((nb, m - bk, m - bk))
    vt = c.new_empty((nb, bk, m))
    wt = c.new_empty((nb, bk, m))
    taus, dd, ee = (c.new_empty((nb, bk)) for _ in range(3))
    if nb:
        _launch(c, trail, vt, wt, taus, dd, ee, the_plan)
    return trail, mt(vt), mt(wt), taus, dd, ee


def card_plan(nb: int, m: int, bk: int, dtype: torch.dtype, device):
    """:func:`plan` with the clusters that the card of ``device`` holds at
    once (needs the card): the launch :func:`sytrd_panel` makes."""
    return plan(nb, m, bk, dtype, resident=_resident(m, bk, dtype, device))


def _resident(m: int, bk: int, dtype: torch.dtype, device) -> tuple:
    """(C, clusters the card holds at once) for each placeable C."""
    return _resident_on(m, bk, dtype, device.index if device.index is not None
                        else torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _resident_on(m: int, bk: int, dtype: torch.dtype, index: int) -> tuple:
    with torch.cuda.device(index):
        return tuple((c, resident_clusters(launch_on(m, bk, dtype, c), dtype))
                     for c in placeable_sizes(m, bk, dtype))
