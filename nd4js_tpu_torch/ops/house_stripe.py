"""Stripe-WY Householder elimination: the CUDA kernels of
``csrc/house_stripe.cu`` over one body, ``csrc/house_stripe.cuh`` (the
port of ``nd4js_tpu/ops/house_stripe.py``), their plain PyTorch versions
over one body, ``_stripe_body_ref``, and a launch counter for each.

``house_stripe_t(panel)`` is a drop-in for ``ops.house_panel.house_panel``:
(Nb, M, B) → (R_panel, V, taus). ``qr_gesv(a, y)`` solves square systems
by the same elimination of [A | y] and a back substitution, in one launch.

Each matrix runs on one thread-block cluster, its columns spread over the
blocks in groups of 8 (``plan`` states the rule). In the shared regime the
columns stay in the cluster's shared memory; a system too large for a
cluster of 8 keeps them in global memory (the global regime), with the
stripe being factored and V of the last two stripes staged in shared
memory; one of more rows than a block can stage (about 2400 in float32,
1200 in float64) stages them in global memory too (``STAGED``).
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["gesv_plan", "house_stripe_t", "house_stripe_t_ref", "plan",
           "qr_gesv", "qr_gesv_ref", "regime", "smem_bytes", "stripe_plan"]

STRIPE = 8
CLUSTER_SIZES = (1, 2, 4, 8)
# The regimes of ``plan``, as the kernels take them: the columns in shared
# memory (True, 1), in global memory (False, 0), or in global memory with
# the stripe and V staged there too (STAGED)
STAGED = 2
# SMs of an H100 SXM
SMS = 132
# The cluster rule's two constants (``plan``), from timings on an H100
# (PERF.md §6): config 1's qr_gesv (1, 256, 256), K = 4, ran fastest
# on clusters of 8 in both types; and a launch ran slower once its blocks
# held more than about 256 threads an SM (house_stripe_t's (32, 512, 128)
# took 1.7× as long on clusters of 4 as of 2).
LARGEST_CLUSTER = 8
THREADS_PER_SM = 256

# Kernel launches since the last reset; only each wrapper's CUDA branch
# adds to it. ``launches`` counts qr_gesv's, ``stripe_launches``
# house_stripe_t's.
launches = 0
stripe_launches = 0


def _stripe_body_ref(buf: torch.Tensor, n_house: int) -> torch.Tensor:
    """Plain version of the elimination, in place on ``buf`` (Nb, M, C),
    step for step ``_house_stripe_body`` (``house_stripe.py:75-161``) in
    the natural layout: for each stripe of w = min(8, n_house − s0)
    columns, w reflector steps that touch only the stripe (R above the
    diagonal, β on it, the reflector's tail below), then T by the
    telescoped series and the columns right of the stripe updated by
    Qᵀ = I − V·Tᵀ·Vᵀ. Returns taus (Nb, n_house)."""
    nb, m, ncols = buf.shape
    taus = buf.new_zeros((nb, n_house))
    rows = torch.arange(m, device=buf.device)
    for s0 in range(0, n_house, STRIPE):
        w = min(STRIPE, n_house - s0)
        for jl in range(w):
            j = s0 + jl
            x = buf[:, :, j]
            x0 = x[:, j]
            sigma = (x[:, j + 1:] ** 2).sum(-1)
            nrm = torch.sqrt(x0 * x0 + sigma)
            beta = torch.where(x0 >= 0, -nrm, nrm)
            den = x0 - beta
            den = torch.where(den == 0, torch.ones_like(den), den)
            safe_beta = torch.where(beta == 0, torch.ones_like(beta), beta)
            tau = torch.where(nrm == 0, torch.zeros_like(beta),
                              (beta - x0) / safe_beta)
            v = torch.where(rows > j, x / den[:, None], torch.zeros_like(x))
            v[:, j] = 1
            right = buf[:, :, j + 1:s0 + w]
            wv = tau[:, None] * torch.matmul(v[:, None, :], right)[:, 0]
            right -= v[:, :, None] * wv[:, None, :]
            buf[:, j + 1:, j] = v[:, j + 1:]
            buf[:, j, j] = beta
            taus[:, j] = tau
        if s0 + w >= ncols:
            continue
        t = taus[:, s0:s0 + w]
        steps = s0 + torch.arange(w, device=buf.device)
        V = torch.where(rows[:, None] > steps, buf[:, :, s0:s0 + w], 0.0) \
            + (rows[:, None] == steps).to(buf.dtype)
        V = torch.where((t != 0)[:, None, :], V, 0.0)
        G = torch.matmul(V.mT, V)
        N = torch.triu(G, 1) * t[:, :, None]
        X = torch.eye(w, dtype=buf.dtype, device=buf.device) - N
        S = N
        span = 2
        while span < w:
            S = torch.matmul(S, S)
            X = X + torch.matmul(X, S)
            span *= 2
        T = X * t[:, None, :]
        rest = buf[:, :, s0 + w:]
        W1 = torch.matmul(V.mT, rest)
        rest -= torch.matmul(V, torch.matmul(T.mT, W1))
    return taus


def house_stripe_t_ref(panel: torch.Tensor):
    """Plain PyTorch version of the ``house_stripe_t`` kernel: the stripe
    body on a copy of the panel, unpacked as ``house_stripe.py:311-319``
    does (R on and above the diagonal, zeros below; V unit-diagonal, a
    column with τ = 0 keeping only its unit diagonal)."""
    nb, m, b = panel.shape
    out = panel.clone()
    taus = panel.new_zeros((nb, b))
    taus[:, :min(m, b)] = _stripe_body_ref(out, min(m, b))
    r3 = torch.arange(m, device=panel.device)[:, None]
    c3 = torch.arange(b, device=panel.device)[None, :]
    rpan = torch.where(r3 <= c3, out, 0.0)
    v = torch.where(r3 > c3, out, 0.0) + (r3 == c3).to(panel.dtype)
    v = torch.where((taus == 0)[:, None, :] & (r3 != c3), 0.0, v)
    return rpan, v, taus


def qr_gesv_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``qr_gesv`` kernel: the stripe body on
    [A | y], then back substitution R·x = Qᵀy."""
    n = a.shape[-1]
    buf = torch.cat([a, y], dim=-1)
    _stripe_body_ref(buf, n)
    z = buf[:, :, n:].clone()
    x = torch.empty_like(z)
    for j in range(n - 1, -1, -1):
        # a singular R yields inf/nan, as in the kernel
        x[:, j] = z[:, j] / buf[:, j, j, None]
        z[:, :j] -= buf[:, :j, j, None] * x[:, None, j]
    return x


def smem_bytes(m: int, ncols: int, n_house: int, ktail: int, cluster: int,
               shared: bool, dtype: torch.dtype) -> int:
    """Shared memory one block of a launch asks for in regime ``shared``,
    from ``smem_plan`` of ``csrc/house_stripe.cuh`` (so it needs the built
    kernel library)."""
    return _build.library().nd4js_house_stripe_smem(
        m, ncols, n_house, ktail, cluster, int(shared),
        torch.finfo(dtype).bits // 8)


@functools.lru_cache(maxsize=256)
def plan(nb: int, m: int, ncols: int, n_house: int, ktail: int,
         dtype: torch.dtype, sms: int = SMS):
    """(cluster size, shared) of a launch over ``nb`` matrices of ``m``
    rows and ``ncols`` columns (right-hand sides and padding included),
    ``n_house`` reflectors.

    The rule: the shared regime when some cluster of 1, 2, 4 or 8 blocks
    holds the columns in 227 KB a block; its size is the smallest that
    does, raised to the largest size up to LARGEST_CLUSTER that keeps the
    launch within THREADS_PER_SM threads an SM (nb·C·threads ≤ that·SMs)
    and gives no block fewer than one stripe. Else the global regime, with
    the cluster size of the same rule, and when one block cannot stage a
    stripe's rows, the global regime staged in global memory (STAGED).
    Raises ValueError when not even that fits (a back substitution of
    thousands of right-hand sides). The bytes come from
    :func:`smem_bytes`, so only a process that can build the kernels plans
    a launch.
    """
    nstripes = -(-n_house // STRIPE)
    threads = 128 if m <= 128 else (256 if m <= 256 else 512)
    free = 1
    for c in CLUSTER_SIZES:
        if c <= min(LARGEST_CLUSTER, nstripes) \
                and nb * c * threads <= THREADS_PER_SM * sms:
            free = c
    for shared in (True, False, STAGED):
        fits = [c for c in CLUSTER_SIZES
                if smem_bytes(m, ncols, n_house, ktail, c, shared, dtype)
                <= _build.SMEM_MAX]
        if fits:
            return max(fits[0], free), shared
    raise ValueError(f"house_stripe: {m} rows do not fit one block's shared "
                     f"memory even in the global regime staged in global "
                     f"memory ({dtype})")


def regime(cluster: int, shared: bool) -> str:
    where = {True: "shared memory", False: "global memory",
             STAGED: "global memory, staged there"}[shared]
    return f"{where}, cluster of {cluster}"


def _stage_elems(m: int) -> int:
    """Elements of one block's stage area in the scratch (STAGED), from
    ``stage_elems`` of ``csrc/house_stripe.cuh``: the stripe (8 columns of
    leading dimension m | 1), then V of two stripes."""
    return STRIPE * (m | 1) + 2 * STRIPE * m


def _scratch(nb: int, groups: int, m: int, cluster: int, shared,
             like: torch.Tensor) -> torch.Tensor:
    """Zeros (Nb, 8·groups, M) for the column-major scratch; in the STAGED
    regime the view of a buffer that also holds, after it, one stage area
    for each of the launch's Nb·cluster blocks."""
    cols = nb * groups * STRIPE * m
    extra = nb * cluster * _stage_elems(m) if shared == STAGED else 0
    return like.new_zeros(cols + extra)[:cols].view(nb, groups * STRIPE, m)


def gesv_plan(a: torch.Tensor, y: torch.Tensor):
    """``plan`` of ``qr_gesv(a, y)``: its stripes, zero columns up to the
    next multiple of 8, then the right-hand sides."""
    nb, n, _ = a.shape
    k = y.shape[-1]
    n8 = -(-n // STRIPE) * STRIPE
    return plan(nb, n, n8 + k, n, k, a.dtype, _sms(a.device))


def stripe_plan(panel: torch.Tensor):
    """``plan`` of ``house_stripe_t(panel)``."""
    nb, m, b = panel.shape
    return plan(nb, m, b, min(m, b), 0, panel.dtype, _sms(panel.device))


def _sms(device) -> int:
    if device.type != "cuda":
        return SMS
    return _sms_of(device.index if device.index is not None
                   else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gesv_scratch(a: torch.Tensor, y: torch.Tensor, cluster: int = 1,
                  shared=True) -> torch.Tensor:
    """[A | 0 | y | 0] column-major per matrix, (Nb, 8·groups, N): the
    right-hand sides start at a multiple of 8 (with the stage areas of
    :func:`_scratch` after it in the STAGED regime)."""
    nb, n, _ = a.shape
    k = y.shape[-1]
    n8 = -(-n // STRIPE) * STRIPE
    k8 = -(-k // STRIPE) * STRIPE
    work = _scratch(nb, (n8 + k8) // STRIPE, n, cluster, shared, a)
    work[:, :n] = a.mT
    work[:, n8:n8 + k] = y.mT
    return work


def _launch_gesv(work, x, k, cluster, shared, stages=3):
    """qr_gesv's kernel on the scratch of :func:`_gesv_scratch`, counted in
    ``launches``. ``stages`` 1 only eliminates and 2 only back-substitutes
    (an already-eliminated scratch), to time the two apart."""
    global launches
    nb, _, n = work.shape
    f64 = work.dtype == torch.float64
    _build.launch("nd4js_qr_gesv_f64" if f64 else "nd4js_qr_gesv_f32",
                  work.device, work, x, nb, n, k, cluster, int(shared),
                  stages)
    launches += 1


def qr_gesv(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve the square systems A·x = y, a (Nb, N, N), y (Nb, N, K) →
    x (Nb, N, K), elimination of [A | y] + back substitution in ONE launch,
    in the regime and cluster size of :func:`gesv_plan`.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`qr_gesv_ref`.
    """
    on_card = _build.check_operand(a, "qr_gesv", 3)
    _build.check_operand(y, "qr_gesv", 3)
    nb, n, n2 = a.shape
    if n != n2 or y.shape[:2] != (nb, n):
        raise ValueError(f"qr_gesv: needs a (Nb, N, N) and y (Nb, N, K), got "
                         f"{tuple(a.shape)} and {tuple(y.shape)}")
    if y.dtype != a.dtype or y.device != a.device:
        raise ValueError("qr_gesv: a and y must share dtype and device")
    if not on_card:
        return qr_gesv_ref(a, y)
    if nb == 0 or n == 0 or y.shape[-1] == 0:
        return a.new_empty(y.shape)
    return _qr_gesv_in(a, y, *gesv_plan(a, y))


def _qr_gesv_in(a: torch.Tensor, y: torch.Tensor, cluster: int,
                shared: bool) -> torch.Tensor:
    """:func:`qr_gesv` on CUDA tensors in the given regime and cluster size
    (the card's checks run every one); one that does not fit raises."""
    x = a.new_empty(y.shape)
    _launch_gesv(_gesv_scratch(a, y, cluster, shared), x, y.shape[-1],
                 cluster, shared)
    return x


def house_stripe_t(panel: torch.Tensor):
    """Householder-factor a batched panel (Nb, M, B) → (R_panel, V, taus)
    by stripe-WY elimination: a drop-in for ``house_panel``, in the regime
    and cluster size of :func:`stripe_plan`.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`house_stripe_t_ref`.
    """
    if not _build.check_operand(panel, "house_stripe_t", 3):
        return house_stripe_t_ref(panel)
    if 0 in panel.shape:
        nb, _, b = panel.shape
        return (panel.new_empty(panel.shape), panel.new_empty(panel.shape),
                panel.new_empty((nb, b)))
    return _house_stripe_t_in(panel, *stripe_plan(panel))


def _house_stripe_t_in(panel: torch.Tensor, cluster: int, shared: bool):
    """:func:`house_stripe_t` on a CUDA tensor in the given regime and
    cluster size (the card's checks run every one); one that does not fit
    raises."""
    global stripe_launches
    out = _stripe_panel(panel, cluster, shared, "house_stripe_t")
    stripe_launches += 1
    return out


def _stripe_panel(panel: torch.Tensor, cluster: int, shared: bool,
                  kernel: str, direct: bool | None = None):
    """The stripe body's panel kernel on a CUDA panel → (R_panel, V, taus),
    uncounted (``kernel`` names the wrapper, which counts). ``direct``
    (the default in the shared regime for a contiguous panel) has the
    slabs load the row-major panel itself; otherwise the kernel reads the
    column-major scratch of :func:`_panel_scratch`."""
    nb, m, b = panel.shape
    if direct is None:
        direct = shared == 1 and panel.is_contiguous()
    work = panel if direct else _panel_scratch(panel, cluster, shared)
    return _launch_panel(work, m, b, cluster, shared, kernel, direct)


def _panel_scratch(panel: torch.Tensor, cluster: int = 1,
                   shared=True) -> torch.Tensor:
    """The panel column-major per matrix, (Nb, 8·groups, M), zero columns up
    to the next multiple of 8: the layout the stripe body reads (with the
    stage areas of :func:`_scratch` after it in the STAGED regime)."""
    nb, m, b = panel.shape
    work = _scratch(nb, -(-b // STRIPE), m, cluster, shared, panel)
    work[:, :b] = panel.mT
    return work


def _launch_panel(work: torch.Tensor, m: int, b: int, cluster: int,
                  shared: bool, kernel: str, rowmajor: bool = False):
    """The stripe body's panel kernel on ``work``, the scratch of
    :func:`_panel_scratch` or (``rowmajor``, the shared regime) the
    contiguous panel itself → (R_panel, V, taus), row-major whatever the
    panel's strides. The shared regime leaves ``work`` as it was, the
    global regime eliminates in it."""
    nb = work.shape[0]
    r = work.new_empty((nb, m, b))
    v = work.new_empty((nb, m, b))
    taus = work.new_empty((nb, b))
    f64 = work.dtype == torch.float64
    _build.launch("nd4js_house_stripe_t_f64" if f64
                  else "nd4js_house_stripe_t_f32", work.device, work, r, v,
                  taus, nb, m, b, cluster, int(shared), int(rowmajor),
                  kernel=kernel)
    return r, v, taus
