"""Position steps of a Francis bulge train through one diagonal block: the
CUDA kernel ``csrc/bulge_chase.cu`` (the port of
``nd4js_tpu/ops/bulge_chase.py::bulge_chase_steps``), its plain PyTorch
version, and a launch counter.

At step t bulge i sits at absolute position k = k0 + t − 3i, block row
kb = t + 3(NB − 1) − 3i, and acts while lo ≤ k ≤ hi − 2. With ``seed`` a
bulge entering at k = lo takes its carry from the first column of
(B − s₁)(B − s₂)·e₁ of the current block; at k = hi − 2 its third
component is dropped. Each active bulge's 3-element reflector is applied
from both sides of B and from the right of the accumulated transform, and
its carry becomes the next bulge column B[kb+1..kb+3, kb] (the third
entry 0 once k + 3 ≥ hi).
"""
from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["bulge_chase_steps", "bulge_chase_steps_ref", "plan"]

# warps of one launch at most (csrc/bulge_chase.cu kMaxThreads / 32)
MAX_WARPS = 24
# row or column items an update warp's thread takes in one phase of a step,
# which sets how many update warps a slide gets (at most MAX_UPDATE)
UPDATE_ITEMS = 4
MAX_UPDATE = 16

# Kernel launches since the last reset; only bulge_chase_steps' CUDA branch
# adds to it, one per call (one call is one slide of ``sl`` steps).
launches = 0


@functools.lru_cache(maxsize=256)
def plan(W: int, NB: int, SL: int, dtype: torch.dtype):
    """Launch layout of one slide of ``SL`` steps of ``NB`` bulges through
    a (W, W) block: (ld, reflector warps, update warps, accumulator warps,
    V_acc in shared memory, shared-memory bytes).

    ld = W rounded up to an odd number, the leading dimension of B and
    V_acc in shared memory (a column of 32 rows then hits 32 banks). One
    reflector warp for each 32 bulges; one accumulator thread for each row
    of V_acc; update warps enough for one thread a column and, up to
    MAX_UPDATE and to the MAX_WARPS of the launch, for UPDATE_ITEMS items
    a thread and phase (NB·W items). B and the reflector log (SL·NB·4
    values) always sit in shared memory, V_acc too when all fit 227 KB,
    else it is updated in place in global memory.
    Raises ValueError where the kernel cannot run: sl + 3·NB > W, or B and
    the log over 227 KB (which also keeps the warps within MAX_WARPS).
    """
    if W < 4 or NB < 1 or SL < 0 or SL + 3 * NB > W:
        raise ValueError(f"bulge_chase_steps: needs W >= 4, NB >= 1 and "
                         f"0 <= sl <= W - 3·NB, got W={W}, NB={NB}, sl={SL}")
    elem = torch.finfo(dtype).bits // 8
    ld = W | 1
    nref = -(-NB // 32)
    nacc = -(-W // 32)
    nupd = max(nacc, min(MAX_UPDATE, -(-NB * W // (32 * UPDATE_ITEMS)),
                         MAX_WARPS - nref - nacc))
    core = elem * (W * ld + SL * NB * 4) + 16
    v_in_smem = core + elem * W * ld <= _build.SMEM_MAX
    smem = core + (elem * W * ld if v_in_smem else 0)
    if smem > _build.SMEM_MAX:
        raise ValueError(f"bulge_chase_steps: a ({W}, {W}) block with {NB} "
                         f"bulges over {SL} steps needs {smem} bytes of "
                         f"shared memory in {dtype}")
    return ld, nref, nupd, nacc, v_in_smem, smem


def bulge_chase_steps_ref(b, p, shifts, k0: int, lo: int, hi: int, sl: int,
                          seed: bool):
    """Plain PyTorch version of the kernel: ``bulge_chase_steps_xla``
    (``nd4js_tpu/ops/bulge_chase.py:157-233``), the masked rank-NB update
    a step. Returns (V_acc (W, W), P' (NB, 3))."""
    W = b.shape[-1]
    NB = p.shape[-2]
    OFF = 3 * (NB - 1)
    dev = b.device
    ii = torch.arange(NB, device=dev)
    rowW = torch.arange(W, device=dev)
    j3 = torch.arange(3, device=dev)
    trs, dets = shifts[:, 0], shifts[:, 1]
    v = torch.eye(W, dtype=b.dtype, device=dev)
    P = p.clone()
    for t in range(sl):
        k = k0 + t - 3 * ii
        kb = t + OFF - 3 * ii
        act = (k >= lo) & (k <= hi - 2)
        if seed:
            entering = k == lo
            kbc = torch.clamp(kb, 0, W - 3)
            b00, b01 = b[kbc, kbc], b[kbc, kbc + 1]
            b10, b11 = b[kbc + 1, kbc], b[kbc + 1, kbc + 1]
            b21 = b[kbc + 2, kbc + 1]
            ip0 = b00 * b00 + b01 * b10 - trs * b00 + dets
            ip1 = b10 * (b00 + b11 - trs)
            ip2 = b10 * b21
            P = torch.where(entering[:, None],
                            torch.stack([ip0, ip1, ip2], dim=1), P)
        p0, p1 = P[:, 0], P[:, 1]
        p2 = torch.where(k == hi - 2, 0.0, P[:, 2])
        sigma = p1 * p1 + p2 * p2
        nrm = torch.sqrt(p0 * p0 + sigma)
        beta = torch.where(p0 >= 0, -nrm, nrm)
        den = p0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v1 = torch.where(sigma == 0, 0.0, p1 / safe_den)
        v2 = torch.where(sigma == 0, 0.0, p2 / safe_den)
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(nrm == 0, 0.0, (beta - p0) / safe_beta)
        tau = torch.where(sigma == 0, 0.0, tau)
        tau = torch.where(act, tau, 0.0)
        vmat = torch.stack([torch.ones_like(v1), v1, v2], dim=1)
        rel = rowW[:, None] - kb[None, :]
        vblk = b.new_zeros((W, NB))
        for j in range(3):
            vblk = vblk + torch.where(rel == j, vmat[None, :, j], 0.0)
        tv = tau[None, :] * vblk
        b = b - vblk @ (tv.T @ b)
        b = b - (b @ tv) @ vblk.T
        v = v - (v @ tv) @ vblk.T
        # next bulge columns B[kb+1+j, kb]; JAX clamps a gather's index
        rows = torch.clamp(kb[:, None] + 1 + j3[None, :], max=W - 1)
        nxt = b[rows, kb[:, None].clamp(0, W - 1)]
        nxt = torch.where((k[:, None] + 3 < hi) | (j3[None, :] < 2), nxt, 0.0)
        P = torch.where(act[:, None], nxt, P)
    return v, P


def bulge_chase_steps(b, p, shifts, k0: int, lo: int, hi: int, sl: int,
                      seed: bool):
    """Run ``sl`` position steps of an NB-bulge Francis train on the (W, W)
    diagonal block ``b``.

    p: (NB, 3) bulge carries. shifts: (NB, 2), columns (tr, det) of each
    bulge's double-shift polynomial λ² − tr·λ + det. k0: absolute position
    of bulge 0 at step 0; lo/hi: the active range (host ints). Needs
    sl + 3·NB ≤ W. Returns (V_acc, p'): B' = V_accᵀ·B·V_acc and the
    carries after the last step.

    A CUDA tensor runs the kernel in the layout of :func:`plan` (or
    raises); a CPU tensor runs :func:`bulge_chase_steps_ref`.
    """
    global launches
    on_card = _build.check_operand(b, "bulge_chase_steps", 2)
    W = b.shape[-1]
    NB = p.shape[-2]
    if b.shape[0] != W or tuple(p.shape) != (NB, 3) \
            or tuple(shifts.shape) != (NB, 2) or sl < 0 or sl + 3 * NB > W:
        raise ValueError(f"bulge_chase_steps: needs b (W, W), p (NB, 3), "
                         f"shifts (NB, 2) and sl + 3·NB <= W, got "
                         f"{tuple(b.shape)}, {tuple(p.shape)}, "
                         f"{tuple(shifts.shape)}, sl={sl}")
    if not on_card:
        return bulge_chase_steps_ref(b, p, shifts, k0, lo, hi, sl, seed)
    ld, nref, nupd, nacc, v_in_smem, smem = plan(W, NB, sl, b.dtype)
    b = b.contiguous()
    p = p.to(b.dtype).contiguous()
    shifts = shifts.to(b.dtype).contiguous()
    v = torch.empty_like(b)
    po = torch.empty_like(p)
    f64 = b.dtype == torch.float64
    _build.launch("nd4js_bulge_chase_f64" if f64 else "nd4js_bulge_chase_f32",
                  b.device, b, p, shifts, v, po, W, NB, sl, int(k0), int(lo),
                  int(hi), int(seed), ld, nref, nupd, nacc, int(v_in_smem),
                  smem)
    launches += 1
    return v, po
