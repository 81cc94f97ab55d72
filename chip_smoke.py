#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nd4js_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each announced by a flushed line at its start and its end:

0. device and toolchain: card, power limit, nvcc, torch;
1. build: every kernel of the package with one nvcc call, with ptxas's
   registers and shared memory per kernel;
2. each kernel against its plain PyTorch version on the card, float32 and
   float64, at the shapes the main path gives it;
3. the main path through the public entry points, each path with the
   launch counters set to 0 just before it and read just after:
   ``entry.forward`` at the shapes of ``__graft_entry__.entry()``,
   ``qr_decomp`` + ``qr_lstsq`` on the (32, 512, 512) float32 batch of
   bench.py's 512² suite, ``qr_lstsq_fused`` on bench.py's config 1
   (256², 4 right-hand sides), config 2 (``lu_solve_fused``,
   ``cholesky_decomp(inv=True)`` and ``cholesky_solve`` on 1024 SPD
   systems of 128²), and the suite's ``lu_decomp``, ``cholesky_decomp``
   and ``qr_decomp(method="auto")`` entries, each held to bench.py's
   gates;
4. times with CUDA events: each kernel, its plain version, one PyTorch
   library call that computes the same function, and the bound; and the
   wall time of each bench.py entry above.

The second-to-last line is a JSON ``{"kernels": [...]}`` object and the
last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line; so does a machine without a CUDA card, and a
phase still running after 900 s.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

import nd4js_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
from nd4js_tpu_torch import la
from nd4js_tpu_torch.entry import entry
from nd4js_tpu_torch.la import qr as qr_mod
from nd4js_tpu_torch.ops import _build, chol_leaf as cl, house_panel as hp, \
    house_stripe as hs, lu_panel as lp

DEADLINE_S = 900
DEVICE = "cuda"
SEED = 20261017
# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): float32 outside the tensor cores, and HBM bandwidth.
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12
# kernel against plain version: the two sum in different orders
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# a solve's backward error against its reference's: two Householder solves
# that round differently stay within 1.4x of each other on random systems
BACKWARD_MULT = 8
KERNELS = ("house_panel", "qr_gesv", "chol_leaf", "lu_panel", "lu_gesv")

_T0 = time.perf_counter()
_phase = "start"


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", flush=True)


@contextlib.contextmanager
def phase(name: str):
    global _phase
    _phase = name
    say(f"phase {name}: start")
    yield
    torch.cuda.synchronize()
    say(f"phase {name}: end")


def _on_deadline(signum, frame):
    print(f"chip_smoke: FAILED, deadline of {DEADLINE_S} s passed in phase "
          f"{_phase!r}", flush=True)
    os._exit(1)


def check(ok: bool, what: str) -> None:
    say(("ok   " if ok else "FAIL ") + what)
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED in phase {_phase!r}: {what}")


def run_tool(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """Least time (ms) the card could take: the larger of operations over
    the float32 peak and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def maxabs(t) -> float:
    return float(t.abs().max())


def solve_check(what: str, a, y, x, x_ref, dtype) -> float:
    """Hold the solutions x of square systems to their reference x_ref,
    per system, and return max |x - x_ref|.

    The backward error ‖A·x − y‖₂/(‖A‖₂·‖x‖₂) (worst right-hand side) does
    not depend on κ(A): it must be at most N·eps and at most BACKWARD_MULT
    times the reference's (floored at eps). x itself must lie within
    TOL·max|A| of x_ref, or within the forward-error estimate
    N·eps·κ₂(A)·max|x| where that is larger: two backward-stable solves
    that round differently disagree in x by up to κ(A) times their
    backward error. The worst system's κ is printed, and how many systems
    the fixed TOL·max|A| held.
    """
    a64, y64 = a.double().cpu().numpy(), y.double().cpu().numpy()
    x64, xr64 = x.double().cpu().numpy(), x_ref.double().cpu().numpy()
    n = a64.shape[-1]
    eps = torch.finfo(dtype).eps
    sv = np.linalg.svd(a64, compute_uv=False)
    kappa = sv[:, 0] / sv[:, -1]

    def backward(xs):
        res = np.linalg.norm(a64 @ xs - y64, axis=-2)
        return (res / (sv[:, :1] * np.linalg.norm(xs, axis=-2))).max(-1)

    be, be_ref = backward(x64), backward(xr64)
    be_tol = np.minimum(n * eps, BACKWARD_MULT * np.maximum(be_ref, eps))
    w = int(np.argmax(be / be_tol))
    check(bool((be <= be_tol).all()),
          f"{what}: backward error, worst system {w}: {be[w]:.3e} <= "
          f"{be_tol[w]:.3e} (reference {be_ref[w]:.3e}, N·eps "
          f"{n * eps:.3e}, κ₂ {kappa[w]:.3e})")
    err = np.abs(x64 - xr64).max(axis=(-2, -1))
    fixed = TOL[dtype] * np.abs(a64).max(axis=(-2, -1))
    tol = np.maximum(fixed, n * eps * kappa * np.abs(xr64).max(axis=(-2, -1)))
    w = int(np.argmax(err / tol))
    check(bool((err <= tol).all()),
          f"{what}: max |x - reference| = {err.max():.3e}; worst system {w}: "
          f"{err[w]:.3e} <= {tol[w]:.3e} (κ₂ {kappa[w]:.3e}); the fixed "
          f"{TOL[dtype]:.0e}·max|A| holds on {int((err <= fixed).sum())} of "
          f"{len(err)} systems")
    return float(err.max())


def phase0():
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED, no CUDA device: the port's kernels run "
              "only on the card", file=sys.stderr, flush=True)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    say(f"device: {name}, count {count}")
    print(smi, flush=True)
    say("nvcc: " + run_tool([_build._nvcc(), "--version"]).splitlines()[-1])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name, count


def phase1():
    path, seconds, log = _build.build()
    _build.library()
    say(f"one nvcc call built {path.name} in {seconds:.2f} s")
    for line in log.splitlines():
        if "ptxas info" in line and ("Compiling" in line or "Used" in line) \
                or "spill" in line:
            say("  " + line.strip())


def phase2_qr(rng, errs):
    for dtype in (torch.float32, torch.float64):
        for shape in ((32, 512, 128), (32, 384, 128), (32, 256, 128),
                      (32, 128, 128), (4, 128, 128)):
            a = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
            got = hp.house_panel(a)
            want = hp.house_panel_ref(a)
            err = max(maxabs(g - w) for g, w in zip(got, want))
            tol = TOL[dtype] * maxabs(a)
            if dtype == torch.float32:
                errs["house_panel"] = max(errs["house_panel"], err)
            check(err <= tol, f"house_panel {shape} {dtype}: max |kernel - "
                  f"plain| over R, V, taus = {err:.3e} <= {tol:.3e}")
        # the last batch is shifted by 3·√N·I: κ₂ ≈ 3, so there the fixed
        # tolerance on x holds for every system
        for nb, n, k, shift in ((1, 256, 4, 0), (64, 128, 1, 0),
                                (64, 128, 1, 3)):
            a = torch.from_numpy(rng.standard_normal((nb, n, n))
                                 + shift * n ** 0.5 * np.eye(n)).to(DEVICE,
                                                                     dtype)
            y = torch.from_numpy(rng.standard_normal((nb, n, k))).to(DEVICE,
                                                                      dtype)
            err = solve_check(f"qr_gesv ({nb}, {n}, {n}) K={k} shift {shift} "
                              f"{dtype}, kernel against plain", a, y,
                              hs.qr_gesv(a, y), hs.qr_gesv_ref(a, y), dtype)
            if dtype == torch.float32:
                errs["qr_gesv"] = max(errs["qr_gesv"], err)


def spd_garbage_above(rng, nb, n):
    """a·aᵀ/n + 2I from a seeded normal (bench.py's config 2 recipe), as
    float64 on the card, with the strict upper triangle overwritten by
    normal values times 1e3, which a kernel that reads only the lower
    triangle never sees."""
    a = torch.from_numpy(rng.standard_normal((nb, n, n))).to(DEVICE)
    spd = torch.matmul(a, a.mT) / n + 2 * torch.eye(n, device=DEVICE,
                                                    dtype=a.dtype)
    junk = torch.from_numpy(rng.standard_normal((nb, n, n))).to(DEVICE)
    return torch.tril(spd) + torch.triu(junk * 1e3, 1)


def phase2_chol(rng, errs):
    for dtype in (torch.float32, torch.float64):
        for nb in (1024, 32):
            a = spd_garbage_above(rng, nb, 64).to(dtype)
            amax = maxabs(torch.tril(a))
            for with_inv in (False, True):
                l, li = cl.chol_leaf(a, with_inv)
                l_ref, li_ref = cl.chol_leaf_ref(a, with_inv)
                err = maxabs(l - l_ref)
                tol = TOL[dtype] * amax
                check(err <= tol and maxabs(torch.triu(l, 1)) == 0.0,
                      f"chol_leaf ({nb}, 64, 64) {dtype} inv={with_inv}, "
                      f"upper triangle garbage: max |L - plain| = "
                      f"{err:.3e} <= {tol:.3e}, zeros above")
                if with_inv:
                    ierr = maxabs(li - li_ref)
                    itol = TOL[dtype] * maxabs(li_ref)
                    check(ierr <= itol, f"chol_leaf ({nb}, 64, 64) {dtype}: "
                          f"max |L⁻¹ - plain| = {ierr:.3e} <= {itol:.3e}")
                    err = max(err, ierr)
                if dtype == torch.float32:
                    errs["chol_leaf"] = max(errs["chol_leaf"], err)


def packed_lu_residual(a, out, rank) -> float:
    """max |L·U − A[P]| of a factored panel (rows in input order) after
    sorting rows by (rank, index), in float64."""
    nb, m, b = a.shape
    iota = torch.arange(m, device=a.device)
    order = torch.argsort(rank.long() * m + iota, dim=1)
    idx = order[:, :, None].expand(nb, m, b)
    packed = torch.gather(out, 1, idx).double()
    L = torch.tril(packed, -1) + torch.eye(m, b, device=a.device,
                                           dtype=torch.float64)
    U = torch.triu(packed[:, :b])
    return maxabs(torch.matmul(L, U) - torch.gather(a, 1, idx).double())


def phase2_lu(rng, errs):
    for dtype in (torch.float32, torch.float64):
        for m in (512, 384, 256, 128):
            a = torch.from_numpy(rng.standard_normal((32, m, 128))).to(
                DEVICE, dtype)
            out, rank = lp.lu_panel(a)
            out_ref, rank_ref = lp.lu_panel_ref(a)
            amax = maxabs(a)
            ndiff = int((rank != rank_ref).sum())
            what = f"lu_panel (32, {m}, 128) {dtype}"
            if dtype == torch.float64:
                check(ndiff == 0, f"{what}: rank equal to the plain version's")
            else:
                say(f"{what}: {ndiff} rank entries differ from the plain "
                    "version's (expected 0)")
            if ndiff == 0:
                err = maxabs(out - out_ref)
                tol = TOL[dtype] * amax
                check(err <= tol, f"{what}: max |panel - plain| = {err:.3e} "
                      f"<= {tol:.3e}")
                if dtype == torch.float32:
                    errs["lu_panel"] = max(errs["lu_panel"], err)
            tol = 1e-5 * amax * m ** 0.5
            for who, o, r in (("kernel", out, rank), ("plain", out_ref,
                                                      rank_ref)):
                res = packed_lu_residual(a, o, r)
                check(res <= tol, f"{what}, {who}: packed max |L·U - A[P]| = "
                      f"{res:.3e} <= {tol:.3e}")
        for nb, k in ((1024, 1), (64, 4)):
            a = torch.from_numpy(rng.standard_normal((nb, 128, 128))).to(
                DEVICE, dtype)
            y = torch.from_numpy(rng.standard_normal((nb, 128, k))).to(
                DEVICE, dtype)
            err = solve_check(f"lu_gesv ({nb}, 128, 128) K={k} {dtype}, "
                              "kernel against plain", a, y, lp.lu_gesv(a, y),
                              lp.lu_gesv_ref(a, y), dtype)
            if dtype == torch.float32:
                errs["lu_gesv"] = max(errs["lu_gesv"], err)
    x = lp.lu_gesv(torch.ones((1, 8, 8), device=DEVICE),
                   torch.ones((1, 8, 1), device=DEVICE))
    check(not bool(torch.isfinite(x).all()),
          "lu_gesv on an exactly singular system: x is not finite")


def phase2(rng):
    errs = dict.fromkeys(KERNELS, 0.0)
    phase2_qr(rng, errs)
    phase2_chol(rng, errs)
    phase2_lu(rng, errs)
    return errs


def square_solve_gate(a, x, y, what, where="bench.py:362"):
    n = a.shape[-1]
    resid = maxabs(torch.matmul(a, x) - y)
    tol = 1e-4 * maxabs(a) * n ** 0.5
    check(resid <= tol, f"{what}: max |A·x - y| = {resid:.3e} <= {tol:.3e} "
          f"({where})")


def reset_counts() -> None:
    hp.launches = hs.launches = cl.launches = 0
    lp.launches.update(lu_panel=0, lu_gesv=0)
    qr_mod.auto_branches.update(cholqr2=0, householder=0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {"house_panel": hp.launches, "qr_gesv": hs.launches,
            "chol_leaf": cl.launches, "lu_panel": lp.launches["lu_panel"],
            "lu_gesv": lp.launches["lu_gesv"]}


def check_counts(what: str, got: dict, want: dict, totals: dict) -> None:
    """Each kernel in ``want`` launched exactly that often, the others not
    at all; add ``got`` to ``totals``."""
    full = dict.fromkeys(KERNELS, 0) | want
    check(got == full, f"{what}: launches {got}, expected {full}")
    for k, v in got.items():
        totals[k] += v


def phase3(gen):
    totals = dict.fromkeys(KERNELS, 0)

    reset_counts()
    forward, (a, y) = entry(device=DEVICE)
    x, resid = forward(a, y)
    check_counts("entry.forward", read_counts(), {"house_panel": 1}, totals)
    check(tuple(x.shape) == (4, 128, 1) and tuple(resid.shape) == (4,)
          and bool(torch.isfinite(x).all() and torch.isfinite(resid).all()),
          f"entry.forward: x {tuple(x.shape)}, resid {tuple(resid.shape)}, "
          "finite")
    square_solve_gate(a, x, y, "entry.forward (4, 128, 128)")
    x_ref = torch.from_numpy(np.linalg.solve(a.double().cpu().numpy(),
                                             y.double().cpu().numpy()))
    solve_check("entry.forward against a float64 solve on the host", a, y, x,
                x_ref, torch.float32)

    n, b = 512, 32
    a = torch.randn((b, n, n), generator=gen, dtype=torch.float32)
    a = a.to(DEVICE)
    y = torch.randn((b, n, 1), generator=gen, dtype=torch.float32).to(DEVICE)
    reset_counts()
    q, r = la.qr_decomp(a)
    x = la.qr_lstsq(q, r, y)
    check_counts("qr_decomp + qr_lstsq (32, 512, 512)", read_counts(),
                 {"house_panel": n // 128}, totals)
    amax = maxabs(a)
    recon = maxabs(torch.matmul(q, r) - a)
    tol = 1e-5 * amax * n ** 0.5
    check(recon <= tol, f"qr_decomp: max |Q·R - A| = {recon:.3e} <= "
          f"{tol:.3e} (bench.py:294)")
    eye = torch.eye(n, device=DEVICE)
    orth = maxabs(torch.matmul(q.mT, q) - eye)
    otol = 4 * torch.finfo(torch.float32).eps * n
    check(orth <= otol, f"qr_decomp: max |QᵀQ - I| = {orth:.3e} <= "
          f"{otol:.3e}")
    square_solve_gate(a, x, y, "qr_lstsq (32, 512, 512)")

    n1 = 256
    a1 = torch.randn((n1, n1), generator=gen, dtype=torch.float32).to(DEVICE)
    y1 = torch.randn((n1, 4), generator=gen, dtype=torch.float32).to(DEVICE)
    reset_counts()
    x1 = la.qr_lstsq_fused(a1, y1)
    check_counts("qr_lstsq_fused (256, 256)", read_counts(), {"qr_gesv": 1},
                 totals)
    square_solve_gate(a1, x1, y1, "qr_lstsq_fused (256, 256), K=4")

    cfg2 = config2_inputs(gen)
    reset_counts()
    xl, xc = config2(*cfg2)
    check_counts("config 2 (1024, 128, 128)", read_counts(),
                 {"lu_gesv": 1, "chol_leaf": 2}, totals)
    spd2, y2 = cfg2
    for what, xs in (("lu_solve_fused", xl), ("cholesky_solve(l_inv=…)", xc)):
        square_solve_gate(spd2, xs, y2, f"config 2 {what} (1024, 128, 128)",
                          "bench.py:392")

    reset_counts()
    lu, p = la.lu_decomp(a)
    check_counts("lu_decomp (32, 512, 512)", read_counts(),
                 {"lu_panel": n // 128}, totals)
    L = torch.tril(lu, -1) + torch.eye(n, device=DEVICE)
    ap = torch.gather(a, 1, p.long()[..., None].expand(a.shape))
    recon = maxabs(torch.matmul(L, torch.triu(lu)) - ap)
    check(recon <= tol, f"lu_decomp: max |L·U - A[P]| = {recon:.3e} <= "
          f"{tol:.3e} (bench.py:302)")

    spd = torch.matmul(a, a.mT) / n + 2 * torch.eye(n, device=DEVICE)
    reset_counts()
    L = la.cholesky_decomp(spd)
    check_counts("cholesky_decomp (32, 512, 512)", read_counts(),
                 {"chol_leaf": 8}, totals)
    recon = maxabs(torch.matmul(L, L.mT) - spd)
    ctol = 1e-5 * maxabs(spd) * n ** 0.5
    check(recon <= ctol, f"cholesky_decomp: max |L·Lᵀ - A| = {recon:.3e} <= "
          f"{ctol:.3e} (bench.py:310)")

    reset_counts()
    q, r = la.qr_decomp(a, method="auto")
    counts = read_counts()
    branch = "householder" if qr_mod.auto_branches["householder"] else \
        "cholqr2"
    say(f"qr_decomp(method='auto') (32, 512, 512) took the {branch} branch "
        f"({qr_mod.auto_branches})")
    check_counts("qr_decomp(method='auto') (32, 512, 512)", counts,
                 {"chol_leaf": 16} | ({"house_panel": n // 128}
                                      if branch == "householder" else {}),
                 totals)
    recon = maxabs(torch.matmul(q, r) - a)
    check(recon <= tol, f"qr_decomp(method='auto'): max |Q·R - A| = "
          f"{recon:.3e} <= {tol:.3e} (bench.py:294)")
    orth = maxabs(torch.matmul(q.mT, q) - eye)
    check(orth <= otol, f"qr_decomp(method='auto'): max |QᵀQ - I| = "
          f"{orth:.3e} <= {otol:.3e}")
    # why auto chose as it did: CholeskyQR2's defect per matrix, against
    # the contract, beside each matrix's condition number. Its Q·R = A
    # holds at any κ, so its result is gated here too, whichever branch
    # auto kept.
    qf, rf = qr_mod._qr_cholqr2_flat(a, True)
    recon = maxabs(torch.matmul(qf, rf) - a)
    check(recon <= tol, f"CholeskyQR2 (32, 512, 512): max |Q·R - A| = "
          f"{recon:.3e} <= {tol:.3e} (bench.py:294)")
    defect = (torch.matmul(qf.mT, qf) - eye).abs().amax(dim=(-2, -1)).cpu()
    sv = np.linalg.svd(a.double().cpu().numpy(), compute_uv=False)
    kappa = sv[:, 0] / sv[:, -1]
    w = int(defect.argmax())
    say(f"CholeskyQR2 on the same batch: max |QᵀQ - I| per matrix, worst "
        f"{float(defect[w]):.3e} (matrix {w}, κ₂ {kappa[w]:.3e}), "
        f"{int((defect > otol).sum())} of {len(defect)} over {otol:.3e}; "
        f"κ₂ of the batch from {kappa.min():.3e} to {kappa.max():.3e}, "
        f"{int((kappa > torch.finfo(torch.float32).eps ** -0.5).sum())} "
        "over 1/√eps")

    say(f"launches on the main path: {totals}")
    check(all(c > 0 for c in totals.values()),
          "every kernel of the path was launched")
    return totals, (a, y), (a1, y1), cfg2, spd


def config2_inputs(gen):
    """bench.py's config 2 (bench.py:369-395): SPD = a·aᵀ/N + 2I from a
    seeded normal (1024, 128, 128) and y (1024, 128, 1), float32."""
    n, b = 128, 1024
    a = torch.randn((b, n, n), generator=gen, dtype=torch.float32).to(DEVICE)
    spd = torch.matmul(a, a.mT) / n + 2 * torch.eye(n, device=DEVICE)
    y = torch.randn((b, n, 1), generator=gen, dtype=torch.float32).to(DEVICE)
    return spd, y


def config2(spd, y):
    xl = la.lu_solve_fused(spd, y)
    L, Li = la.cholesky_decomp(spd, inv=True)
    return xl, la.cholesky_solve(L, y, l_inv=Li)


def wall_ms(fn):
    """Host-clock milliseconds of ``fn`` to a synchronised end, three
    times after one warm-up call."""
    fn()
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase4(counts, errs, batch, cfg1, cfg2, spd512):
    a, _ = batch
    a1, y1 = cfg1
    spd2, y2 = cfg2
    panel = a[:, :, :128].contiguous()
    nb, m, bw = panel.shape
    hp_flops = nb * (2 * m * bw ** 2 - 2 / 3 * bw ** 3)
    hp_bytes = 4 * (3 * nb * m * bw + nb * bw)
    a3, y3 = a1[None].contiguous(), y1[None].contiguous()
    n, k = a1.shape[-1], y1.shape[-1]
    gs_flops = 4 / 3 * n ** 3 + 3 * n ** 2 * k
    gs_bytes = 4 * (n * n + 2 * n * k)
    # chol_leaf: config 2's first leaf, with the inverse, as the path runs it
    leaf = spd2[:, :64, :64].contiguous()
    lb, ln = leaf.shape[0], leaf.shape[-1]
    eye_leaf = torch.eye(ln, device=DEVICE).expand(lb, ln, ln)
    cl_flops = lb * 2 / 3 * ln ** 3            # factor n³/3 + inverse n³/3
    # only A's lower triangle is read; L and L⁻¹ are written dense
    cl_bytes = 4 * lb * (ln * (ln + 1) // 2 + 2 * ln * ln)
    lp_flops = nb * (m * bw ** 2 - bw ** 3 / 3)
    lp_bytes = nb * (4 * 2 * m * bw + 4 * m)   # panel in and out, rank
    gb, gn = spd2.shape[0], spd2.shape[-1]
    gk = y2.shape[-1]
    lg_flops = gb * (2 / 3 * gn ** 3 + 2 * gn ** 2 * gk)
    lg_bytes = 4 * gb * (gn * (gn + gk) + gn * gk)
    rows = []
    for name, src, repl, kern, plain, lib, flops, nbytes, shape in (
            ("house_panel", "nd4js_tpu_torch/csrc/house_panel.cu",
             "nd4js_tpu/ops/house_panel.py:71",
             lambda: hp.house_panel(panel), lambda: hp.house_panel_ref(panel),
             lambda: torch.geqrf(panel), hp_flops, hp_bytes,
             list(panel.shape)),
            ("qr_gesv", "nd4js_tpu_torch/csrc/qr_gesv.cu",
             "nd4js_tpu/ops/house_stripe.py:206",
             lambda: hs.qr_gesv(a3, y3), lambda: hs.qr_gesv_ref(a3, y3),
             lambda: torch.linalg.solve(a3, y3), gs_flops, gs_bytes,
             list(a3.shape) + [k]),
            ("chol_leaf", "nd4js_tpu_torch/csrc/chol_leaf.cu",
             "nd4js_tpu/ops/chol_leaf.py:104",
             lambda: cl.chol_leaf(leaf, True),
             lambda: cl.chol_leaf_ref(leaf, True),
             lambda: torch.linalg.solve_triangular(
                 torch.linalg.cholesky(leaf), eye_leaf, upper=False),
             cl_flops, cl_bytes, list(leaf.shape)),
            ("lu_panel", "nd4js_tpu_torch/csrc/lu_panel.cu",
             "nd4js_tpu/ops/lu_panel.py:337",
             lambda: lp.lu_panel(panel), lambda: lp.lu_panel_ref(panel),
             lambda: torch.linalg.lu_factor(panel), lp_flops, lp_bytes,
             list(panel.shape)),
            ("lu_gesv", "nd4js_tpu_torch/csrc/lu_panel.cu",
             "nd4js_tpu/ops/lu_panel.py:274",
             lambda: lp.lu_gesv(spd2, y2), lambda: lp.lu_gesv_ref(spd2, y2),
             lambda: torch.linalg.solve(spd2, y2), lg_flops, lg_bytes,
             list(spd2.shape) + [gk])):
        t_bound, by = bound(flops, nbytes)
        row = {"name": name, "route": "cuda", "source": src, "replaces": repl,
               "launches": counts[name], "max_abs_err": errs[name],
               "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 3),
               "bound_ms": t_bound, "bound_by": by,
               "library_ms": cuda_ms(lib, 10), "shape": shape,
               "dtype": "float32"}
        say(f"{name} {shape}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {t_bound:.5f} ms ({by})")
        rows.append(row)

    a, y = batch

    def headline():
        q, r = la.qr_decomp(a)
        return la.qr_lstsq(q, r, y)

    wall = {"qr_decomp + qr_lstsq": wall_ms(headline),
            "config 2": wall_ms(lambda: config2(spd2, y2)),
            "lu_decomp": wall_ms(lambda: la.lu_decomp(a)),
            "cholesky_decomp": wall_ms(lambda: la.cholesky_decomp(spd512)),
            "qr_decomp(method='auto')":
                wall_ms(lambda: la.qr_decomp(a, method="auto"))}
    # where the headline's time goes: its four house_panel launches, one
    # per panel shape, against the whole call on the device
    panels = [cuda_ms(lambda p=a[:, k:, k:k + 128].contiguous():
                      hp.house_panel(p), 5) for k in range(0, 512, 128)]
    say("house_panel on the headline's panels (32, 512|384|256|128, 128) "
        "ms: " + ", ".join(f"{t:.4f}" for t in panels)
        + f"; sum {sum(panels):.4f}; whole call on the device "
        f"{cuda_ms(headline, 3):.4f}")
    # the same for the 512² lu_decomp's four lu_panel launches
    lpanels = [cuda_ms(lambda p=a[:, k:, k:k + 128].contiguous():
                       lp.lu_panel(p), 5) for k in range(0, 512, 128)]
    say("lu_panel on lu_decomp's panel shapes (32, 512|384|256|128, 128) "
        "ms: " + ", ".join(f"{t:.4f}" for t in lpanels)
        + f"; sum {sum(lpanels):.4f}; whole lu_decomp on the device "
        f"{cuda_ms(lambda: la.lu_decomp(a), 3):.4f}")
    return rows, wall


def main():
    signal.signal(signal.SIGALRM, _on_deadline)
    signal.alarm(DEADLINE_S)
    # a backstop that needs no Python: a call blocked inside the CUDA
    # runtime never returns to the interpreter to run the handler above
    faulthandler.dump_traceback_later(DEADLINE_S + 30, exit=True)

    with phase("0 device and toolchain"):
        name, count = phase0()
    with phase("1 build"):
        phase1()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    with phase("2 kernels against their plain versions"):
        errs = phase2(rng)
    with phase("3 main path"):
        counts, batch, cfg1, cfg2, spd512 = phase3(gen)
    with phase("4 times"):
        rows, wall = phase4(counts, errs, batch, cfg1, cfg2, spd512)
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    for what, runs in wall.items():
        say(f"{what} float32 wall ms, {len(runs)} runs: "
            + ", ".join(f"{w:.3f}" for w in runs))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
