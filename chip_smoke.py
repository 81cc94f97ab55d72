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
3. the main path through the public entry points, with the launch
   counters set to 0 just before and read just after: ``entry.forward``
   at the shapes of ``__graft_entry__.entry()``, ``qr_decomp`` +
   ``qr_lstsq`` on the (32, 512, 512) float32 batch of bench.py's 512²
   suite, and ``qr_lstsq_fused`` on bench.py's config 1 (256², 4
   right-hand sides), each held to bench.py's gates;
4. times with CUDA events: each kernel, its plain version, one PyTorch
   library call that computes the same function, and the bound.

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
from nd4js_tpu_torch.ops import _build, house_panel as hp, house_stripe as hs

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


def phase2(rng):
    errs = {"house_panel": 0.0, "qr_gesv": 0.0}
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
    return errs


def square_solve_gate(a, x, y, what):
    n = a.shape[-1]
    resid = maxabs(torch.matmul(a, x) - y)
    tol = 1e-4 * maxabs(a) * n ** 0.5
    check(resid <= tol, f"{what}: max |A·x - y| = {resid:.3e} <= {tol:.3e} "
          "(bench.py:362)")


def phase3(gen):
    hp.launches = 0
    hs.launches = 0

    forward, (a, y) = entry(device=DEVICE)
    x, resid = forward(a, y)
    torch.cuda.synchronize()
    check(tuple(x.shape) == (4, 128, 1) and tuple(resid.shape) == (4,)
          and bool(torch.isfinite(x).all() and torch.isfinite(resid).all()),
          f"entry.forward: x {tuple(x.shape)}, resid {tuple(resid.shape)}, "
          "finite")
    square_solve_gate(a, x, y, "entry.forward (4, 128, 128)")
    x_ref = torch.from_numpy(np.linalg.solve(a.double().cpu().numpy(),
                                             y.double().cpu().numpy()))
    solve_check("entry.forward against a float64 solve on the host", a, y, x,
                x_ref, torch.float32)
    after_entry = hp.launches

    n, b = 512, 32
    a = torch.randn((b, n, n), generator=gen, dtype=torch.float32)
    a = a.to(DEVICE)
    y = torch.randn((b, n, 1), generator=gen, dtype=torch.float32).to(DEVICE)
    q, r = la.qr_decomp(a)
    x = la.qr_lstsq(q, r, y)
    torch.cuda.synchronize()
    check(hp.launches - after_entry == n // 128,
          f"qr_decomp (32, 512, 512): house_panel launched "
          f"{hp.launches - after_entry} times, K/128 = {n // 128}")
    amax = maxabs(a)
    recon = maxabs(torch.matmul(q, r) - a)
    tol = 1e-5 * amax * n ** 0.5
    check(recon <= tol, f"qr_decomp: max |Q·R - A| = {recon:.3e} <= "
          f"{tol:.3e} (bench.py:294)")
    eye = torch.eye(n, device=DEVICE)
    orth = maxabs(torch.matmul(q.mT, q) - eye)
    tol = 4 * torch.finfo(torch.float32).eps * n
    check(orth <= tol, f"qr_decomp: max |QᵀQ - I| = {orth:.3e} <= {tol:.3e}")
    square_solve_gate(a, x, y, "qr_lstsq (32, 512, 512)")

    n = 256
    a1 = torch.randn((n, n), generator=gen, dtype=torch.float32).to(DEVICE)
    y1 = torch.randn((n, 4), generator=gen, dtype=torch.float32).to(DEVICE)
    x1 = la.qr_lstsq_fused(a1, y1)
    torch.cuda.synchronize()
    check(hs.launches == 1,
          f"qr_lstsq_fused (256, 256): qr_gesv launched {hs.launches} time")
    square_solve_gate(a1, x1, y1, "qr_lstsq_fused (256, 256), K=4")

    counts = {"house_panel": hp.launches, "qr_gesv": hs.launches}
    say(f"launches on the main path: {counts}")
    check(all(c > 0 for c in counts.values()),
          "every kernel of the path was launched")
    return counts, (a, y), (a1, y1)


def phase4(counts, errs, batch, cfg1):
    a, _ = batch
    a1, y1 = cfg1
    panel = a[:, :, :128].contiguous()
    nb, m, bw = panel.shape
    hp_flops = nb * (2 * m * bw ** 2 - 2 / 3 * bw ** 3)
    hp_bytes = 4 * (3 * nb * m * bw + nb * bw)
    a3, y3 = a1[None].contiguous(), y1[None].contiguous()
    n, k = a1.shape[-1], y1.shape[-1]
    gs_flops = 4 / 3 * n ** 3 + 3 * n ** 2 * k
    gs_bytes = 4 * (n * n + 2 * n * k)
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
             list(a3.shape) + [k])):
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

    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        headline()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    # where the headline's time goes: its four house_panel launches, one
    # per panel shape, against the whole call on the device
    panels = [cuda_ms(lambda p=a[:, k:, k:k + 128].contiguous():
                      hp.house_panel(p), 5) for k in range(0, 512, 128)]
    say("house_panel on the headline's panels (32, 512|384|256|128, 128) "
        "ms: " + ", ".join(f"{t:.4f}" for t in panels)
        + f"; sum {sum(panels):.4f}; whole call on the device "
        f"{cuda_ms(headline, 3):.4f}")
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
        counts, batch, cfg1 = phase3(gen)
    with phase("4 times"):
        rows, wall = phase4(counts, errs, batch, cfg1)
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    say("qr_decomp + qr_lstsq (32, 512, 512) float32 wall ms, 3 runs: "
        + ", ".join(f"{w:.3f}" for w in wall))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
