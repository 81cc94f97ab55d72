#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nd4js_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each announced by a flushed line at its start and its end:

0. device and toolchain: card, power limit, nvcc, torch;
1. build: every kernel of the package with one nvcc call, with ptxas's
   registers and shared memory per kernel;
2. each kernel against its plain PyTorch version on the card, float32 and
   float64, at the shapes the main path gives it (chol_leaf at batches
   1024, 32 and 1 of 64², and at config 5's (4096, 1, 1) and (1, 4, 4),
   in each of its layouts, trevc_solve also with a small bignum on the
   plan's tiles and on tiles of 1 and 8, lu_panel also in every placement
   its plan can choose, with rank equal in both types, lu_gesv in every
   layout, and sytrd_panel's float64 (3, 100, 100) against a long double
   witness on the host);
3. the main path through the public entry points, each path with the
   launch counters set to 0 just before it and read just after:
   ``entry.forward`` at the shapes of ``__graft_entry__.entry()``,
   ``qr_decomp`` + ``qr_lstsq`` on the (32, 512, 512) float32 batch of
   bench.py's 512² suite, ``qr_lstsq_fused`` on bench.py's config 1
   (256², 4 right-hand sides), config 2 (``lu_solve_fused``,
   ``cholesky_decomp(inv=True)`` and ``cholesky_solve`` on 1024 SPD
   systems of 128²), the suite's ``lu_decomp``, ``cholesky_decomp``
   and ``qr_decomp(method="auto")`` entries, config 4's ``eigh`` of one
   1024² symmetric matrix, and ``eigh_tridiag_dc`` of the (32, 512, 512)
   Gram batch that the SVD's spectral preconditioner hands it; then the
   suite's ``svd_decomp`` (the 'gram' path), config 3's ``svd_decomp`` +
   ``svd_lstsq`` on rank-384 matrices by 'gram' and by one-sided Jacobi,
   ``lstsq`` of a (1024, 128, 64) batch (the Jacobi kernel's default
   regime), ``solve`` on config 2's systems, ``rrqr_decomp`` of the 512²
   batch and config 4's ``eigh(method="via_svd")``; then the rest of
   ``la``: ``svd_decomp`` by 'dc' and by 'blocked' on the 512² batch and
   on config 3 (the U completions that fire counted, so their
   ``house_panel`` launches checked), ``bidiag_decomp`` of config 3,
   ``ldl_decomp`` + ``ldl_solve`` on config 2's systems,
   ``pldlp_decomp`` + ``pldlp_solve`` on symmetric indefinite ones of the
   same shape, ``svd_jac_2sided`` and ``svd_jac_classic`` on (8, 96, 64),
   and ``RNG(seed).ortho`` and ``la.rand_ortho`` of (32, 512, 512), each
   printing its ``house_panel`` and ``chol_leaf`` launches; then config
   4's general ``eigen`` of one 1024² matrix, ``schur_decomp`` of its
   balanced form and ``eigen`` of a (256, 64, 64) batch; then config 5:
   ``opt.odr_lm`` of the 4096-point poly-4 fit (40 LM iterations, the
   structured solver, ``chol_leaf`` twice a structured solve) and
   ``opt.lbfgs_minimize`` of the 128-d Rosenbrock (no kernel), with the
   host reads an iteration; each held to bench.py's gates; every launch
   of those paths is logged (its shapes and arguments) beside the
   counters;
4. times with CUDA events: each distinct launch of the log, once, on the
   arguments it was first given, and so each kernel's device time over
   the main path (with each kernel's heaviest distinct launches: shapes,
   count, ms); each kernel, its plain version, one PyTorch
   library call that computes the same function where there is one, and
   the bound (for bulge_chase_steps and schur_small also ms a dependent
   step); and the wall time of each bench.py entry above, the eigh
   paths beside ``torch.linalg.eigh``, the SVD paths beside
   ``torch.linalg.svd`` and the eigen paths beside ``torch.linalg.eig``
   on the same input (yardsticks the port never calls), with host
   breakdowns of the headline and of config 4's eigen; chol_leaf also at
   the (32, 64, 64) and (1, 64, 64) leaves, through its wrapper and on the
   device alone (a CUDA graph), beside torch.linalg.cholesky and
   solve_triangular; sytrd_panel's
   column loop and trailing update apart, by cluster size; house_panel
   with and without the column-major scratch; lu_panel on lu_decomp's
   four panels in every placement (the plan's marked) and lu_gesv at
   config 2 in every layout; config 5's walls (the fit, the L-BFGS run)
   beside ``torch.optim.LBFGS`` on the same Rosenbrock, the rest of
   ``la``'s configurations beside ``torch.linalg.svd`` (the walls above)
   and ``torch.linalg.ldl_factor`` + ``ldl_solve``, their host
   breakdowns and host reads an iteration, the device's busy share under
   torch.profiler, and the device time of the fit's chol_leaf launches;
5. the rest of ``opt`` and ``utils``, each path with the counters reset
   before and read after and held to its gate, then three timed runs:
   ``opt.lbfgsb_minimize`` of config 5's 128-d Rosenbrock from −1s in the
   box [−2, 0.5]¹²⁸ (float32, memory 8, 500 iterations) against the
   port's float64 run, scipy's L-BFGS-B beside it as a witness, and with
   infinite bounds to f < 1e-4, printing the host reads an iteration and
   the aten ops of one Cauchy point (no kernel); ``opt.root_newton`` on a
   discretised Bratu problem (n = 512, dense J) in float64 and float32
   (``lu_panel`` 4 an iteration); ``opt.fit_lin`` of config 5's 4096
   points against 16 Chebyshev polynomials of x/2, regularised 0 and
   1e-3 (``house_panel`` 1, ``jacobi_sweeps`` one a sweep);
   ``utils.KDTree.nearest`` of 1024 queries among 262144 points in 8-d,
   k = 16; and ``utils.odeint_rk4`` of 4096 Lorenz systems over 1000
   steps, ``opt.num_grad``/``num_grad_forward`` of the 128-d Rosenbrock,
   ``opt.min1d_gss``, the three ``opt.root1d_*`` and
   ``opt.min_nelder_mead`` on the helical valley and Beale's function.
   Its launches are added to the kernels' counts;
6. the core surface, io and parallel, each path with the counters reset
   before and read after and held to its gate: ``core.kahan_sum`` (the
   kernel ``kahan_sum``) bit-equal to its plain version on the card at
   (4096, 4096) over axis 0 in both types, alone on (4096, 65536)
   float32 (1 GiB) within the Neumaier bound of a float64 sum, and
   ``axis=None`` of 2²⁰ float32 and ``kahan_dot`` of two 2²⁰ vectors
   within that bound of ``math.fsum`` on the host, with the kernel's,
   its plain version's and ``torch.sum``'s times; ``array``/``asarray``
   of the headline's numpy float64 batch, ``tabulate`` of the 4096²
   Hilbert matrix, ``zip_elems``, ``concat``/``stack``, ``reduce_elems``
   (``torch.add`` and a ``torch.logaddexp`` fold), ``slice_elems`` with
   negative steps and the ``NDArray`` wrapper, each against numpy;
   ``math``'s sixteen names on a card tensor; ``io``'s ``.npy``,
   ``istr`` and base64 round trips; ``parallel.batch_sharded`` of
   ``entry.forward`` over ``make_mesh()`` (NCCL, world size 1) against
   the unsharded call (``house_panel`` 4 each), and
   ``entry.dryrun_multichip(1)``; each timed path's median and spread
   over three runs. Its launches are added to the kernels' counts, and
   ``kahan_sum`` joins the kernels line.

The second-to-last line is a JSON ``{"kernels": [...]}`` object and the
last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line; so does a machine without a CUDA card, and a
phase still running after 900 s.
"""
from __future__ import annotations

import contextlib
import faulthandler
import importlib
import io as pyio
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import nd4js_tpu_torch as nd  # fails outside a checkout of the repo
from nd4js_tpu_torch import io as tio, la, math as ndmath, opt, parallel, \
    rand, utils
from nd4js_tpu_torch.core import host, kahan
from nd4js_tpu_torch.entry import dryrun_multichip, entry, \
    forward as entry_forward
from nd4js_tpu_torch.la import qr as qr_mod
from nd4js_tpu_torch.la import sytrd as sytrd_mod, tridiag_dc
from nd4js_tpu_torch.ops import _build, bulge_chase as bc, chol_leaf as cl, \
    house_panel as hp, house_stripe as hs, jacobi_sweep as js, \
    kahan_sum as ks, lu_panel as lp, rrqr_kernel as rk, schur_small as ss, \
    sytrd_panel as sp, trevc_solve as tv

# the modules, which la's functions of the same names shadow as attributes
eigh_mod = importlib.import_module("nd4js_tpu_torch.la.eigh")
svd_gram_mod = importlib.import_module("nd4js_tpu_torch.la.svd_gram")
svd_jac_mod = importlib.import_module("nd4js_tpu_torch.la.svd_jac")
rrqr_mod = importlib.import_module("nd4js_tpu_torch.la.rrqr")
schur_mod = importlib.import_module("nd4js_tpu_torch.la.schur")
eigen_mod = importlib.import_module("nd4js_tpu_torch.la.eigen")
odr_mod = importlib.import_module("nd4js_tpu_torch.opt.odr")
tls_mod = importlib.import_module("nd4js_tpu_torch.opt._trust_region_tls")
lbfgs_mod = importlib.import_module("nd4js_tpu_torch.opt.lbfgs")
svd_dc_mod = importlib.import_module("nd4js_tpu_torch.la.svd_dc")
svd_block_mod = importlib.import_module("nd4js_tpu_torch.la.svd_block_jac")
lbfgsb_mod = importlib.import_module("nd4js_tpu_torch.opt.lbfgsb")
lbfgsb_solver = importlib.import_module("nd4js_tpu_torch.opt._lbfgsb_solver")

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
KERNELS = ("house_panel", "qr_gesv", "house_stripe_t", "chol_leaf",
           "lu_panel", "lu_gesv", "sytrd_panel", "jacobi_sweeps",
           "rrqr_kernel", "schur_small", "bulge_chase_steps", "trevc_solve",
           "kahan_sum")
# house_panel's shapes: the headline's four panels, the entry's (4, 128,
# 128) and lstsq's pre-QR (1024, 128, 64)
HOUSE_SHAPES = ((32, 512, 128), (32, 384, 128), (32, 256, 128),
                (32, 128, 128), (4, 128, 128), (1024, 128, 64))
# house_stripe_t's shapes: the headline's four panels, a batch of 128²,
# B not a multiple of 8, and (one size per type) the global regime
STRIPE_SHAPES = ((32, 512, 128), (32, 384, 128), (32, 256, 128),
                 (32, 128, 128), (4, 128, 128), (2, 64, 17), (3, 96, 24))
STRIPE_GLOBAL = {torch.float32: (2, 2048, 128), torch.float64: (2, 1024, 128)}
# panels of more rows than one block can stage, which stage the stripe and
# V in global memory too: fit_lin's (4096, 16) of config 5's points, and
# one in float64
STRIPE_STAGED = {torch.float32: (1, 4096, 16), torch.float64: (2, 2048, 40)}
# a qr_gesv system too large for a cluster of 8 in either type
GESV_GLOBAL = (2, 768, 768, 2)
# sytrd_panel against its plain version: SYTRD_C·eps·m·max|C| on the
# trailing block, W, d and e, SYTRD_C·eps·m on V and taus (scale-free).
# The two sum in different orders. At the main path's shapes (64 of 512 or
# 1024 columns) the plain version in float32 is within about eps·m·max|C|
# of itself in float64 (tests/test_torch_sytrd.py), so two float32
# roundings differ by about twice that. Late in a reduction (bk close to
# m) the entries grow sensitive to rounding, by a factor that depends on
# the input; 32 covers the inputs here. Every panel is also held to its
# contract, which does not depend on that: H = Π(I − τ·v·vᵀ) orthogonal
# to BACKWARD_C·eps·m and Hᵀ·C·H equal to (d, e) beside the trailing block
# to BACKWARD_C·eps·m·max|C| (at most 0.15 of each on the CPU).
SYTRD_C = 32
BACKWARD_C = 2
# The float64 (3, 100, 100), bk = 63 panel, whose late columns move by
# several SYTRD_C tolerances with the order of summation: kernel and plain
# version (on the card, and on the host in the CPU's order) are each held
# to a witness in numpy's long double (64-bit significand), and the
# kernel's distance to it must stay within the larger of the tolerance and
# SYTRD_R times the larger of the two plain versions' distances on the
# same input. tools/sytrd_witness.py over 64 seeds: that ratio reached
# 2.28 where the kernel stood more than a tolerance away; the plain
# version on the host stood up to 2.65 times as far as on the card there;
# a kernel with σ rounded to float32 stood 1e6 tolerances away.
SYTRD_R = 3
# the TPU reference's config 4 eigh residual (BENCH_r05.json), printed
# beside the port's; the gate is bench.py's
TPU_EIGH_RESIDUAL = 4.351e-4
# ... and its 512² svd and config 3 reconstruction residuals
TPU_SVD_RECON = 6.706e-4
TPU_CFG3_RECON = 1.946e-5
# jacobi_sweeps against its plain version: JACOBI_C·eps·n·max|W| on W,
# JACOBI_C·eps·n on V and off (scale-free). A sweep rotates each column
# n − 1 times, and the two sum each apq in different orders.
JACOBI_C = 64
# rrqr_kernel against its plain version, with equal pivots: RRQR_C·eps·
# max(M, N)·max|A| on R_packed, RRQR_C·eps·max(M, N) on V and taus
RRQR_C = 32
# the most sweeps svd_jac_1sided takes (its max_sweeps)
MAX_SWEEPS = 24
# the TPU reference's config 4 eigen residual (BENCH_r05.json)
TPU_EIGEN_RESIDUAL = 5.412e-5
# bulge_chase_steps' contract on a full slide: B' = V_accᵀ·B·V_acc zero below
# the subdiagonal outside the bulges' last positions, and the carries equal
# to B''s bulge columns, within CHASE_C·eps·W·max|B| (the plain version
# stays under 0.04 of that in both types on the CPU); entry by entry only
# over CHASE_SHORT steps, before a train of 16 bulges has amplified the
# two sides' rounding (by ~2600 eps over 80 steps, against ~20 over 8)
CHASE_C = 1
CHASE_SHORT = 8
# schur_small's contract: QᵀQ = I, Q·T·Qᵀ = A and the junk below the
# subdiagonal within SCHUR_C·eps·W (·max|A|), as tests/test_schur_small.py
SCHUR_C = 64
# matrices of a schur_small batch that its plain version also runs (on the
# host: one host read a chase step makes it slow on the card)
SCHUR_SAMPLE = 8
# launch_totals prints (and the kernels line keeps) each kernel's heaviest
# distinct launches of the main path, by count × ms
DISTINCT_SHOWN = 8
# trevc_solve in float32 against a float64 witness: its distance to the
# witness within TREVC_C times the float32 plain version's. Over 12 seeds of
# phase2_trevc's inputs (tools/trevc_witness.py on the H100) the kernel's
# worst column was 0.40-3.46 times the plain version's, both within about
# 10³ float32 eps of the witness; 8 leaves 2.3x over the largest ratio and
# stays orders of magnitude under the O(1) gap of a wrong column.
TREVC_C = 8

# wall ms of the general eigen paths with bulge_chase_steps and
# schur_small as they were before their redesign for Hopper (commit
# c32ef3c): the range over six runs of tools/eigen_ab.py on that tree, in
# turns with the redesign's, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md §6)
WALLS_BEFORE = {"config 4 eigen (1024, 1024)": "2908.9-4266.3",
                "schur_decomp (1024, 1024)": "2699.3-4223.8",
                "eigen (256, 64, 64)": "96.2-137.8"}

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


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one ``fn()`` without the host's share: reps
    calls captured in a CUDA graph, the graph replayed five times between
    CUDA events. For launches shorter than their host-side wrapper, which
    cuda_ms then measures instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound(flops: float, nbytes: float):
    """Least time (ms) the card could take: the larger of operations over
    the float32 peak and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def maxabs(t) -> float:
    return float(t.abs().max())


def solve_check(what: str, a, y, x, x_ref, dtype,
                mult=BACKWARD_MULT) -> float:
    """Hold the solutions x of square systems to their reference x_ref,
    per system, and return max |x - x_ref|.

    The backward error ‖A·x − y‖₂/(‖A‖₂·‖x‖₂) (worst right-hand side) does
    not depend on κ(A): it must be at most N·eps and, unless ``mult`` is
    None, at most ``mult`` times the reference's (floored at eps). x
    itself must lie within
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
    be_tol = np.full(be.shape, n * eps) if mult is None else \
        np.minimum(n * eps, mult * np.maximum(be_ref, eps))
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
    # the stripe kernels' inputs come from a generator of their own: the
    # checks after this one draw from `rng` the inputs they drew before the
    # stripe checks were added, so their printed gaps compare across runs
    extra = np.random.default_rng(SEED + 1)
    lstsq_rng = np.random.default_rng(SEED + 11)
    for dtype in (torch.float32, torch.float64):
        for shape in HOUSE_SHAPES:
            # lstsq's panel from a generator of its own, for the same reason
            src = lstsq_rng if shape == HOUSE_SHAPES[-1] else rng
            a = torch.from_numpy(src.standard_normal(shape)).to(DEVICE, dtype)
            want = hp.house_panel_ref(a)
            tol = TOL[dtype] * maxabs(a)
            plan = hs.stripe_plan(a)
            # the wrapper as the main path calls it, then every regime
            before = hp.launches
            got = hp.house_panel(a)
            err = max(maxabs(g - w) for g, w in zip(got, want))
            if dtype == torch.float32:
                errs["house_panel"] = max(errs["house_panel"], err)
            check(hp.launches == before + 1 and err <= tol,
                  f"house_panel {shape} {dtype} (the wrapper: "
                  f"{hs.regime(*plan)}): one launch; max |kernel - plain| "
                  f"over R, V, taus = {err:.3e} <= {tol:.3e}")
            for c, sh in stripe_regimes(a):
                before = hp.launches
                got = hp._house_panel_in(a, c, sh)
                err = max(maxabs(g - w) for g, w in zip(got, want))
                if dtype == torch.float32:
                    errs["house_panel"] = max(errs["house_panel"], err)
                check(hp.launches == before + 1 and err <= tol,
                      f"house_panel {shape} {dtype} ({hs.regime(c, sh)}"
                      f"{', the plan' if (c, sh) == plan else ''}): one "
                      f"launch; max |kernel - plain| over R, V, taus = "
                      f"{err:.3e} <= {tol:.3e}")
            # the shared regime reads the panel itself; the same launch
            # through the column-major scratch, as a transposed view takes
            if plan[1]:
                got = hs._stripe_panel(a, *plan, "house_panel", False)
                err = max(maxabs(g - w) for g, w in zip(got, want))
                check(err <= tol, f"house_panel {shape} {dtype} "
                      f"({hs.regime(*plan)}, through the scratch): max "
                      f"|kernel - plain| over R, V, taus = {err:.3e} <= "
                      f"{tol:.3e}")
        # the last batch is shifted by 3·√N·I: κ₂ ≈ 3, so there the fixed
        # tolerance on x holds for every system
        for nb, n, k, shift in ((1, 256, 4, 0), (64, 128, 1, 0),
                                (64, 128, 1, 3)):
            a = torch.from_numpy(rng.standard_normal((nb, n, n))
                                 + shift * n ** 0.5 * np.eye(n)).to(DEVICE,
                                                                     dtype)
            y = torch.from_numpy(rng.standard_normal((nb, n, k))).to(DEVICE,
                                                                      dtype)
            gesv_check(f"({nb}, {n}, {n}) K={k} shift {shift}", a, y, dtype,
                       errs)
        # config 1's shape in every cluster size that holds it in shared
        # memory (the plan's pick among them), and the global regime
        a = torch.from_numpy(extra.standard_normal((1, 256, 256))).to(
            DEVICE, dtype)
        y = torch.from_numpy(extra.standard_normal((1, 256, 4))).to(
            DEVICE, dtype)
        for c in hs.CLUSTER_SIZES:
            if hs.smem_bytes(256, 260, 256, 4, c, True, dtype) \
                    <= _build.SMEM_MAX:
                gesv_check("config 1 (1, 256, 256) K=4", a, y, dtype, errs,
                           c, True)
        gesv_check("config 1 (1, 256, 256) K=4", a, y, dtype, errs, 4, False)
        nb, n, _, k = GESV_GLOBAL
        a = torch.from_numpy(extra.standard_normal((nb, n, n))).to(DEVICE,
                                                                    dtype)
        y = torch.from_numpy(extra.standard_normal((nb, n, k))).to(DEVICE,
                                                                    dtype)
        check(not hs.gesv_plan(a, y)[1], f"qr_gesv {GESV_GLOBAL[:3]} "
              f"{dtype}: the plan takes the global regime")
        gesv_check(f"{GESV_GLOBAL[:3]} K={k}", a, y, dtype, errs)
        phase2_stripe(extra, errs, dtype)


def stripe_regimes(panel):
    """Every (cluster size, shared) that ``hs.stripe_plan`` may give a
    panel of this shape and dtype: the shared regime at each cluster size
    that holds it, the plan's own, and the global regime at the plan's
    cluster size."""
    nb, m, b = panel.shape
    nstripes = -(-min(m, b) // hs.STRIPE)
    plan = hs.stripe_plan(panel)
    out = [(c, True) for c in hs.CLUSTER_SIZES
           if c <= nstripes and hs.smem_bytes(m, b, min(m, b), 0, c, True,
                                              panel.dtype) <= _build.SMEM_MAX]
    return sorted(set(out) | {plan, (plan[0], False)})


def gesv_check(what, a, y, dtype, errs, cluster=None, shared=None):
    """qr_gesv's kernel against its plain version by solve_check, in the
    plan's regime or the one given; prints which ran."""
    plan = hs.gesv_plan(a, y)
    c = cluster or plan[0]
    sh = plan[1] if shared is None else shared
    before = hs.launches
    x = hs._qr_gesv_in(a, y, c, sh)
    check(hs.launches == before + 1, f"qr_gesv {what} {dtype}: one launch")
    err = solve_check(f"qr_gesv {what} {dtype} ({hs.regime(c, sh)}"
                      f"{', the plan' if (c, sh) == plan else ''}), kernel "
                      "against plain", a, y, x, hs.qr_gesv_ref(a, y), dtype)
    if dtype == torch.float32:
        errs["qr_gesv"] = max(errs["qr_gesv"], err)


def phase2_stripe(rng, errs, dtype):
    """house_stripe_t against its plain version on R, V and taus within
    TOL·max|A|, at the headline's panels, (4, 128, 128), B not a multiple
    of 8, the global regime and the global regime staged in global memory,
    a zero column in the first matrix (τ = 0); at (32, 512, 128) also
    against house_panel's plain version, the drop-in contract of the JAX
    package's tests/test_qr.py:119-135."""
    for shape in STRIPE_SHAPES + (STRIPE_GLOBAL[dtype], STRIPE_STAGED[dtype]):
        a = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
        a[0, :, shape[-1] // 2] = 0
        c, sh = hs.stripe_plan(a)
        if shape == STRIPE_STAGED[dtype]:
            check(sh == hs.STAGED, f"house_stripe_t {shape} {dtype}: the "
                  "plan stages the stripe in global memory")
        what = f"house_stripe_t {shape} {dtype} ({hs.regime(c, sh)})"
        before = hs.stripe_launches
        got = hs.house_stripe_t(a)
        check(hs.stripe_launches == before + 1, f"{what}: one launch")
        tol = TOL[dtype] * maxabs(a)
        err = max(maxabs(g - w) for g, w in zip(got, hs.house_stripe_t_ref(a)))
        if dtype == torch.float32:
            errs["house_stripe_t"] = max(errs["house_stripe_t"], err)
        check(err <= tol and float(got[2][0, shape[-1] // 2]) == 0.0,
              f"{what}: max |kernel - plain| over R, V, taus = {err:.3e} <= "
              f"{tol:.3e}; τ = 0 on the zero column")
        if shape == STRIPE_SHAPES[0]:
            err = max(maxabs(g - w)
                      for g, w in zip(got, hp.house_panel_ref(a)))
            check(err <= tol, f"{what}: max |house_stripe_t - house_panel's "
                  f"plain version| over R, V, taus = {err:.3e} <= {tol:.3e}")


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


def chol_leaf_check(a, with_inv, errs, note=""):
    """chol_leaf on ``a`` (Nb, n, n) through the wrapper (its plan) and in
    every layout of the kernel against its plain version: one launch
    each, L (and L⁻¹) within TOL·max, zeros above the diagonal."""
    nb, n, _ = a.shape
    dtype = a.dtype
    amax = maxabs(torch.tril(a))
    l_ref, li_ref = cl.chol_leaf_ref(a, with_inv)
    plan = cl.card_plan(nb, n, dtype, with_inv, a.device)
    for warps in (None,) + cl.WARPS:
        before = cl.launches
        l, li = (cl.chol_leaf(a, with_inv) if warps is None else
                 cl._chol_leaf_in(a, with_inv, warps))
        how = (f"the wrapper, {plan} warps" if warps is None else
               f"{warps} warps" + (", the plan" if warps == plan else ""))
        what = f"chol_leaf ({nb}, {n}, {n}) {dtype} inv={with_inv} ({how})"
        err = maxabs(l - l_ref)
        tol = TOL[dtype] * amax
        check(cl.launches == before + 1 and err <= tol
              and maxabs(torch.triu(l, 1)) == 0.0
              and (li is None) != with_inv,
              f"{what}{note}: one launch; max |L - plain| = {err:.3e} <= "
              f"{tol:.3e}, zeros above")
        if with_inv:
            ierr = maxabs(li - li_ref)
            itol = TOL[dtype] * maxabs(li_ref)
            check(ierr <= itol and maxabs(torch.triu(li, 1)) == 0.0,
                  f"{what}: max |L⁻¹ - plain| = {ierr:.3e} <= {itol:.3e}, "
                  "zeros above")
            err = max(err, ierr)
        if dtype == torch.float32:
            errs["chol_leaf"] = max(errs["chol_leaf"], err)


def phase2_chol(rng, errs):
    """chol_leaf at the main path's batches: 1024 (config 2's leaves), 32
    (the 512² batch's and the Gram iterations') and 1 (eigh via_svd's),
    through the wrapper (its plan) and in every layout of the kernel."""
    # the batch of 1 from a generator of its own, so that the checks after
    # this one draw from `rng` the inputs they drew before it was added
    one = np.random.default_rng(SEED + 13)
    for dtype in (torch.float32, torch.float64):
        for nb in (1024, 32, 1):
            a = spd_garbage_above(one if nb == 1 else rng, nb, 64).to(dtype)
            for with_inv in (False, True):
                chol_leaf_check(a, with_inv, errs, ", upper triangle garbage")
        bad = -torch.eye(4, device=DEVICE, dtype=dtype)[None]
        for with_inv in (False, True):
            for warps in (None,) + cl.WARPS:
                l, li = (cl.chol_leaf(bad, with_inv) if warps is None else
                         cl._chol_leaf_in(bad, with_inv, warps))
                nan = bool(torch.isnan(l).any()) and (
                    bool(torch.isnan(li).any()) if with_inv else li is None)
                how = "the wrapper" if warps is None else f"{warps} warps"
                check(nan, f"chol_leaf {dtype} inv={with_inv} ({how}): NaN "
                      "on a non-SPD block")


def phase2_chol_config5(errs):
    """chol_leaf at config 5's leaves, the per-point blocks Cᵢ (4096, 1, 1)
    and the Schur complement S (1, 4, 4) of each structured ODR solve, in
    both types, with and without L⁻¹, through the wrapper and in every
    layout; inputs from a generator of their own."""
    gen = np.random.default_rng(SEED + 15)
    for dtype in (torch.float32, torch.float64):
        for nb, n in ((4096, 1), (1, 4)):
            a = spd_garbage_above(gen, nb, n).to(dtype)
            for with_inv in (False, True):
                chol_leaf_check(a, with_inv, errs, ", config 5's leaf")


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


def lu_test_panel(rng, shape):
    """A random panel with a zero column in the first matrix and tied
    |pivots| (3 and −3, twice) in column 0 of the second."""
    a = rng.standard_normal(shape)
    a[0, :, shape[2] // 2] = 0
    if shape[0] > 1:
        a[1, :4, 0] = [1.0, -3.0, 3.0, -3.0]
        a[1, 4:, 0] = 0.5
    return a


def lu_panel_check(what, a, out, rank, out_ref, rank_ref, errs, dtype):
    """rank equal to the plain version's (both types: the two round each
    quotient, product and difference alike), the panel within TOL·max|A|
    of it, and its packed L·U = A[P]."""
    amax = maxabs(a)
    ndiff = int((rank != rank_ref).sum())
    check(ndiff == 0, f"{what}: rank equal to the plain version's "
          f"({ndiff} entries differ)")
    err = maxabs(out - out_ref)
    tol = TOL[dtype] * amax
    check(err <= tol, f"{what}: max |panel - plain| = {err:.3e} <= {tol:.3e}")
    if dtype == torch.float32:
        errs["lu_panel"] = max(errs["lu_panel"], err)
    res = packed_lu_residual(a, out, rank)
    tol = 1e-5 * amax * a.shape[1] ** 0.5
    check(res <= tol, f"{what}: packed max |L·U - A[P]| = {res:.3e} <= "
          f"{tol:.3e}")


def phase2_lu(rng, errs):
    """lu_panel at lu_decomp's four panel shapes in the launch of its plan,
    then in every placement its plan can choose (each cluster size, rows
    in shared and in global memory) on (2, 512, 128), (3, 136, 40) and
    (2, 300, 200) (two blocks of columns), and with a NaN candidate at
    step 3 (no pivot from there on, as the plain version's);
    lu_gesv at config 2 and K = 4 in its plan, then in every layout
    (registers, shared, global) that takes (64, 128, 4), (2, 128, 160) and
    (3, 13, 3); each in float32 and float64. The placements', the NaN's
    and the layouts' inputs come from a generator of their own, so that
    the later checks draw the same inputs from ``rng`` as before them."""
    dev = torch.device(DEVICE)
    own = np.random.default_rng(SEED + 23)
    for dtype in (torch.float32, torch.float64):
        for m in (512, 384, 256, 128):
            a = torch.from_numpy(rng.standard_normal((32, m, 128))).to(
                DEVICE, dtype)
            plan = lp.card_plan(32, m, 128, dtype, dev)
            out, rank = lp.lu_panel(a)
            lu_panel_check(f"lu_panel (32, {m}, 128) {dtype} "
                           f"({lp.regime(*plan, m)})", a, out, rank,
                           *lp.lu_panel_ref(a), errs, dtype)
        for shape in ((2, 512, 128), (3, 136, 40), (2, 300, 200)):
            nb, m, b = shape
            a = torch.from_numpy(lu_test_panel(own, shape)).to(DEVICE, dtype)
            want = lp.lu_panel_ref(a)
            for place in lp.placements(m, b, dtype):
                launch = lp.launch_on(m, b, dtype, *place)
                lu_panel_check(f"lu_panel {shape} {dtype} "
                               f"({lp.regime(*launch, m)})", a,
                               *lp._lu_panel_in(a, launch), *want, errs,
                               dtype)
        a = own.standard_normal((2, 136, 40))
        a[1, 70, 3] = np.nan
        a = torch.from_numpy(a).to(DEVICE, dtype)
        out, rank = lp.lu_panel(a)
        out_ref, rank_ref = lp.lu_panel_ref(a)
        same = (out == out_ref) | (torch.isnan(out) & torch.isnan(out_ref))
        check(bool(torch.equal(rank, rank_ref)) and int((rank[1] < 40).sum())
              == 3 and bool(same.all()), f"lu_panel (2, 136, 40) {dtype} with "
              "a NaN at step 3: rank and panel equal to the plain version's, "
              "no pivot from step 3 on")
        for nb, k in ((1024, 1), (64, 4)):
            a = torch.from_numpy(rng.standard_normal((nb, 128, 128))).to(
                DEVICE, dtype)
            y = torch.from_numpy(rng.standard_normal((nb, 128, k))).to(
                DEVICE, dtype)
            layout = lp.LAYOUTS[lp.gesv_plan(nb, 128, k, dtype)[0]]
            err = solve_check(f"lu_gesv ({nb}, 128, 128) K={k} {dtype}, "
                              f"{layout}, kernel against plain", a, y,
                              lp.lu_gesv(a, y), lp.lu_gesv_ref(a, y), dtype)
            if dtype == torch.float32:
                errs["lu_gesv"] = max(errs["lu_gesv"], err)
        for nb, n, k in ((64, 128, 4), (2, 128, 160), (3, 13, 3)):
            a = torch.from_numpy(own.standard_normal((nb, n, n))).to(
                DEVICE, dtype)
            y = torch.from_numpy(own.standard_normal((nb, n, k))).to(
                DEVICE, dtype)
            want = lp.lu_gesv_ref(a, y)
            for launch in lp.gesv_layouts(n, k, dtype):
                solve_check(f"lu_gesv ({nb}, {n}, {n}) K={k} {dtype}, "
                            f"{lp.LAYOUTS[launch[0]]}, kernel against plain",
                            a, y, lp._lu_gesv_in(a, y, launch), want, dtype)
    for dtype in (torch.float32, torch.float64):
        for launch in lp.gesv_layouts(8, 1, dtype):
            x = lp._lu_gesv_in(torch.ones((1, 8, 8), device=DEVICE,
                                          dtype=dtype),
                               torch.ones((1, 8, 1), device=DEVICE,
                                          dtype=dtype), launch)
            check(not bool(torch.isfinite(x).all()),
                  f"lu_gesv {dtype} {lp.LAYOUTS[launch[0]]} on an exactly "
                  "singular system: x is not finite")


def symmetric(rng, shape):
    a = rng.standard_normal(shape)
    return (a + np.swapaxes(a, -1, -2)) / 2


def gram(rng, shape):
    """aᵀa of a seeded normal batch, formed on the card in float32, as
    svd_gram's spectral preconditioner forms it (la/svd_gram.py:243)."""
    a = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE,
                                                        torch.float32)
    return torch.matmul(a.mT, a)


def tau_zero_blocks(rng, nb, m):
    """Symmetric blocks whose first half is tridiagonal and decoupled from
    the second: every reflector of the first m/2 − 1 columns has τ = 0."""
    a = symmetric(rng, (nb, m, m))
    h = m // 2
    a[:, h:, :h] = 0
    a[:, :h, h:] = 0
    a[:, :h, :h] *= np.triu(np.tril(np.ones((h, h)), 1), -1)
    return a


def panel_backward_error(c, out, bk):
    """(max|Hᵀ·C·H − T|, max|Hᵀ·H − I|) in float64: H = H_0···H_{bk−1}
    from V and taus, T the tridiagonal columns d, e beside the trailing
    block."""
    trail, V, _, taus, d, e = (x.double() for x in out)
    c = c.double()
    nb, m, _ = c.shape
    eye = torch.eye(m, dtype=torch.float64, device=c.device)
    H = eye.repeat(nb, 1, 1)
    for j in range(bk):
        v = V[:, :, j:j + 1]
        H = H - taus[:, j, None, None] * torch.matmul(torch.matmul(H, v),
                                                      v.mT)
    T = torch.zeros_like(c)
    i = torch.arange(bk, device=c.device)
    T[:, i, i] = d
    T[:, i + 1, i] = e
    T[:, i, i + 1] = e
    T[:, bk:, bk:] = trail
    return (maxabs(torch.matmul(torch.matmul(H.mT, c), H) - T),
            maxabs(torch.matmul(H.mT, H) - eye))


def phase2_sytrd(rng, errs):
    """sytrd_panel against its plain version through the wrapper, and on
    every cluster size its plan can choose in each dtype: config 4's
    (1, 1024, 1024) on each size that places it (3-16 in float32, 6-16 in
    float64), the smaller ones on (3, 100, 100) in float64 and the τ = 0
    blocks in float32; and (2, 1100, 1100) on one block a matrix, a slab
    of more rows than threads."""
    every = None  # every cluster size that places the panel
    # the inputs of the float32 (1, 1024, 1024) and (3, 100, 100) come first
    # from `rng`, as before the cluster sizes were added
    for what, c, bk, sizes in (
            ("(1, 1024, 1024)", torch.from_numpy(symmetric(
                rng, (1, 1024, 1024))).to(DEVICE, torch.float32), 64, every),
            ("Gram (32, 512, 512)", gram(rng, (32, 512, 512)), 64, ()),
            ("(3, 100, 100)", torch.from_numpy(symmetric(
                rng, (3, 100, 100))).to(DEVICE), 63, (1, 2, 3, 4, 5)),
            ("τ = 0 (2, 96, 96)", torch.from_numpy(tau_zero_blocks(
                rng, 2, 96)).to(DEVICE, torch.float32), 63, (1, 2)),
            ("τ = 0 (2, 96, 96)", torch.from_numpy(tau_zero_blocks(
                rng, 2, 96)).to(DEVICE), 63, ()),
            ("(1, 1024, 1024)", torch.from_numpy(symmetric(
                np.random.default_rng(SEED + 12), (1, 1024, 1024))).to(DEVICE),
             64, every),
            ("Gram (32, 512, 512)", gram(np.random.default_rng(SEED + 13),
                                         (32, 512, 512)).double(), 64, ()),
            # a slab of more rows than the block's 1024 threads
            ("(2, 1100, 1100)", torch.from_numpy(symmetric(
                np.random.default_rng(SEED + 14), (2, 1100, 1100))).to(
                    DEVICE, torch.float32), 16, (1,))):
        want = sp.sytrd_panel_ref(c, bk)
        nb, m, _ = c.shape
        plan = sp.card_plan(nb, m, bk, c.dtype, c.device)
        if sizes is every:
            sizes = sp.placeable_sizes(m, bk, c.dtype)
        witness = None
        if what == "(3, 100, 100)" and c.dtype == torch.float64:
            witness = (sytrd_panel_wide(c, bk),
                       sp.sytrd_panel_ref(c.cpu(), bk))
        # the wrapper as the main path calls it, then every size
        sytrd_check(f"sytrd_panel {what} {c.dtype} bk={bk} (the wrapper: "
                    f"{sp.regime(*plan, m)})", c, bk, None, want, errs,
                    witness)
        for cluster in sorted(set(sizes) | {plan[0]}):
            launch = sp.launch_on(m, bk, c.dtype, cluster)
            sytrd_check(f"sytrd_panel {what} {c.dtype} bk={bk} ("
                        f"{sp.regime(*launch, m)}"
                        f"{', the plan' if launch == plan else ''})", c, bk,
                        launch, want, errs, witness)


SYTRD_OUTPUTS = ("C_trailing", "V", "W", "taus", "d", "e")


def sytrd_panel_wide(c, bk):
    """sytrd_panel_ref's arithmetic in numpy's long double on C (a float64
    tensor), the witness of the float64 panel: (C_trailing, V, W, taus, d,
    e) as long double arrays. Raises where long double is no wider than
    float64."""
    ld = np.longdouble
    if np.finfo(ld).eps >= np.finfo(np.float64).eps / 1024:
        raise RuntimeError("numpy's long double is not wider than float64 "
                           "here: no witness for sytrd_panel")
    c = c.cpu().numpy().astype(ld)
    nb, m, _ = c.shape
    rows = np.arange(m)
    V, W = np.zeros((nb, m, bk), ld), np.zeros((nb, m, bk), ld)
    taus, dd, ee = (np.zeros((nb, bk), ld) for _ in range(3))
    one, zero = ld(1), ld(0)
    for j in range(bk):
        col = c[:, :, j] - (V @ W[:, j, :, None])[..., 0] \
            - (W @ V[:, j, :, None])[..., 0]
        dd[:, j] = col[:, j]
        x0 = col[:, j + 1]
        sigma = np.where(rows > j + 1, col * col, zero).sum(axis=1)
        nrm = np.sqrt(x0 * x0 + sigma)
        beta = np.where(sigma == 0, x0, np.where(x0 >= 0, -nrm, nrm))
        den = x0 - beta
        v = np.where(rows > j + 1, col / np.where(den == 0, one, den)[:, None],
                     zero)
        v[:, j + 1] = one
        tau = np.where(sigma == 0, zero,
                       (beta - x0) / np.where(beta == 0, one, beta))
        ee[:, j], taus[:, j] = beta, tau
        vc = v[..., None]
        cv = c @ vc - V @ (W.swapaxes(1, 2) @ vc) \
            - W @ (V.swapaxes(1, 2) @ vc)
        w = tau[:, None] * cv[..., 0]
        w = w - (ld(0.5) * tau * (w * v).sum(axis=1))[:, None] * v
        V[:, :, j], W[:, :, j] = v, w
    x = V[:, bk:] @ W[:, bk:].swapaxes(1, 2)
    full = c[:, bk:, bk:] - x - x.swapaxes(1, 2)
    trail = np.triu(full) + np.triu(full, 1).swapaxes(1, 2)
    return trail, V, W, taus, dd, ee


def wide_gap(t, wide) -> float:
    """max |t − wide|, t a tensor, wide a long double array."""
    return float(np.abs(t.cpu().numpy().astype(np.longdouble) - wide).max())


def sytrd_check(what, c, bk, launch, want, errs, witness=None):
    """One sytrd_panel launch (the wrapper's where ``launch`` is None)
    against the plain version's ``want``: every output within
    SYTRD_C·eps·m (·max|C|), the trailing block exactly symmetric, the
    panel's contract, and τ = 0 where the input asks. With a ``witness``
    (``sytrd_panel_wide``'s outputs, the plain version's on the host) each
    output is held to the first instead, within the larger of that
    tolerance and SYTRD_R times the larger of the plain versions'
    distances to it."""
    dtype = c.dtype
    before = sp.launches
    got = (sp.sytrd_panel(c, bk) if launch is None
           else sp._sytrd_panel_in(c, bk, launch))
    check(sp.launches == before + 1, f"{what}: one launch")
    m = c.shape[-1]
    cmax = maxabs(c)
    unit = SYTRD_C * torch.finfo(dtype).eps * m
    worst = 0.0
    for i, (name, g, w, scale) in enumerate(zip(
            SYTRD_OUTPUTS, got, want, (cmax, 1.0, cmax, 1.0, cmax, cmax))):
        err = maxabs(g - w)
        worst = max(worst, err / scale)
        if witness is None:
            check(tuple(g.shape) == tuple(w.shape) and err <= unit * scale,
                  f"{what}: max |{name} - plain| = {err:.3e} <= "
                  f"{unit * scale:.3e}")
        else:
            wide, host = witness
            kw = wide_gap(g, wide[i])
            pw, hw = wide_gap(w, wide[i]), wide_gap(host[i], wide[i])
            tol = max(unit * scale, SYTRD_R * max(pw, hw))
            check(tuple(g.shape) == tuple(w.shape) and kw <= tol,
                  f"{what}: max |{name} - long double witness| = {kw:.3e} "
                  f"<= {tol:.3e} = max({unit * scale:.3e}, {SYTRD_R} x the "
                  f"plain version's {pw:.3e} (card), {hw:.3e} (host)); "
                  f"kernel against plain {err:.3e}")
        if dtype == torch.float32:
            errs["sytrd_panel"] = max(errs["sytrd_panel"], err)
    check(torch.equal(got[0], got[0].mT),
          f"{what}: trailing block exactly symmetric")
    resid, orth = panel_backward_error(c, got, bk)
    eps = torch.finfo(dtype).eps
    check(resid <= BACKWARD_C * eps * m * cmax
          and orth <= BACKWARD_C * eps * m,
          f"{what}: max |Hᵀ·C·H - T| = {resid:.3e} <= "
          f"{BACKWARD_C * eps * m * cmax:.3e}, max |HᵀH - I| = "
          f"{orth:.3e} <= {BACKWARD_C * eps * m:.3e}")
    say(f"{what}: worst error {worst / unit * SYTRD_C:.3f} eps·m "
        f"(·max|C| where it scales), the tolerance {SYTRD_C}")
    if "τ = 0" in what:
        h = m // 2 - 1
        check(maxabs(got[3][:, :h]) == 0.0 and torch.equal(
            got[5][:, :h], torch.diagonal(c, -1, 1, 2)[:, :h]),
            f"{what}: τ = 0 and e = the subdiagonal on the first {h} "
            "columns")


def near_converged(rng, shape):
    """W = U·diag(σ)·(I + (0.1/n)·G) from seeded normals: σ from 10 down to 1
    geometrically, columns nearly orthogonal, as late in a Jacobi
    iteration. A sweep there is a contraction, so two roundings of it
    agree entry by entry. (Early sweeps of a random W are not: their
    rotation angles amplify rounding by orders of magnitude, so there
    only W_in·V = W and VᵀV = I are well posed; see phase2_jacobi.)"""
    nb, m, n = shape
    u = np.linalg.qr(rng.standard_normal((nb, m, n)))[0]
    sig = np.geomspace(10.0, 1.0, n)
    g = rng.standard_normal((nb, n, n))
    return (u * sig) @ (np.eye(n) + 0.1 / n * g)


def phase2_jacobi(rng, errs):
    """One sweep from V = I, kernel against plain version, at the main
    path's shapes: (1024, 64, 64) (the small SVD's Rᵀ, one block a matrix)
    and (8, 512, 512) (config 3's, two waves of clusters of 16), and
    (8, 128, 128), which one block holds in float32 only, each in the
    launch of the wrapper's plan. On a
    near-converged W both must agree entry by entry. On a random W (the
    path's first sweep) the kernel must be consistent, W_in·V = W and
    VᵀV = I; how many matrices differ from the plain version there is
    printed, not gated."""
    for dtype in (torch.float32, torch.float64):
        for shape in ((1024, 64, 64), (8, 128, 128), (8, 512, 512)):
            nb, m, n = shape
            unit = JACOBI_C * torch.finfo(dtype).eps * n
            plan = js.card_plan(nb, m, n, dtype, torch.device(DEVICE))
            what = f"jacobi_sweeps {shape} {dtype} ({js.regime(*plan)})"
            v = torch.eye(n, device=DEVICE, dtype=dtype).repeat(nb, 1, 1)
            w = torch.from_numpy(near_converged(rng, shape)).to(DEVICE, dtype)
            got = js.jacobi_sweeps(w, v, 1)
            want = js.jacobi_sweeps_ref(w, v, 1)
            worst = 0.0
            for name, g, r, scale in zip(("W", "V", "off"), got, want,
                                         (maxabs(w), 1.0, 1.0)):
                err = maxabs(g - r)
                worst = max(worst, err / (unit * scale))
                check(tuple(g.shape) == tuple(r.shape)
                      and err <= unit * scale,
                      f"{what}, near-converged: max |{name} - plain| = "
                      f"{err:.3e} <= {unit * scale:.3e}")
                if dtype == torch.float32 and name == "W":
                    errs["jacobi_sweeps"] = max(errs["jacobi_sweeps"], err)
            say(f"{what}: worst error {worst * JACOBI_C:.3f} eps·n "
                f"(·max|W| on W), the tolerance {JACOBI_C}; off "
                f"{maxabs(got[2]):.3e}, the largest over the sweep")
            w = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
            wk, vk, _ = js.jacobi_sweeps(w, v, 1)
            wr, _, _ = js.jacobi_sweeps_ref(w, v, 1)
            wmax = maxabs(w)
            cons = maxabs(torch.matmul(w.double(), vk.double()) - wk.double())
            orth = maxabs(torch.matmul(vk.mT, vk) - v)
            check(cons <= unit * wmax and orth <= unit,
                  f"{what}, random: max |W_in·V - W| = {cons:.3e} <= "
                  f"{unit * wmax:.3e}, max |VᵀV - I| = {orth:.3e} <= "
                  f"{unit:.3e}")
            apart = int(((wk - wr).abs().amax(dim=(-2, -1))
                         > unit * wmax).sum())
            say(f"{what}, random: {apart} of {nb} matrices differ from the "
                "plain version's sweep by more than the tolerance")


def phase2_rrqr(rng, errs):
    """Kernel against plain version at the main path's shapes, (1024, 128,
    128) (config 2's solve, one block a matrix) and (32, 512, 512) (a
    cluster a matrix), and a tall (3, 100, 60), each in the launch of the
    wrapper's plan: pivots equal (required in float64;
    in float32 the matrices whose pivots differ are counted, as two
    roundings of a near-tie of the norms may choose either), R, V and taus
    on the matrices with equal pivots; and A[:, P] = Q·R through the
    port's Q build, which holds whatever the pivots."""
    for dtype in (torch.float32, torch.float64):
        for shape in ((1024, 128, 128), (32, 512, 512), (3, 100, 60)):
            nb, m, n = shape
            a = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
            got = rk.rrqr_kernel(a)
            want = rk.rrqr_kernel_ref(a)
            plan = rk.card_plan(nb, m, n, dtype, torch.device(DEVICE))
            what = f"rrqr_kernel {shape} {dtype} ({rk.regime(*plan, n)})"
            # per matrix: a flip at a near-tie of the norms changes the rest
            same = (got[3] == want[3]).all(dim=-1)
            ndiff = nb - int(same.sum())
            if dtype == torch.float64:
                check(ndiff == 0, f"{what}: pivots equal to the plain "
                      "version's")
            else:
                say(f"{what}: pivots differ from the plain version's in "
                    f"{ndiff} of {nb} matrices")
            amax = maxabs(a)
            unit = RRQR_C * torch.finfo(dtype).eps * max(m, n)
            if ndiff < nb:
                for name, g, r, scale in zip(("R_packed", "V", "taus"),
                                             got[:3], want[:3],
                                             (amax, 1.0, 1.0)):
                    err = maxabs(g[same] - r[same])
                    check(err <= unit * scale, f"{what}: max |{name} - "
                          f"plain| = {err:.3e} <= {unit * scale:.3e}")
                    if dtype == torch.float32 and name == "R_packed":
                        errs["rrqr_kernel"] = max(errs["rrqr_kernel"], err)
            q, r, p = rrqr_mod._rrqr_assemble(*got, True)
            ap = torch.gather(a, 2, p.long()[:, None, :].expand(a.shape))
            recon = maxabs(torch.matmul(q, r) - ap)
            tol = (1e-5 * amax * n ** 0.5 if dtype == torch.float32
                   else unit * amax)
            check(recon <= tol, f"{what}: max |A[:, P] - Q·R| = {recon:.3e} "
                  f"<= {tol:.3e}")


def jacobi_launches():
    """Every launch jacobi_sweeps' plan can choose, each on a shape it
    takes, in both types: one block a matrix, each cluster size of config
    3's 512² with V in shared and in global memory, a cluster of 2 (its
    ring wraps between two blocks), and one launch a round (what no
    cluster holds)."""
    out = []
    for dtype in (torch.float32, torch.float64):
        out.append(((64, 64, 64), js.launch_on(64, 64, dtype, 1, False),
                    dtype))
        out += [((2, 512, 512), js.launch_on(512, 512, dtype, c, vg), dtype)
                for c, vg in js.placements(512, 512, dtype) if c > 1]
        out.append(((3, 96, 64), js.launch_on(96, 64, dtype, 2, False),
                    dtype))
        out.append(((1, 1024, 1024), js.ROUNDS, dtype))
    return out


def phase2_jacobi_launches(errs):
    """jacobi_sweeps in every launch its plan can choose, against its plain
    version on a near-converged W and consistent on a random one, as
    phase2_jacobi; inputs from a generator of their own."""
    rng = np.random.default_rng(SEED + 21)
    for shape, plan, dtype in jacobi_launches():
        nb, m, n = shape
        unit = JACOBI_C * torch.finfo(dtype).eps * n
        what = f"jacobi_sweeps {shape} {dtype} ({js.regime(*plan)})"
        v = torch.eye(n, device=DEVICE, dtype=dtype).repeat(nb, 1, 1)
        w = torch.from_numpy(near_converged(rng, shape)).to(DEVICE, dtype)
        got = js._jacobi_in(w, v, 1, plan)
        want = js.jacobi_sweeps_ref(w, v, 1)
        worst = max(maxabs(g - r) / (unit * sc) for g, r, sc in
                    zip(got, want, (maxabs(w), 1.0, 1.0)))
        check(worst <= 1.0, f"{what}, near-converged: worst of W, V and off "
              f"{worst * JACOBI_C:.3f} eps·n (·max|W| on W) <= {JACOBI_C}")
        if dtype == torch.float32:
            errs["jacobi_sweeps"] = max(errs["jacobi_sweeps"],
                                        maxabs(got[0] - want[0]))
        w = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
        wk, vk, _ = js._jacobi_in(w, v, 1, plan)
        cons = maxabs(torch.matmul(w.double(), vk.double()) - wk.double())
        orth = maxabs(torch.matmul(vk.mT, vk) - v)
        check(cons <= unit * maxabs(w) and orth <= unit,
              f"{what}, random: max |W_in·V - W| = {cons:.3e}, max |VᵀV - I|"
              f" = {orth:.3e}")


def rrqr_launches():
    """Every cluster size rrqr_kernel's plan can choose, on the 512² shape
    of rrqr_decomp's batch, and one block a matrix on config 2's 128², in
    both types."""
    out = []
    for dtype in (torch.float32, torch.float64):
        out += [((4, 512, 512), rk.launch_on(512, 512, dtype, c), dtype)
                for c in rk.placements(512, 512, dtype)]
        out.append(((64, 128, 128), rk.launch_on(128, 128, dtype, 1), dtype))
    return out


def phase2_rrqr_launches(errs):
    """rrqr_kernel in every launch its plan can choose, against its plain
    version as phase2_rrqr; inputs from a generator of their own."""
    rng = np.random.default_rng(SEED + 22)
    for shape, plan, dtype in rrqr_launches():
        nb, m, n = shape
        what = f"rrqr_kernel {shape} {dtype} ({rk.regime(*plan, n)})"
        a = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dtype)
        got = rk._rrqr_in(a, plan)
        want = rk.rrqr_kernel_ref(a)
        # as phase2_rrqr: pivots equal in float64; in float32 the matrices
        # a near-tie flipped are counted, and A[:, P] = Q·R holds on all
        same = (got[3] == want[3]).all(dim=-1)
        ndiff = nb - int(same.sum())
        if dtype == torch.float64:
            check(ndiff == 0, f"{what}: pivots equal to the plain version's")
        else:
            say(f"{what}: pivots differ from the plain version's in {ndiff} "
                f"of {nb} matrices")
        unit = RRQR_C * torch.finfo(dtype).eps * max(m, n)
        if ndiff < nb:
            worst = max(maxabs(g[same] - r[same]) / (unit * sc) for g, r, sc
                        in zip(got[:3], want[:3], (maxabs(a), 1.0, 1.0)))
            check(worst <= 1.0, f"{what}: worst of R_packed, V and taus "
                  f"{worst * RRQR_C:.3f} eps·max(M, N) (·max|A| on R) <= "
                  f"{RRQR_C}")
            if dtype == torch.float32:
                errs["rrqr_kernel"] = max(
                    errs["rrqr_kernel"], maxabs(got[0][same] - want[0][same]))
        q, r, p = rrqr_mod._rrqr_assemble(*got, True)
        ap = torch.gather(a, 2, p.long()[:, None, :].expand(a.shape))
        recon = maxabs(torch.matmul(q, r) - ap)
        tol = (1e-5 * maxabs(a) * n ** 0.5 if dtype == torch.float32
               else unit * maxabs(a))
        check(recon <= tol, f"{what}: max |A[:, P] - Q·R| = {recon:.3e} <= "
              f"{tol:.3e}")


def phase2(rng):
    errs = dict.fromkeys(KERNELS, 0.0)
    phase2_qr(rng, errs)
    phase2_chol(rng, errs)
    phase2_lu(rng, errs)
    phase2_sytrd(rng, errs)
    phase2_jacobi(rng, errs)
    phase2_rrqr(rng, errs)
    phase2_jacobi_launches(errs)
    phase2_rrqr_launches(errs)
    phase2_eigen(rng, errs)
    phase2_chol_config5(errs)
    return errs


def square_solve_gate(a, x, y, what, where="bench.py:362"):
    n = a.shape[-1]
    resid = maxabs(torch.matmul(a, x) - y)
    tol = 1e-4 * maxabs(a) * n ** 0.5
    check(resid <= tol, f"{what}: max |A·x - y| = {resid:.3e} <= {tol:.3e} "
          f"({where})")


# the wrapper each C function of the kernel library belongs to, where a
# launch does not name it itself
KERNEL_OF = {"chol_leaf": "chol_leaf", "lu_panel": "lu_panel",
             "lu_gesv": "lu_gesv", "qr_gesv": "qr_gesv",
             "sytrd_panel": "sytrd_panel", "jacobi_sweeps": "jacobi_sweeps",
             "rrqr": "rrqr_kernel", "schur_small": "schur_small",
             "bulge_chase": "bulge_chase_steps", "trevc_solve": "trevc_solve",
             "kahan_sum": "kahan_sum"}


class LaunchLog:
    """The main path's launches, recorded through the kernel library's hook
    (``_build.recorder``) between reset_counts and read_counts: how often
    each distinct launch ran (its kernel, C function, the shapes and dtypes
    of its tensors and its scalar arguments), and a copy of the first one's
    arguments, so that phase 4 can time each distinct launch once on the
    data the main path gave it."""

    def __init__(self):
        self.count, self.pending, self.first = {}, {}, {}

    def __call__(self, kernel, fn_name, device, args):
        name = kernel or KERNEL_OF[fn_name.removeprefix("nd4js_")[:-4]]
        key = (name, fn_name, str(device), tuple(
            (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
            else a for a in args))
        if key not in self.first:
            self.first[key] = (device, [a.clone() if isinstance(
                a, torch.Tensor) else a for a in args])
        self.pending[key] = self.pending.get(key, 0) + 1

    def reset(self) -> None:
        self.pending.clear()

    def commit(self) -> None:
        for key, n in self.pending.items():
            self.count[key] = self.count.get(key, 0) + n
        self.pending.clear()

    def launches(self) -> dict:
        out = dict.fromkeys(KERNELS, 0)
        for key, n in self.count.items():
            out[key[0]] += n
        return out


LOG = LaunchLog()


def reset_counts() -> None:
    LOG.reset()
    hp.launches = hs.launches = hs.stripe_launches = cl.launches = 0
    lp.launches.update(lu_panel=0, lu_gesv=0)
    sp.launches = js.launches = rk.launches = 0
    ss.launches = bc.launches = tv.launches = ks.launches = 0
    qr_mod.auto_branches.update(cholqr2=0, householder=0)
    svd_gram_mod.branches.update(exact=0, poly=0, finish=0, repair=0)
    schur_mod.branches.update(dict.fromkeys(schur_mod.branches, 0))


def read_counts() -> dict:
    torch.cuda.synchronize()
    LOG.commit()
    return {"house_panel": hp.launches, "qr_gesv": hs.launches,
            "house_stripe_t": hs.stripe_launches, "chol_leaf": cl.launches,
            "lu_panel": lp.launches["lu_panel"],
            "lu_gesv": lp.launches["lu_gesv"], "sytrd_panel": sp.launches,
            "jacobi_sweeps": js.launches, "rrqr_kernel": rk.launches,
            "schur_small": ss.launches, "bulge_chase_steps": bc.launches,
            "trevc_solve": tv.launches, "kahan_sum": ks.launches}


def check_counts(what: str, got: dict, want: dict, totals: dict) -> None:
    """Each kernel in ``want`` launched exactly that often, the others not
    at all; add ``got`` to ``totals``."""
    full = dict.fromkeys(KERNELS, 0) | want
    check(got == full, f"{what}: launches {got}, expected {full}")
    for k, v in got.items():
        totals[k] += v


def phase3(gen):
    totals = dict.fromkeys(KERNELS, 0)
    _build.recorder = LOG
    try:
        out = phase3_paths(gen, totals)
    finally:
        _build.recorder = None
    LOG.reset()
    check(LOG.launches() == totals, "the launch log agrees with the counters: "
          f"{len(LOG.count)} distinct launches")
    return out


def phase3_paths(gen, totals):

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
    say(f"qr_lstsq_fused (256, 256): qr_gesv ran in "
        f"{hs.regime(*hs.gesv_plan(a1[None], y1[None]))}")

    # house_stripe_t, the drop-in for house_panel, on the headline's first
    # panel; held by reconstruction with the port's compact-WY T
    panel = a[:, :, :128].contiguous()
    reset_counts()
    rp, vp, tp = hs.house_stripe_t(panel)
    check_counts("house_stripe_t (32, 512, 128)", read_counts(),
                 {"house_stripe_t": 1}, totals)
    vm, t = qr_mod._form_t_batched(vp, tp)
    recon = maxabs(rp - torch.matmul(vm, torch.matmul(
        t, torch.matmul(vm.mT, rp))) - panel)
    ptol = 1e-5 * maxabs(panel) * n ** 0.5
    check(recon <= ptol, f"house_stripe_t (32, 512, 128) "
          f"({hs.regime(*hs.stripe_plan(panel))}): max |(I - V·T·Vᵀ)·R - A| "
          f"= {recon:.3e} <= {ptol:.3e}")

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

    eig = phase3_eigh(totals)
    svd_in = phase3_svd(totals, a, cfg2, eig[0])
    svd_in |= phase3_la_rest(totals, a, cfg2, svd_in)
    geig = phase3_eigen(totals)
    cfg5 = phase3_config5(totals)

    say(f"launches on the main path: {totals}")
    check(all(c > 0 for k, c in totals.items() if k != "kahan_sum"),
          "every kernel of the path was launched (kahan_sum's path is "
          "phase 6)")
    return totals, (a, y), (a1, y1), cfg2, spd, eig, svd_in, geig, cfg5


# config 5 (bench.py:461-516): the poly-4 model and its true parameters,
# and the Rosenbrock function, as torch functions
P_TRUE5 = np.array([0.5, -1.0, 0.25, 2.0], np.float32)


def poly4(p, x):
    return p[0] + x * (p[1] + x * (p[2] + x * p[3]))


def rosen(z):
    return torch.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1.0 - z[:-1]) ** 2)


def config5_inputs():
    """bench.py's config 5 inputs (bench.py:472-490), drawn with numpy at
    its shapes and scales, float32, on the card: x uniform on (−2, 2),
    M = 4096; y the poly-4 of p_true plus 0.01·N(0, 1); p0 = 0; z0 = −1s
    in 128 dimensions."""
    gen = np.random.default_rng(SEED + 20)
    x = gen.uniform(-2.0, 2.0, 4096).astype(np.float32)
    y = (poly4(P_TRUE5, x) + 0.01 * gen.standard_normal(4096)) \
        .astype(np.float32)
    return tuple(torch.from_numpy(v).to(DEVICE) for v in (
        x, y, np.zeros(4, np.float32), -np.ones(128, np.float32)))


def config5_odr(x, y, p0):
    return opt.odr_lm(x, y, poly4, p0, max_iter=40)


def config5_lbfgs(z0):
    return opt.lbfgs_minimize(rosen, z0, max_iter=800)


def phase3_config5(totals):
    """Config 5 at bench.py's full size in float32: odr_lm (the structured
    Schur solver, 40 LM iterations), whose every structured solve runs
    chol_leaf twice (the (4096, 1, 1) blocks Cᵢ and the (1, 4, 4) S), then
    lbfgs_minimize of the 128-d Rosenbrock (800 iterations at most, no
    kernel), each held to bench.py:514's gate; the fit also against the
    same fit in float64 on the card. Returns the inputs, the distinct
    chol_leaf launches of the fit with their counts, and its counts."""
    x, y, p0, z0 = cfg5 = config5_inputs()
    solves = [0]
    solve = tls_mod._solve_structured

    def counted(*args):
        solves[0] += 1
        return solve(*args)

    tls_mod._solve_structured = counted
    try:
        reset_counts()
        host.reads = 0
        (p, dx), mse, g, it = config5_odr(x, y, p0)
        keys = dict(LOG.pending)
        counts = read_counts()
        odr_reads = host.reads
    finally:
        tls_mod._solve_structured = solve
    check_counts("config 5 odr_lm (4096 points, poly-4, 40 iterations)",
                 counts, {"chol_leaf": 2 * solves[0]}, totals)
    err = maxabs(p.cpu() - torch.from_numpy(P_TRUE5))
    check(tuple(p.shape) == (4,) and tuple(dx.shape) == (4096,)
          and p.dtype == torch.float32 and int(it) == 40
          and bool(torch.isfinite(dx).all()) and bool(torch.isfinite(mse))
          and err < 0.05,
          f"config 5 odr_lm: p {p.cpu().numpy()}, {int(it)} iterations, mse "
          f"{float(mse):.6e}, max |p - p_true| = {err:.3e} < 0.05 "
          "(bench.py:514)")
    (p64, _), _, _, _ = opt.odr_lm(x.double(), y.double(), poly4,
                                   p0.double(), max_iter=40)
    gap = maxabs(p.double() - p64)
    check(gap <= 1e-3, f"config 5 odr_lm: max |p - the float64 fit| = "
          f"{gap:.3e} <= 1e-3")
    reset_counts()
    host.reads = 0
    z, fz, gz, itz = config5_lbfgs(z0)
    check_counts("config 5 lbfgs_minimize (128-d Rosenbrock)", read_counts(),
                 {}, totals)
    lbfgs_reads = host.reads
    zerr = maxabs(z - 1.0)
    check(tuple(z.shape) == (128,) and float(fz) < 1e-4 and zerr < 1e-2,
          f"config 5 lbfgs_minimize: f = {float(fz):.3e} < 1e-4 "
          f"(bench.py:514), max |z - 1| = {zerr:.3e} < 1e-2, {int(itz)} "
          "iterations")
    stats = {"odr_iterations": int(it), "odr_reads": odr_reads,
             "structured_solves": solves[0],
             "chol_leaf": counts["chol_leaf"],
             "lbfgs_iterations": int(itz), "lbfgs_reads": lbfgs_reads}
    say(f"config 5: odr_lm {int(it)} iterations, {odr_reads} host reads "
        f"({odr_reads / int(it):.2f} an iteration), {solves[0]} structured "
        f"solves, chol_leaf {counts['chol_leaf']} launches "
        + ", ".join(f"{n} of {list(k[3][0][0])}" for k, n in keys.items())
        + f"; lbfgs_minimize {int(itz)} iterations, {lbfgs_reads} host reads "
        f"({lbfgs_reads / max(int(itz), 1):.2f} an iteration)")
    return cfg5, keys, stats


def eigh_gate(what, a, w, v, panels, totals, more=None):
    """bench.py's config 4 gate max|V·diag(w)·Vᵀ − A| ≤ 1e-4·max|A|·√N
    (bench.py:433-436), w ascending and finite, w against a float64
    eigvalsh on the host, and one sytrd_panel launch per 64 columns (and
    the launches in ``more``)."""
    check_counts(what, read_counts(), {"sytrd_panel": panels} | (more or {}),
                 totals)
    n = a.shape[-1]
    check(tuple(w.shape) == tuple(a.shape[:-1])
          and tuple(v.shape) == tuple(a.shape)
          and bool(torch.isfinite(w).all() and torch.isfinite(v).all())
          and bool((torch.diff(w, dim=-1) >= 0).all()),
          f"{what}: w {tuple(w.shape)} ascending, V {tuple(v.shape)}, "
          "finite")
    amax = maxabs(a)
    tol = 1e-4 * amax * n ** 0.5
    recon = maxabs(torch.matmul(v * w[..., None, :], v.mT) - a)
    check(recon <= tol, f"{what}: max |V·diag(w)·Vᵀ - A| = {recon:.3e} <= "
          f"{tol:.3e} (bench.py:433)")
    orth = maxabs(torch.matmul(v.mT, v) - torch.eye(n, device=DEVICE))
    w64 = np.linalg.eigvalsh(a.double().cpu().numpy())
    werr = float(np.abs(w.double().cpu().numpy() - w64).max())
    check(werr <= tol, f"{what}: max |w - float64 eigvalsh on the host| = "
          f"{werr:.3e} <= {tol:.3e}")
    say(f"{what}: max |VᵀV - I| = {orth:.3e}; w from {float(w.min()):.6e} "
        f"to {float(w.max()):.6e}")
    return recon


def phase3_eigh(totals):
    """Config 4's eigh (bench.py:427-442): la.eigh with method 'auto',
    which takes 'dc' at 1024, on (s + sᵀ)/2 of a seeded normal; and
    eigh_tridiag_dc of the (32, 512, 512) Gram batch."""
    rng = np.random.default_rng(SEED + 4)
    n = 1024
    sym = torch.from_numpy(symmetric(rng, (n, n))).to(DEVICE, torch.float32)
    reset_counts()
    w, v = la.eigh(sym)
    recon = eigh_gate("config 4 eigh (1024, 1024)", sym, w, v, 16, totals)
    say(f"config 4 eigh residual {recon:.3e}; the TPU reference's "
        f"{TPU_EIGH_RESIDUAL:.3e} (BENCH_r05.json)")
    g = gram(rng, (32, 512, 512))
    reset_counts()
    w, v = la.eigh_tridiag_dc(g)
    eigh_gate("eigh_tridiag_dc Gram (32, 512, 512)", g, w, v, 8, totals)
    return sym, g


def gram_launches(n: int) -> dict:
    """What one svd_gram call of a batch of n×n (n = 64·2^k) launched,
    besides its seed's sytrd_panel: 'exact' iterations take n/64 chol_leaf
    leaves each, and a repair one Householder QR of n/128 panels. Read from
    svd_gram's branch counts, reset with the launch counters."""
    b = svd_gram_mod.branches
    say(f"svd_gram took {b['exact']} Cholesky and {b['poly']} series "
        f"iterations, {b['finish']} finishing runs and {b['repair']} U "
        "repairs")
    want = {}
    if b["exact"]:
        want["chol_leaf"] = b["exact"] * (n // 64)
    if b["repair"]:
        want["house_panel"] = b["repair"] * -(-n // 128)
    return want


def svd_gate(what, a, u, sv, v, tpu=None):
    """bench.py's svd gate max|U·diag(σ)·V − A| ≤ 1e-5·max|A|·√N
    (bench.py:322-325); σ sorted, non-negative and within 4·eps·N·σ₀ of a
    float64 SVD on the host (a backward-stable SVD moves σ by at most
    ‖ΔA‖₂, about eps·N·‖A‖₂); U's and V's orthogonality printed."""
    n = a.shape[-1]
    k = sv.shape[-1]
    check(tuple(u.shape) == tuple(a.shape[:-1]) + (k,)
          and tuple(v.shape) == tuple(a.shape[:-2]) + (k, n)
          and bool(torch.isfinite(u).all() and torch.isfinite(sv).all()
                   and torch.isfinite(v).all())
          and bool((sv >= 0).all() and (torch.diff(sv, dim=-1) <= 0).all()),
          f"{what}: U {tuple(u.shape)}, σ {tuple(sv.shape)} descending and "
          f"non-negative, V {tuple(v.shape)}, finite")
    tol = 1e-5 * maxabs(a) * n ** 0.5
    recon = maxabs(torch.matmul(u * sv[..., None, :], v) - a)
    beside = "" if tpu is None else \
        f"; the TPU reference's {tpu:.3e} (BENCH_r05.json)"
    check(recon <= tol, f"{what}: max |U·diag(σ)·V - A| = {recon:.3e} <= "
          f"{tol:.3e} (bench.py:322){beside}")
    sv64 = np.linalg.svd(a.double().cpu().numpy(), compute_uv=False)
    err = float(np.abs(sv.double().cpu().numpy() - sv64).max())
    stol = 4 * torch.finfo(a.dtype).eps * n * float(sv64.max())
    check(err <= stol, f"{what}: max |σ - float64 SVD on the host| = "
          f"{err:.3e} <= {stol:.3e}")
    eye = torch.eye(k, device=DEVICE, dtype=a.dtype)
    say(f"{what}: max |UᵀU - I| = {maxabs(torch.matmul(u.mT, u) - eye):.3e}, "
        f"max |V·Vᵀ - I| = {maxabs(torch.matmul(v, v.mT) - eye):.3e}; σ from "
        f"{float(sv.min()):.6e} to {float(sv.max()):.6e}")
    return recon


def lstsq_gate(what, a, x, y):
    """bench.py's config 3 least-squares gate, the normal equations:
    max|Aᵀ(A·x − y)| ≤ 1e-3·max|A|²·√N (bench.py:418-422)."""
    n = a.shape[-1]
    ne = maxabs(torch.matmul(a.mT, torch.matmul(a, x) - y))
    tol = 1e-3 * maxabs(a) ** 2 * n ** 0.5
    check(ne <= tol, f"{what}: max |Aᵀ(A·x - y)| = {ne:.3e} <= {tol:.3e} "
          "(bench.py:418)")


def config3_inputs(rng):
    """bench.py's config 3 (bench.py:398-404): rank 384 = g1·g2/N of seeded
    normals (8, 512, 384) and (8, 384, 512), and y (8, 512, 2), float32;
    the product on the card at full precision."""
    n, b, rank = 512, 8, 384
    g1 = torch.from_numpy(rng.standard_normal((b, n, rank))).to(DEVICE,
                                                                 torch.float32)
    g2 = torch.from_numpy(rng.standard_normal((b, rank, n))).to(DEVICE,
                                                                 torch.float32)
    y = torch.from_numpy(rng.standard_normal((b, n, 2))).to(DEVICE,
                                                             torch.float32)
    return torch.matmul(g1, g2) / n, y


def jacobi_repair(sv, n) -> bool:
    """Whether svd_jac_1sided's U completion ran: some matrix has its
    smallest σ ≤ eps·N·its largest."""
    eps = torch.finfo(sv.dtype).eps
    return bool((sv.amin(-1) <= eps * n * sv.amax(-1)).any())


def phase3_svd(totals, a, cfg2, sym):
    """The SVD and RRQR paths: the 512² suite's svd (bench.py:319-325),
    config 3 by 'gram' (bench.py:398-425) and by one-sided Jacobi
    (BASELINE.json:9), the Jacobi kernel's default regime through lstsq,
    solve on config 2's systems, rrqr_decomp of the 512² batch, and config
    4's eigh through the SVD."""
    rng = np.random.default_rng(SEED + 5)
    n = a.shape[-1]

    reset_counts()
    u, sv, v = la.svd_decomp(a)
    check_counts("svd_decomp (32, 512, 512)", read_counts(),
                 {"sytrd_panel": 8} | gram_launches(n), totals)
    svd_gate("svd_decomp (32, 512, 512)", a, u, sv, v, TPU_SVD_RECON)

    a3, y3 = config3_inputs(rng)
    reset_counts()
    u, sv, v = la.svd_decomp(a3)
    x = la.svd_lstsq(u, sv, v, y3)
    check_counts("config 3 svd_decomp + svd_lstsq (8, 512, 512)",
                 read_counts(), {"sytrd_panel": 8} | gram_launches(n), totals)
    svd_gate("config 3 (8, 512, 512), rank 384", a3, u, sv, v,
             TPU_CFG3_RECON)
    lstsq_gate("config 3 svd_lstsq", a3, x, y3)
    say(f"config 3: numerical rank {la.svd_rank(sv).tolist()}")

    reset_counts()
    u, sv, v = la.svd_decomp(a3, method="jacobi")
    x = la.svd_lstsq(u, sv, v, y3)
    counts = read_counts()
    sweeps = counts["jacobi_sweeps"]
    say(f"config 3 by one-sided Jacobi took {sweeps} sweeps (at most "
        f"{MAX_SWEEPS})")
    check(1 <= sweeps <= MAX_SWEEPS, f"config 3 Jacobi: {sweeps} sweeps")
    check_counts("config 3 svd_decomp(method='jacobi') + svd_lstsq",
                 counts, {"house_panel": (n // 128) * (
                     2 if jacobi_repair(sv, n) else 1),
                     "jacobi_sweeps": sweeps}, totals)
    svd_gate("config 3 by one-sided Jacobi", a3, u, sv, v, TPU_CFG3_RECON)
    lstsq_gate("config 3 by one-sided Jacobi, svd_lstsq", a3, x, y3)

    gen = torch.Generator().manual_seed(SEED + 6)
    small = torch.randn((1024, 128, 64), generator=gen).to(DEVICE)
    ys = torch.randn((1024, 128, 1), generator=gen).to(DEVICE)
    reset_counts()
    xs = la.lstsq(small, ys)
    counts = read_counts()
    sweeps = counts["jacobi_sweeps"]
    say(f"lstsq (1024, 128, 64) took {sweeps} Jacobi sweeps")
    check(1 <= sweeps <= MAX_SWEEPS, f"lstsq (1024, 128, 64): {sweeps} "
          "sweeps")
    u, sv, v = la.svd_decomp(small)
    check_counts("lstsq (1024, 128, 64)", counts,
                 {"house_panel": 2 if jacobi_repair(sv, 64) else 1,
                  "jacobi_sweeps": sweeps}, totals)
    svd_gate("svd_decomp (1024, 128, 64)", small, u, sv, v)
    lstsq_gate("lstsq (1024, 128, 64)", small, xs, ys)

    spd2, y2 = cfg2
    reset_counts()
    x = la.solve(spd2, y2)
    check_counts("solve (1024, 128, 128)", read_counts(), {"rrqr_kernel": 1},
                 totals)
    square_solve_gate(spd2, x, y2, "config 2 systems by solve (1024, 128, "
                      "128)", "bench.py:392")
    x_ref = torch.from_numpy(np.linalg.solve(spd2.double().cpu().numpy(),
                                             y2.double().cpu().numpy()))
    solve_check("solve against a float64 solve on the host", spd2, y2, x,
                x_ref, torch.float32)

    reset_counts()
    q, r, p = la.rrqr_decomp(a)
    check_counts("rrqr_decomp (32, 512, 512)", read_counts(),
                 {"rrqr_kernel": 1}, totals)
    amax = maxabs(a)
    tol = 1e-5 * amax * n ** 0.5
    ap = torch.gather(a, 2, p.long()[:, None, :].expand(a.shape))
    recon = maxabs(torch.matmul(q, r) - ap)
    check(recon <= tol, f"rrqr_decomp: max |A[:, P] - Q·R| = {recon:.3e} <= "
          f"{tol:.3e}")
    eps = torch.finfo(torch.float32).eps
    orth = maxabs(torch.matmul(q.mT, q) - torch.eye(n, device=DEVICE))
    check(orth <= 4 * eps * n, f"rrqr_decomp: max |QᵀQ - I| = {orth:.3e} "
          f"<= {4 * eps * n:.3e}")
    # |R_jj| non-increasing, up to the rounding of the downdated squared
    # norms that chose the pivots (each within N·eps·‖a_c‖²)
    d2 = torch.diagonal(r, dim1=-2, dim2=-1).double() ** 2
    slack = 2 * n * eps * (a.double() ** 2).sum(-2).amax(-1, keepdim=True)
    rise = float((d2[:, 1:] - d2[:, :-1] - slack).max())
    strict = int((d2[:, 1:] > d2[:, :-1]).sum())
    check(rise <= 0, f"rrqr_decomp: |R_jj|² non-increasing within "
          f"2·N·eps·max‖a_c‖² ({strict} strict rises of {d2.numel()})")

    reset_counts()
    w, vec = la.eigh(sym, method="via_svd")
    more = gram_launches(sym.shape[-1])
    recon = eigh_gate("config 4 eigh(method='via_svd') (1024, 1024)", sym, w,
                      vec, 16, totals, more)
    say(f"config 4 via_svd residual {recon:.3e}; the TPU reference's "
        f"eigh {TPU_EIGH_RESIDUAL:.3e} (BENCH_r05.json)")
    return {"cfg3": (a3, y3), "small": (small, ys)}


@contextlib.contextmanager
def completions(mods):
    """Count the U completions that fire in ``mods``' ``_complete_u``
    (it returns its input unchanged unless it repairs); restored on exit."""
    fired = {"n": 0}
    saved = []
    for mod in mods:
        fn = mod._complete_u

        def counted(u, *args, _fn=fn, **kwargs):
            out = _fn(u, *args, **kwargs)
            fired["n"] += out is not u
            return out

        saved.append((mod, fn))
        mod._complete_u = counted
    try:
        yield fired
    finally:
        for mod, fn in saved:
            mod._complete_u = fn


def check_shown(what: str, want: dict, totals: dict) -> None:
    """check_counts on the counters read now, and the house_panel and
    chol_leaf counts printed."""
    got = read_counts()
    check_counts(what, got, want, totals)
    say(f"{what}: house_panel {got['house_panel']}, chol_leaf "
        f"{got['chol_leaf']} launches, as expected")


def svd_method_launches(method, a, totals, what, tpu=None):
    """svd_decomp(method='dc'|'blocked') on a square batch under svd_gate,
    with its launches checked: 'dc' polishes U and V by one CholeskyQR
    each, 'blocked' V once (chol_leaf n/64 a polish), both methods run
    house_panel n/128 times per U completion that fires, and neither
    launches anything else."""
    n = a.shape[-1]
    mod = svd_dc_mod if method == "dc" else svd_block_mod
    reset_counts()
    with completions([mod]) as fired:
        u, sv, v = la.svd_decomp(a, method=method)
    want = {"house_panel": fired["n"] * -(-n // 128)} if fired["n"] else {}
    want["chol_leaf"] = (2 if method == "dc" else 1) * (n // 64)
    say(f"{what}: {fired['n']} U completions fired")
    check_shown(what, want, totals)
    svd_gate(what, a, u, sv, v, tpu)


def phase3_la_rest(totals, a, cfg2, svd_in):
    """The rest of la: svd_decomp by 'dc' and 'blocked' on the 512² suite's
    batch (bench.py:319-325) and on config 3 (bench.py:398-425);
    bidiag_decomp of config 3; ldl and pldlp on config 2's systems and on
    symmetric indefinite ones of the same shape; the Kogbetliantz and
    classic Jacobi SVDs on (8, 96, 64); and rand's ortho of (32, 512,
    512)."""
    a3, _ = svd_in["cfg3"]
    for method in ("dc", "blocked"):
        svd_method_launches(method, a, totals,
                            f"svd_decomp(method='{method}') (32, 512, 512)",
                            TPU_SVD_RECON)
        svd_method_launches(method, a3, totals,
                            f"config 3 svd_decomp(method='{method}') "
                            "(8, 512, 512)", TPU_CFG3_RECON)

    reset_counts()
    u, b, v = la.bidiag_decomp(a3)
    check_shown("bidiag_decomp (8, 512, 512)", {}, totals)
    n = a3.shape[-1]
    eye = torch.eye(n, device=DEVICE)
    tol = 1e-5 * maxabs(a3) * n ** 0.5
    recon = maxabs(torch.matmul(torch.matmul(u, b), v) - a3)
    otol = 4 * torch.finfo(torch.float32).eps * n
    ou = maxabs(torch.matmul(u.mT, u) - eye)
    ov = maxabs(torch.matmul(v, v.mT) - eye)
    band = torch.triu(torch.tril(torch.ones(n, n, device=DEVICE), 1))
    check(bool((b * (1 - band) == 0).all()), "bidiag_decomp: B upper "
          "bidiagonal")
    check(recon <= tol and ou <= otol and ov <= otol, "bidiag_decomp "
          f"(8, 512, 512): max |U·B·V - A| = {recon:.3e} <= {tol:.3e}, "
          f"max |UᵀU - I| = {ou:.3e} and max |V·Vᵀ - I| = {ov:.3e} <= "
          f"{otol:.3e}")

    spd2, y2 = cfg2
    reset_counts()
    l, d = la.ldl_decomp(spd2)
    x = la.ldl_solve(l, d, y2)
    check_shown("ldl_decomp + ldl_solve (1024, 128, 128)", {}, totals)
    square_solve_gate(spd2, x, y2, "config 2 systems by ldl_decomp + "
                      "ldl_solve (1024, 128, 128)", "bench.py:392")
    gen = torch.Generator().manual_seed(SEED + 16)
    s = torch.randn(spd2.shape, generator=gen).to(DEVICE)
    sym = (s + s.mT) * 0.5
    reset_counts()
    ld, p, blk = la.pldlp_decomp(sym)
    x = la.pldlp_solve(ld, p, blk, y2)
    check_shown("pldlp_decomp + pldlp_solve (1024, 128, 128)", {}, totals)
    say(f"pldlp_decomp (1024, 128, 128) symmetric indefinite: "
        f"{int(blk.sum())} 2×2 pivots")
    # bench.py's residual gate 1e-4·max|A|·√N (bench.py:362) assumes a
    # well-conditioned system: κ₂ of (s + sᵀ)/2 reaches 3e4-7e4 in a batch
    # of 1024, where LAPACK's Bunch-Kaufman (torch.linalg.ldl_factor) and
    # LU miss it too. So the solve is held by its backward error, which
    # does not loosen with κ: ≤ N·eps (solve_check), and x to the library
    # Bunch-Kaufman's within the forward-error estimate. Not also to
    # BACKWARD_MULT × the library's backward error: the JAX package's
    # unblocked Bunch-Kaufman grows elements up to 8× on some systems of
    # this batch (backward error about 27·eps at κ₂ 64, 8.3× LAPACK's)
    x_ref = ldl_yardstick(sym, y2)
    tol = 1e-4 * maxabs(sym) * sym.shape[-1] ** 0.5
    say(f"pldlp_solve: max |A·x - y| = {maxabs(sym @ x - y2):.3e}, "
        f"torch.linalg.ldl_solve's {maxabs(sym @ x_ref - y2):.3e}, against "
        f"bench.py's {tol:.3e} for well-conditioned systems")
    solve_check("pldlp_decomp + pldlp_solve, symmetric indefinite (1024, "
                "128, 128), against torch.linalg.ldl_factor + ldl_solve", sym,
                y2, x, x_ref, torch.float32, mult=None)

    narrow = torch.randn((8, 96, 64), generator=gen).to(DEVICE)
    for what, fn in (("svd_jac_2sided", la.svd_jac_2sided),
                     ("svd_jac_classic", la.svd_jac_classic)):
        reset_counts()
        u, sv, v = fn(narrow)
        check_shown(f"{what} (8, 96, 64)", {"house_panel": 1}, totals)
        svd_gate(f"{what} (8, 96, 64)", narrow, u, sv, v)

    for what, fn in (("RNG(seed).ortho(32, 512, 512)",
                      lambda: rand.RNG(SEED).ortho(32, 512, 512)),
                     ("la.rand_ortho(32, 512, 512)",
                      lambda: la.rand_ortho(32, 512, 512))):
        reset_counts()
        q = fn()
        check_shown(what, {"house_panel": 4}, totals)
        orth = maxabs(torch.matmul(q.mT, q) - torch.eye(512, device=DEVICE))
        check(tuple(q.shape) == (32, 512, 512) and orth <= otol,
              f"{what}: max |QᵀQ - I| = {orth:.3e} <= {otol:.3e}")
    return {"sym": sym, "narrow": narrow}


# ---------------------------------------------------------------- eigen


def hessenberg_blocks(rng, shape):
    """Upper Hessenberg blocks of seeded normals (the kernels' input)."""
    return np.triu(rng.standard_normal(shape), -1)


def chase_input(rng, W, nb, k0, lo, hi, seed):
    """A slide's input as the Schur loop hands it over: a Hessenberg block
    of seeded normals, zero subdiagonals at the window's edges lo and hi,
    and each carried bulge's column B[kb..kb+2, kb−1] equal to its carry;
    the (NB, 2) shifts and the carries (zero when seeded)."""
    off = 3 * (nb - 1)
    b = hessenberg_blocks(rng, (W, W))
    sh = rng.standard_normal((nb, 2))
    p = np.zeros((nb, 3)) if seed else rng.standard_normal((nb, 3))
    for r in (lo - k0 + off, hi - k0 + off):
        if 1 <= r < W:
            b[r, r - 1] = 0.0
    for i in range(0 if seed else nb):
        kb = off - 3 * i
        if lo <= k0 - 3 * i <= hi - 2 and kb >= 1:
            b[kb:kb + 3, kb - 1] = p[i]
    return (torch.from_numpy(x).to(DEVICE, torch.float64)
            for x in (b, p, sh))


def chase_contract(b, v, pp, k0, lo, hi, sl):
    """(junk, carry) of a slide, in float64: the largest entry of
    B' = Vᵀ·B·V below the subdiagonal outside the three bulge entries
    (kb+2, kb), (kb+3, kb), (kb+3, kb+1) of each bulge active at the last
    step, and the largest difference between those bulges' carries and
    their columns B'[kb+1..kb+3, kb]. A V from wrong reflectors leaves B'
    far from Hessenberg, whatever its orthogonality."""
    W, nb = b.shape[-1], pp.shape[0]
    off = 3 * (nb - 1)
    b, v, pp = b.double(), v.double(), pp.double()
    bp = torch.matmul(torch.matmul(v.mT, b), v)
    junk = torch.tril(bp, -2)
    carry = 0.0
    t = sl - 1
    for i in range(nb):
        k, kb = k0 + t - 3 * i, t + off - 3 * i
        if not lo <= k <= hi - 2:
            continue
        for r, c in ((kb + 2, kb), (kb + 3, kb), (kb + 3, kb + 1)):
            if r < W:
                junk[r, c] = 0.0
        for j in range(3):
            want = bp[kb + 1 + j, kb] if kb + 1 + j < W and (
                j < 2 or k + 3 < hi) else 0.0
            carry = max(carry, abs(float(pp[i, j] - want)))
    return maxabs(junk), carry


def chase_layout(W, nb, sl, dtype) -> str:
    ld, nref, nupd, nacc, v_sm, smem = bc.plan(W, nb, sl, dtype)
    return (f"ld {ld}, warps {nref} reflector + {nupd} update + {nacc} "
            f"accumulator, V_acc in {'shared' if v_sm else 'global'} memory, "
            f"{smem} B")


def schur_layout(W, dtype) -> str:
    ld, nwarps, q_sm, smem = ss.plan(W, dtype)
    return (f"ld {ld}, warps {nwarps} for T + {nwarps} for Q, Q in "
            f"{'shared' if q_sm else 'global'} memory, {smem} B")


def phase2_chase(rng, errs, dtype):
    """bulge_chase_steps at the main path's window W = 128: the multishift
    slide NB = 16 seeded (k0 = lo) and carried (mid-sweep), and the classic
    NB = 1. The full slide by its contract (chase_contract within
    CHASE_C·eps·W·max|B|, V_acc orthogonal within SCHUR_C·eps·W); its
    first CHASE_SHORT steps entry by entry, V_acc within TOL and the
    carries within TOL·max(1, max|P|)."""
    W = 128
    eps = torch.finfo(dtype).eps
    for nb, k0, seed in ((16, 0, True), (16, 80, False), (1, 0, True)):
        lo, hi = 0, W - 2
        b, p, sh = (x.to(dtype) for x in
                    chase_input(rng, W, nb, k0, lo, hi, seed))
        unit = CHASE_C * eps * W * maxabs(b)
        what = f"bulge_chase_steps W={W} NB={nb} k0={k0} {dtype}"
        for sl in (W - 3 * nb, CHASE_SHORT):
            v, pp = bc.bulge_chase_steps(b, p, sh, k0, lo, hi, sl, seed)
            vr, pr = bc.bulge_chase_steps_ref(b, p, sh, k0, lo, hi, sl, seed)
            junk, carry = chase_contract(b, v, pp, k0, lo, hi, sl)
            orth = maxabs(torch.matmul(v.mT, v) - torch.eye(
                W, device=DEVICE, dtype=dtype))
            ev, ep = maxabs(v - vr), maxabs(pp - pr)
            check(junk <= unit and carry <= unit
                  and orth <= SCHUR_C * eps * W,
                  f"{what} SL={sl} [{chase_layout(W, nb, sl, dtype)}]: "
                  f"junk below the subdiagonal of VᵀBV "
                  f"{junk:.3e}, carries against its bulge columns "
                  f"{carry:.3e}, each <= {unit:.3e}; max |VᵀV - I| = "
                  f"{orth:.3e} <= {SCHUR_C * eps * W:.3e}")
            if sl == CHASE_SHORT:
                tp_ = TOL[dtype] * max(1.0, maxabs(pr))
                check(ev <= TOL[dtype] and ep <= tp_,
                      f"{what} SL={sl}: max |V_acc - plain| = {ev:.3e} <= "
                      f"{TOL[dtype]:.0e}, max |P - plain| = {ep:.3e} <= "
                      f"{tp_:.3e}")
                if dtype == torch.float32:
                    errs["bulge_chase_steps"] = max(
                        errs["bulge_chase_steps"], ev)
            else:
                say(f"{what} SL={sl}: max |V_acc - plain| = {ev:.3e}, "
                    f"max |P - plain| = {ep:.3e} (not compared: rounding "
                    "amplified by the train)")


def schur_contract(what, a, t, q, lk, dtype):
    """Per matrix, in float64: QᵀQ = I, Q·T·Qᵀ = A and the junk below the
    subdiagonal within SCHUR_C·eps·W (·max|A|), every locked flag on a 2×2
    block with complex eigenvalues."""
    a, t, q = a.double(), t.double(), q.double()
    nb, W, _ = a.shape
    unit = SCHUR_C * torch.finfo(dtype).eps * W
    amax = a.abs().amax((-2, -1)).clamp(min=1.0)
    eye = torch.eye(W, device=a.device, dtype=torch.float64)
    orth = (torch.matmul(q.mT, q) - eye).abs().amax((-2, -1))
    sim = (torch.matmul(torch.matmul(q, t), q.mT) - a).abs().amax((-2, -1))
    junk = torch.tril(t, -2).abs().amax((-2, -1))
    check(bool((orth <= unit).all() and (sim <= unit * amax).all()
               and (junk <= unit * amax).all()),
          f"{what}: max |QᵀQ - I| = {float(orth.max()):.3e}, max |Q·T·Qᵀ - A|"
          f"/max|A| = {float((sim / amax).max()):.3e}, junk below the "
          f"subdiagonal/max|A| = {float((junk / amax).max()):.3e}, each <= "
          f"{unit:.3e}")
    m, j = torch.nonzero(lk[:, :W - 1] > 0.5, as_tuple=True)
    aa, bb = t[m, j, j], t[m, j, j + 1]
    cc, dd = t[m, j + 1, j], t[m, j + 1, j + 1]
    disc = (aa - dd) ** 2 + 4 * bb * cc
    check(bool((disc < 0).all()), f"{what}: all {len(m)} locked flags sit on "
          "2×2 blocks with complex eigenvalues")


def eigvals_host(t):
    """Eigenvalues of each quasi-triangular T (cleaned below the
    subdiagonal), in float64 on the host."""
    return np.linalg.eigvals(np.triu(t.double().cpu().numpy(), -1))


def matched_gap(lam, ref):
    """Largest distance in a greedy nearest matching of two sets."""
    ref = list(ref)
    worst = 0.0
    for w in lam:
        d = np.abs(np.asarray(ref) - w)
        i = int(np.argmin(d))
        worst = max(worst, float(d[i]))
        ref.pop(i)
    return worst


def phase2_schur_small(rng, errs, dtype):
    """schur_small at the AED window (1, 48, 48), small_win's (1, 128, 128)
    and the batched whole-matrix route (256, 64, 64). Rounding may flip a
    deflation decision, so the kernel is held to its contract and its
    eigenvalues to the plain version's (run on a host copy of the same
    input, the first SCHUR_SAMPLE matrices of the batch), nearest to
    nearest within 1e3·eps·W·max|A| plus 4 times the plain version's own
    distance to float64 eigenvalues of A; where both took the same number
    of rounds, their largest entrywise difference is printed."""
    eps = torch.finfo(dtype).eps
    for shape in ((1, 48, 48), (1, 128, 128), (256, 64, 64)):
        W = shape[-1]
        what = f"schur_small {shape} {dtype} [{schur_layout(W, dtype)}]"
        a = torch.from_numpy(hessenberg_blocks(rng, shape)).to(DEVICE, dtype)
        t, q, lk, its = ss.schur_small(a)
        schur_contract(what, a, t, q, lk, dtype)
        m = min(shape[0], SCHUR_SAMPLE)
        tr, qr, lkr, itr = ss.schur_small_ref(a[:m].cpu())
        worst = 0.0
        for i in range(m):
            ai = a[i].double().cpu().numpy()
            truth = np.linalg.eigvals(ai)
            lam_k, lam_p = eigvals_host(t[i]), eigvals_host(tr[i])
            own = matched_gap(lam_p, truth)
            gap = matched_gap(lam_k, lam_p)
            tol = 1e3 * eps * W * max(1.0, np.abs(ai).max()) + 4 * own
            check(gap <= tol, f"{what} matrix {i}: eigenvalues within "
                  f"{gap:.3e} <= {tol:.3e} of the plain version's (its own "
                  f"distance to float64: {own:.3e})")
            worst = max(worst, gap)
        same = (its[:m].cpu() == itr).nonzero()[:, 0]
        diff = max((maxabs(t[i].cpu() - tr[i]) for i in same.tolist()),
                   default=float("nan"))
        say(f"{what}: rounds {its.tolist()[:m]} (plain {itr.tolist()}); "
            f"{len(same)} of {m} took as many rounds as the plain version, "
            f"max |T - plain| over those {diff:.3e}; locked "
            f"{int(lk.sum())}, iterations {int(its.sum())} in all")
        if dtype == torch.float32:
            errs["schur_small"] = max(errs["schur_small"], worst)


def triangular_pair(rng, n, cluster, dtype):
    """A split-complex upper triangular (1, n, n) of seeded normals, with a
    cluster of three equal diagonal entries (5, 10, 70) when asked, its
    diagonal and the xTREVC thresholds as schur_eigen sets them."""
    tre = np.triu(rng.standard_normal((n, n)))
    tim = np.triu(rng.standard_normal((n, n)))
    if cluster:
        for i in (10, 70):
            tre[i, i], tim[i, i] = tre[5, 5], tim[5, 5]
    tre, tim = (torch.from_numpy(x)[None].to(DEVICE, dtype)
                for x in (tre, tim))
    fi = torch.finfo(dtype)
    small = fi.eps * torch.sqrt((tre ** 2 + tim ** 2).sum((-2, -1))) + fi.tiny
    return (tre, tim, torch.diagonal(tre, dim1=-2, dim2=-1),
            torch.diagonal(tim, dim1=-2, dim2=-1), small,
            fi.max ** 0.5 / n)


def unit_columns(x):
    nrm = torch.sqrt((x[0] ** 2 + x[1] ** 2).sum(-2, keepdim=True))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return x[0] / nrm, x[1] / nrm


def unit_gap(x, y) -> float:
    """max |x − y| over both parts of two split-complex unit-column sets,
    in float64."""
    return max(maxabs(x[0].double() - y[0].double()),
               maxabs(x[1].double() - y[1].double()))


def phase2_trevc(rng, errs, dtype):
    """trevc_solve at config 4's n = 1024 and at 192 with a defective
    cluster, the columns compared after normalising each (columns are
    defined up to scale). float64: within TOL of the plain version's.
    float32: the back substitution amplifies rounding by up to ~10³ eps
    in both versions alike, so the kernel is held to a float64 witness
    (the plain version in float64 on the same rounded input and
    thresholds, as tools/trevc_witness.py runs it): its distance to the
    witness within max(TOL, TREVC_C × the float32 plain version's)."""
    for n, cluster in ((1024, False), (192, True)):
        args = triangular_pair(rng, n, cluster, dtype)
        tiles = tv.card_plan(1, n, dtype, args[0].device)
        say(f"trevc_solve (1, {n}, {n}) {dtype}: the plan's {len(tiles)} "
            f"tiles, widths {tiles[0][1]} at the right to "
            f"{max(w for _, w in tiles)}")
        xk = unit_columns(tv.trevc_solve(*args))
        xr = unit_columns(tv.trevc_solve_ref(*args))
        err = unit_gap(xk, xr)
        what = (f"trevc_solve (1, {n}, {n}) {dtype}"
                f"{' with a cluster of three' if cluster else ''}")
        if dtype == torch.float64:
            check(err <= TOL[dtype], f"{what}: max |x - plain| over unit "
                  f"columns = {err:.3e} <= {TOL[dtype]:.0e}")
            continue
        wide = [a.double() if torch.is_tensor(a) else a for a in args]
        xw = unit_columns(tv.trevc_solve_ref(*wide))
        kw, pw = unit_gap(xk, xw), unit_gap(xr, xw)
        tol = max(TOL[dtype], TREVC_C * pw)
        check(kw <= tol, f"{what}: max |x - float64 witness| over unit "
              f"columns = {kw:.3e} <= {tol:.3e} = max({TOL[dtype]:.0e}, "
              f"{TREVC_C} x the plain version's {pw:.3e}); kernel against "
              f"plain {err:.3e}")
        errs["trevc_solve"] = max(errs["trevc_solve"], err)
    # a bignum of 30: many columns rescaled, several times a block, on the
    # plan's tiles and on tiles of 1 and of W_MAX
    args = list(triangular_pair(np.random.default_rng(SEED + 14), 192, True,
                                dtype))
    args[-1] = 30.0
    xr = unit_columns(tv.trevc_solve_ref(*args))
    wide = [a.double() if torch.is_tensor(a) else a for a in args]
    pw = unit_gap(xr, unit_columns(tv.trevc_solve_ref(*wide)))
    plan = tv.card_plan(1, 192, dtype, args[0].device)
    for name, tiles in (("the plan", plan), ("tiles of 1", uniform_tiles(192, 1)),
                        (f"tiles of {tv.W_MAX}",
                         uniform_tiles(192, tv.W_MAX))):
        xk = unit_columns(tv._trevc_solve_in(*args, tiles))
        err = unit_gap(xk, xr)
        tol = TOL[dtype] if dtype == torch.float64 else \
            max(TOL[dtype], TREVC_C * pw)
        check(err <= tol, f"trevc_solve (1, 192, 192) {dtype}, bignum 30, "
              f"{name} ({len(tiles)} tiles): max |x - plain| over unit "
              f"columns = {err:.3e} <= {tol:.3e}")


def uniform_tiles(n, w):
    """Tiles of w columns from the right (the leftmost narrower), as the
    kernel takes them."""
    return tuple((max(0, k1 - w), k1 - max(0, k1 - w))
                 for k1 in range(n, 0, -w))


def phase2_eigen(rng, errs):
    for dtype in (torch.float32, torch.float64):
        phase2_chase(rng, errs, dtype)
        phase2_schur_small(rng, errs, dtype)
        phase2_trevc(rng, errs, dtype)


def schur_launches() -> dict:
    """What a Schur loop launched, from its branch counts (reset with the
    launch counters): schur_small once per AED call and per small_win,
    bulge_chase_steps once per window slide."""
    b = schur_mod.branches
    say(f"Schur loop: {b['iterations']} iterations, {b['aed']} AED calls "
        f"({b['sweep']} followed by a sweep), {b['small_win']} small_win, "
        f"{b['standardize2']} standardize2, {b['chase']} classic chases, "
        f"{b['slides']} slides; refinement on {b['refine']} matrices")
    want = {}
    if b["aed"] + b["small_win"]:
        want["schur_small"] = b["aed"] + b["small_win"]
    if b["slides"]:
        want["bulge_chase_steps"] = b["slides"]
    return want


def eigen_gate(what, a, lam, vec):
    """bench.py's config 4 gate per matrix, max‖A·v − λ·v‖ ≤
    1e-4·max|A|·√N (bench.py:446-455), in split-complex arithmetic with
    float64 products; finite values of the expected shapes and unit
    columns. Returns the largest residual."""
    lr, li = (x.double() for x in lam)
    vr, vi = (x.double() for x in vec)
    n = a.shape[-1]
    check(tuple(lr.shape) == tuple(a.shape[:-1]) == tuple(li.shape)
          and tuple(vr.shape) == tuple(a.shape) == tuple(vi.shape)
          and all(bool(torch.isfinite(x).all()) for x in (lr, li, vr, vi)),
          f"{what}: λ {tuple(lr.shape)}, V {tuple(vr.shape)}, finite")
    a64 = a.double()
    lr, li = lr[..., None, :], li[..., None, :]
    er = torch.matmul(a64, vr) - (vr * lr - vi * li)
    ei = torch.matmul(a64, vi) - (vr * li + vi * lr)
    resid = torch.sqrt(er ** 2 + ei ** 2).amax((-2, -1))
    tol = 1e-4 * a.abs().amax((-2, -1)).double() * n ** 0.5
    w = int(torch.argmax(resid / tol))
    check(bool((resid <= tol).all()),
          f"{what}: max ‖A·v - λ·v‖ = {float(resid.max()):.3e}, worst "
          f"matrix {w}: {float(resid.reshape(-1)[w]):.3e} <= "
          f"{float(tol.reshape(-1)[w]):.3e} (bench.py:446)")
    unit = ((vr ** 2 + vi ** 2).sum(-2) - 1).abs().max()
    check(float(unit) <= 1e-4, f"{what}: unit columns, max |‖v‖² - 1| = "
          f"{float(unit):.3e}")
    return float(resid.max())


def phase3_eigen(totals):
    """Config 4's eigen (bench.py:444-457) on one 1024² float32 matrix of
    standard normals from numpy (bench.py draws the same shape with
    jax.random), schur_decomp of its balanced form, and eigen of a (256,
    64, 64) batch: the whole-matrix schur_small route, one launch."""
    rng = np.random.default_rng(SEED + 7)
    n = 1024
    s = torch.from_numpy(rng.standard_normal((n, n))).to(DEVICE,
                                                          torch.float32)
    reset_counts()
    lam, vec = la.eigen(s, split=True)
    counts = read_counts()
    check_counts("config 4 eigen (1024, 1024)", counts,
                 schur_launches() | {"trevc_solve": 1}, totals)
    check(counts["schur_small"] >= 1 and counts["bulge_chase_steps"] >= 1,
          "config 4 eigen launched schur_small and bulge_chase_steps")
    say("config 4 eigen: the refinement pass "
        + ("fired" if schur_mod.branches["refine"] else "did not fire"))
    resid = eigen_gate("config 4 eigen (1024, 1024)", s, lam, vec)
    say(f"config 4 eigen residual {resid:.3e}; the TPU reference's "
        f"{TPU_EIGEN_RESIDUAL:.3e} (BENCH_r05.json)")
    lam64 = np.linalg.eigvals(s.double().cpu().numpy())
    gap = matched_gap(lam[0].double().cpu().numpy()
                      + 1j * lam[1].double().cpu().numpy(), lam64)
    say(f"config 4 eigen: eigenvalues within {gap:.3e} of float64 eigvals "
        "on the host (nearest matching; printed, not gated)")
    _, bal = la.eigen_balance_pre(s)
    reset_counts()
    q, t = la.schur_decomp(bal)
    check_counts("schur_decomp of config 4's balanced matrix", read_counts(),
                 schur_launches(), totals)
    bmax = maxabs(bal)
    recon = maxabs(torch.matmul(torch.matmul(q.double(), t.double()),
                                q.double().mT) - bal.double())
    orth = maxabs(torch.matmul(q.double().mT, q.double())
                  - torch.eye(n, device=DEVICE, dtype=torch.float64))
    eps = torch.finfo(torch.float32).eps
    sub = torch.diagonal(t, -1) != 0
    check(recon <= 1e-4 * bmax * n ** 0.5 and orth <= SCHUR_C * eps * n
          and maxabs(torch.tril(t, -2)) == 0.0
          and not bool((sub[:-1] & sub[1:]).any()),
          f"schur_decomp (1024, 1024): max |Q·T·Qᵀ - B| = {recon:.3e} <= "
          f"{1e-4 * bmax * n ** 0.5:.3e}, max |QᵀQ - I| = {orth:.3e} <= "
          f"{SCHUR_C * eps * n:.3e}, T quasi-triangular; "
          f"{schur_mod.branches['iterations']} outer iterations")
    ab = torch.from_numpy(rng.standard_normal((256, 64, 64))).to(
        DEVICE, torch.float32)
    reset_counts()
    lam, vec = la.eigen(ab, split=True)
    check_counts("eigen (256, 64, 64)", read_counts(), schur_launches()
                 | {"schur_small": 1}, totals)
    eigen_gate("eigen (256, 64, 64)", ab, lam, vec)
    return s, ab


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


def sytrd_panel_cost(c, bk: int):
    """(flops, bytes) of one sytrd_panel call on c (Nb, m, m), as the kernel
    does it: per column j the correction of rows j.. (4·j·(m − j)), the
    product with C of rows j + 1.. (2·m·(m − j − 1)), Wᵀv and Vᵀv
    (4·j·(m − j − 1)), their corrections (4·j·m) and O(m) for the
    reflector and w; then the upper triangle of the trailing block, 4·bk + 2
    each. Bytes: C read once, the trailing block, V, W, taus, d and e
    written once."""
    nb, m, _ = c.shape
    flops = sum(4 * j * (m - j) + 2 * m * (m - j - 1) + 4 * j * (m - j - 1)
                + 4 * j * m + 8 * m for j in range(bk))
    mt = m - bk
    flops += (4 * bk + 2) * mt * (mt + 1) // 2
    nbytes = c.element_size() * (m * m + mt * mt + 2 * m * bk + 3 * bk)
    return nb * flops, nb * nbytes


@contextlib.contextmanager
def host_timers(targets):
    """Replace each (module, name) function by one that synchronises
    around every call and adds its host milliseconds to spent[name];
    restore them on exit."""
    spent = {name: 0.0 for _, name in targets}
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def timed(*args, _fn=fn, _name=name, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[_name] += (time.perf_counter() - t0) * 1e3
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield spent
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def host_breakdown(what, fn, parts, top, warm: bool = True):
    """Where one call of ``fn`` spends its time, by host clock with a
    synchronise around each of ``parts`` ((module, function, label)); the
    rest is the whole less the parts named in ``top`` (the others nest
    inside those). A warm-up call first, unless ``warm`` is False (``fn``
    ran already)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    with host_timers([(mod, name) for mod, name, _ in parts]) as spent:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    rest = total - sum(spent[name] for name in top)
    say(f"{what} breakdown, host ms: whole {total:.3f}; "
        + "; ".join(f"{label} {spent[name]:.3f}" for _, name, label in parts)
        + f"; the rest {rest:.3f}")


def wall_ms(fn, runs: int = 3, warm: bool = True):
    """Host-clock milliseconds of ``fn`` to a synchronised end, ``runs``
    times after one warm-up call (none when ``warm`` is False)."""
    if warm:
        fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def jacobi_cost(w):
    """(flops, bytes) of one sweep on W (Nb, M, n) with V (Nb, n, n): n − 1
    rounds of n/2 pairs, each reducing apq (2M) and rotating two columns
    of W and of V (6M + 6n), plus the norms at the start (2Mn); W and V
    read once and written once."""
    nb, m, n = w.shape
    flops = (n - 1) * (n // 2) * (8 * m + 6 * n) + 2 * m * n
    return nb * flops, nb * 2 * (m * n + n * n) * w.element_size()


def rrqr_cost(a):
    """(flops, bytes) of the pivoted factorisation of A (Nb, M, N):
    4MNK − 2K²(M + N) + 4K³/3 for the reflectors and their application
    (the norms and the downdates are lower order); A read once, R_packed,
    V, taus and perm written once."""
    nb, m, n = a.shape
    k = min(m, n)
    flops = 4 * m * n * k - 2 * k * k * (m + n) + 4 * k ** 3 / 3
    nbytes = a.element_size() * (2 * m * n + m * k + k) + 4 * n
    return nb * flops, nb * nbytes


def fill(pat, idx, axis) -> int:
    """Entries that a transform of the rows (axis 0) or the columns (axis
    1) idx of a sparsity pattern must update, per row or column: the union
    of their nonzeros, which the transform then fills in."""
    if axis == 0:
        u = pat[idx].any(0)
        pat[idx] = u
    else:
        u = pat[:, idx].any(1)
        pat[:, idx] = u[:, None]
    return int(u.sum())


def chase_cost(b, nb, sl, k0, lo, hi):
    """(flops, bytes) of one slide on the block b: each active (bulge,
    step) reflector updates the nonzero columns of three rows of B (about
    W − kb + 1 of a Hessenberg block with its bulges), then the nonzero
    rows of three columns of B (kb + 4) and of V_acc, followed on their
    sparsity patterns; 10 flops for each 3-entry update, 6 for the 2-entry
    one at k = hi − 2. B read once, V_acc and the carries written once."""
    W = b.shape[-1]
    off = 3 * (nb - 1)
    bp = (b != 0).cpu().numpy()
    vp = np.eye(W, dtype=bool)
    flops = 0
    for t in range(sl):
        act = [(t + off - 3 * i, 2 if k0 + t - 3 * i == hi - 2 else 3)
               for i in range(nb) if lo <= k0 + t - 3 * i <= hi - 2]
        for kb, m in act:
            flops += (10 if m == 3 else 6) * fill(bp, slice(kb, kb + m), 0)
            if kb >= 1:
                bp[kb + 1:kb + m, kb - 1] = False      # annihilated
        for kb, m in act:
            cols = slice(kb, kb + m)
            flops += (10 if m == 3 else 6) * (fill(bp, cols, 1)
                                              + fill(vp, cols, 1))
    return flops, b.element_size() * (2 * W * W + 6 * nb)


def schur_small_cost(a):
    """(flops, bytes, steps) of schur_small on a, along the trajectory its
    plain version takes on the same input; steps: the most chase steps of
    one matrix (the launch's dependent chain). 2·W² flops a round
    (‖T‖_F); per chase step
    at k over [lo, hi), 10 flops for each of T's W − k + 1 columns in
    three rows (W − k at k = lo), its min(k + 4, hi) rows in three
    columns and the nonzero rows of Q's three columns (followed on Q's
    sparsity pattern); per 2×2 rotation at k, 6 flops for each of
    W − k + 1 columns (W − k for a standardisation), k + 2 rows of T and
    Q's nonzero rows. A read once, T, Q and the locks written once."""
    nb, W, _ = a.shape
    flops = steps = 0
    for m in a.cpu():
        _, _, _, rounds, moves = ss._schur_small_one(m, 40 * W)
        flops += rounds * 2 * W * W
        steps = max(steps, sum(hi - lo - 2 for lo, hi in moves))
        qp = np.eye(W, dtype=bool)
        for lo, hi in moves:
            if hi - lo > 2:
                for k in range(lo, hi - 2):
                    flops += 10 * (W - k + (k > lo) + min(k + 4, hi)
                                   + fill(qp, slice(k, k + 3), 1))
            k = hi - 2
            flops += 6 * (W - k + (hi - lo > 2) + k + 2
                          + fill(qp, slice(k, k + 2), 1))
    return flops, a.element_size() * nb * (3 * W * W + W), steps


def trevc_cost(n, size):
    """(flops, bytes) of trevc_solve: Σ_k Σ_{i<k} (k − i) complex
    multiply-adds (8 flops each) and a Smith division per entry above the
    diagonal; Tc and λ read once, x written once."""
    macs = sum(k * (k + 1) // 2 for k in range(n))
    return 8 * macs + 12 * n * (n - 1) // 2, size * (4 * n * n + 2 * n)


def eigen_kernel_inputs(s):
    """The three kernels' inputs at config 4's shapes, from its balanced
    Hessenberg matrix: the AED window (1, 48, 48), small_win's (1, 128,
    128), the first multishift slide's block with the AED window's 16
    shifts, and the triangular Tc of its Schur form."""
    _, bal = la.eigen_balance_pre(s)
    h = schur_mod._hessenberg_core(bal[None])[0]
    n = h.shape[-1]
    win48 = h[:, n - 48:, n - 48:].contiguous()
    win128 = h[:, n - 128:, n - 128:].contiguous()
    tw = ss.schur_small(win48)[0][0]
    re, im = schur_mod._block_eigvals_reim(
        torch.where(torch.ones_like(tw).triu(-1) > 0, tw, 0.0))
    rr, ri = re[-32:], im[-32:]
    shifts = torch.stack([rr[0::2] + rr[1::2],
                          rr[0::2] * rr[1::2] - ri[0::2] * ri[1::2]], 1)
    q, t = la.schur_decomp(bal)
    _, tc, lam = schur_mod._complex_triangularize_reim(q[None], t[None])
    fi = torch.finfo(t.dtype)
    small = fi.eps * torch.sqrt((tc[0] ** 2 + tc[1] ** 2).sum((-2, -1))) \
        + fi.tiny
    trevc_in = (tc[0], tc[1], lam[0], lam[1], small, fi.max ** 0.5 / n)
    return win48, win128, h[0, :128, :128].contiguous(), shifts, trevc_in


def eigen_rows(counts, errs, s, ab):
    """The kernels line's rows of schur_small, bulge_chase_steps and
    trevc_solve at config 4's shapes, the batch's schur_small beside them.
    No single PyTorch call computes a multishift slide, the real Schur form
    of a small block or xTREVC: library_ms is null."""
    win48, win128, blk, shifts, trevc_in = eigen_kernel_inputs(s)
    W, nb = 128, 16
    sl = W - 3 * nb
    p0 = torch.zeros((nb, 3), device=DEVICE)
    size = blk.element_size()
    rows = []
    c48 = schur_small_cost(win48)
    for name, src, repl, kern, plain, plain_iters, cost, shape, steps in (
            ("schur_small", "nd4js_tpu_torch/csrc/schur_small.cu",
             "nd4js_tpu/ops/schur_small.py:249",
             lambda: ss.schur_small(win48), lambda: ss.schur_small_ref(win48),
             1, c48[:2], list(win48.shape), c48[2]),
            ("bulge_chase_steps", "nd4js_tpu_torch/csrc/bulge_chase.cu",
             "nd4js_tpu/ops/bulge_chase.py:236",
             lambda: bc.bulge_chase_steps(blk, p0, shifts, 0, 0, W - 2, sl,
                                          True),
             lambda: bc.bulge_chase_steps_ref(blk, p0, shifts, 0, 0, W - 2,
                                              sl, True),
             2, chase_cost(blk, nb, sl, 0, 0, W - 2), [W, W, nb, sl], sl),
            ("trevc_solve", "nd4js_tpu_torch/csrc/trevc_solve.cu",
             "nd4js_tpu/ops/trevc_solve.py:164",
             lambda: tv.trevc_solve(*trevc_in),
             lambda: tv.trevc_solve_ref(*trevc_in), 2,
             trevc_cost(trevc_in[0].shape[-1], size),
             list(trevc_in[0].shape), None)):
        t_bound, by = bound(*cost)
        row = {"name": name, "route": "cuda", "source": src, "replaces": repl,
               "launches": counts[name], "max_abs_err": errs[name],
               "ms": cuda_ms(kern, 10),
               "plain_ms": cuda_ms(plain, plain_iters),
               "bound_ms": t_bound, "bound_by": by, "library_ms": None,
               "shape": shape, "dtype": "float32"}
        if steps:
            # the dependent chain: a slide's SL steps, the window's chase
            # steps along the plain version's trajectory
            row |= {"steps": steps, "step_ms": row["ms"] / steps}
        say(f"{name} {shape}: kernel {row['ms']:.4f} ms"
            + (f" ({steps} dependent steps, {row['step_ms'] * 1e3:.3f} µs a "
               "step)" if steps else "")
            + f", plain {row['plain_ms']:.4f} ms, library none, bound "
            f"{t_bound:.6f} ms ({by})")
        rows.append(row)
    rows[-1].update(trevc_breakdown(trevc_in))
    # schur_small also at small_win's block and at the whole-matrix route's
    # batch of 64² Hessenberg matrices (its bound from the plain version's
    # work on SCHUR_SAMPLE of them, scaled to the batch)
    _, bal = la.eigen_balance_pre(ab)
    hb = schur_mod._hessenberg_core(bal)[0].contiguous()
    fl, nbytes, hb_steps = schur_small_cost(hb[:SCHUR_SAMPLE])
    scale = hb.shape[0] / SCHUR_SAMPLE
    others = []
    for a, cost, plain_iters in ((win128, schur_small_cost(win128), 1),
                                 (hb, (fl * scale, nbytes * scale, hb_steps),
                                  0)):
        t_bound, by = bound(*cost[:2])
        other = {"shape": list(a.shape),
                 "ms": cuda_ms(lambda x=a: ss.schur_small(x), 5),
                 "bound_ms": t_bound, "bound_by": by, "steps": cost[2]}
        other["step_ms"] = other["ms"] / cost[2]
        if plain_iters:
            other["plain_ms"] = cuda_ms(lambda x=a: ss.schur_small_ref(x),
                                        plain_iters)
        others.append(other)
        say(f"schur_small {other['shape']}: kernel {other['ms']:.4f} ms "
            f"({cost[2]} dependent steps, {other['step_ms'] * 1e3:.3f} µs a "
            f"step), plain {other.get('plain_ms', float('nan')):.4f} ms, "
            f"bound {t_bound:.6f} ms ({by})"
            + ("" if plain_iters else f", estimated from {SCHUR_SAMPLE} of "
               f"{a.shape[0]} matrices (steps: the slowest of them); plain "
               "not timed"))
    per_sm = ss.blocks_per_sm(hb.shape[-1], hb.dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"schur_small {list(hb.shape)}: {ss.plan(hb.shape[-1], hb.dtype)} "
        f"(ld, warps a group, Q in shared memory, bytes); {per_sm} blocks an "
        f"SM, {per_sm * sms} on the card at once: "
        + ("one wave" if hb.shape[0] <= per_sm * sms else
           f"{-(-hb.shape[0] // (per_sm * sms))} waves"))
    rows[0]["other_shapes"] = others
    return rows


def eigen_walls(s, ab):
    _, bal = la.eigen_balance_pre(s)
    # one run each, phase 3's calls their warm-up (cut from a warm-up and
    # three runs to keep the script under 700 s)
    wall = {"config 4 eigen (1024, 1024)":
            wall_ms(lambda: la.eigen(s, split=True), 1, False),
            "schur_decomp (1024, 1024)":
                wall_ms(lambda: la.schur_decomp(bal), 1, False),
            "eigen (256, 64, 64)": wall_ms(lambda: la.eigen(ab, split=True))}
    for what, x in (("(1024, 1024)", s), ("(256, 64, 64)", ab)):
        try:
            wall[f"torch.linalg.eig {what}, yardstick"] = \
                wall_ms(lambda x=x: torch.linalg.eig(x))
        except Exception as exc:      # a yardstick, not a check
            say(f"torch.linalg.eig {what} on the card: {type(exc).__name__}")
    parts = [(eigen_mod, "eigen_balance_pre", "balancing"),
             (schur_mod, "_hessenberg_core", "Hessenberg"),
             (schur_mod, "_schur_loop", "Schur loop"),
             (schur_mod, "_aed", "of which AED"),
             (schur_mod, "_chase_multishift", "of which sweeps and chases"),
             (schur_mod, "_small_win", "of which small_win"),
             (schur_mod, "_standardize2", "of which standardize2"),
             (schur_mod, "_complex_triangularize_reim", "triangularisation"),
             (schur_mod, "trevc_solve", "trevc_solve"),
             (schur_mod, "_trevc_refine", "refinement"),
             (schur_mod, "_back_transform", "final GEMM")]
    top = ("eigen_balance_pre", "_hessenberg_core", "_schur_loop",
           "_complex_triangularize_reim", "trevc_solve", "_trevc_refine",
           "_back_transform")
    reset_counts()
    host_breakdown("config 4 eigen (1024, 1024)",
                   lambda: la.eigen(s, split=True), parts, top)
    b = schur_mod.branches
    say(f"config 4 eigen breakdown's two calls: {b['iterations']} Schur "
        f"iterations, {b['aed']} AED, {b['sweep']} sweeps, {b['small_win']} "
        f"small_win, {b['standardize2']} standardize2, {b['chase']} classic "
        f"chases, {b['slides']} slides, refinement on {b['refine']}")
    return wall


def gesv_breakdown(a3, y3) -> dict:
    """qr_gesv at config 1 in float32 by cluster size: the whole launch
    (the wrapper's scratch already built), the elimination alone and the
    back substitution alone (on [R | Qᵀy] from the plain elimination,
    checked against the plain solve), CUDA events each. The shared regime
    leaves its scratch as it was, so one scratch serves every launch."""
    n, k = a3.shape[-1], y3.shape[-1]
    buf = torch.cat([a3, y3], -1)
    hs._stripe_body_ref(buf, n)
    done = hs._gesv_scratch(buf[:, :, :n].contiguous(),
                            buf[:, :, n:].contiguous())
    work = hs._gesv_scratch(a3, y3)
    x = torch.empty_like(y3)
    plan = hs.gesv_plan(a3, y3)
    out = {"plan": hs.regime(*plan), "clusters": {}}
    for c in hs.CLUSTER_SIZES:
        if hs.smem_bytes(n, n + 4, n, k, c, True, a3.dtype) > _build.SMEM_MAX:
            continue
        hs._launch_gesv(done, x, k, c, True, 2)
        solve_check(f"qr_gesv back substitution alone, cluster of {c}", a3, y3,
                    x, hs.qr_gesv_ref(a3, y3), a3.dtype)
        t = {"ms": cuda_ms(lambda: hs._launch_gesv(work, x, k, c, True), 20),
             "elimination_ms":
                 cuda_ms(lambda: hs._launch_gesv(work, x, k, c, True, 1), 20),
             "back_substitution_ms":
                 cuda_ms(lambda: hs._launch_gesv(done, x, k, c, True, 2), 20)}
        out["clusters"][c] = t
        say(f"qr_gesv (1, {n}, {n}) K={k} float32, shared memory, cluster of "
            f"{c}: launch {t['ms']:.4f} ms, elimination alone "
            f"{t['elimination_ms']:.4f} ms, back substitution alone "
            f"{t['back_substitution_ms']:.4f} ms")
    t = cuda_ms(lambda: hs._launch_gesv(work.clone(), x, k, 4, False), 10)
    clone = cuda_ms(lambda: work.clone(), 10)
    out["global_regime_cluster_4_ms"] = t - clone
    say(f"qr_gesv (1, {n}, {n}) K={k} float32, global memory, cluster of 4: "
        f"{t - clone:.4f} ms (a scratch copy of {clone:.4f} ms taken off)")
    return out


def stripe_breakdown(a) -> dict:
    """house_stripe_t on the headline's (32, 512, 128) panel by cluster
    size, and on each of its four panel shapes in the plan's regime."""
    panel = a[:, :, :128].contiguous()
    out = {"plan": hs.regime(*hs.stripe_plan(panel)), "clusters": {}}
    for c in hs.CLUSTER_SIZES:
        if hs.smem_bytes(512, 128, 128, 0, c, True, panel.dtype) \
                > _build.SMEM_MAX:
            continue
        out["clusters"][c] = cuda_ms(
            lambda: hs._house_stripe_t_in(panel, c, True), 10)
        say(f"house_stripe_t (32, 512, 128) float32, shared memory, cluster "
            f"of {c}: {out['clusters'][c]:.4f} ms")
    out["panels_ms"] = [cuda_ms(lambda p=a[:, k:, k:k + 128].contiguous():
                                hs.house_stripe_t(p), 5)
                        for k in range(0, 512, 128)]
    say("house_stripe_t on the headline's panels (32, 512|384|256|128, 128) "
        "ms: " + ", ".join(f"{t:.4f}" for t in out["panels_ms"])
        + f"; sum {sum(out['panels_ms']):.4f}")
    return out


def house_breakdown(a) -> dict:
    """house_panel on the headline's four panel shapes in the plan's
    regime: the call (the shared regime loads the row-major panel
    straight into its slabs), the same through the column-major scratch,
    the kernel alone on a scratch built once (the shared regime leaves it
    as it was) and the scratch copy alone."""
    out = {"panels": []}
    for k in range(0, 512, 128):
        p = a[:, k:, k:k + 128].contiguous()
        nb, m, b = p.shape
        c, sh = hs.stripe_plan(p)
        work = hs._panel_scratch(p)
        t = {"shape": [nb, m, b], "plan": hs.regime(c, sh),
             "ms": cuda_ms(lambda: hp.house_panel(p), 10),
             "through_scratch_ms": cuda_ms(lambda: hs._stripe_panel(
                 p, c, sh, "house_panel", False), 10),
             "kernel_on_scratch_ms": cuda_ms(lambda: hs._launch_panel(
                 work, m, b, c, sh, "house_panel"), 10),
             "scratch_ms": cuda_ms(lambda: hs._panel_scratch(p), 10)}
        out["panels"].append(t)
        say(f"house_panel ({nb}, {m}, {b}) float32 ({t['plan']}): call "
            f"{t['ms']:.4f} ms; through the scratch {t['through_scratch_ms']:.4f}"
            f" ms, of it the kernel {t['kernel_on_scratch_ms']:.4f} ms and "
            f"the copy {t['scratch_ms']:.4f} ms "
            f"({100 * t['scratch_ms'] / t['through_scratch_ms']:.1f}%)")
    return out


def sytrd_breakdown(c4, cg) -> dict:
    """sytrd_panel's column loop and trailing update apart (stages 1 and
    2), at config 4's first panel and the Gram batch's, in the plan's
    launch and on every cluster size that places the panel."""
    out = {"split": {}, "clusters": {}}
    bk = 64
    for what, c in (("(1, 1024, 1024)", c4), ("Gram (32, 512, 512)", cg)):
        nb, m, _ = c.shape
        bufs = (c.new_empty((nb, m - bk, m - bk)), c.new_empty((nb, bk, m)),
                c.new_empty((nb, bk, m)), c.new_empty((nb, bk)),
                c.new_empty((nb, bk)), c.new_empty((nb, bk)))
        plans = [sp.card_plan(nb, m, bk, c.dtype, c.device)]
        plans += [sp.launch_on(m, bk, c.dtype, cl)
                  for cl in sp.placeable_sizes(m, bk, c.dtype)]
        for i, plan in enumerate(plans):
            sp._launch(c, *bufs, plan)   # V and W for the update alone
            t = {"plan": sp.regime(*plan, m),
                 "ms": cuda_ms(lambda: sp._launch(c, *bufs, plan), 10),
                 "column_loop_ms": cuda_ms(
                     lambda: sp._launch(c, *bufs, plan, 1), 10),
                 "update_ms": cuda_ms(lambda: sp._launch(c, *bufs, plan, 2),
                                      10)}
            t["step_us"] = 1e3 * t["column_loop_ms"] / bk
            t["resident_clusters"] = sp.resident_clusters(plan, c.dtype)
            if i == 0:
                out["split"][what] = t
            else:
                out["clusters"].setdefault(what, {})[plan[0]] = t
            say(f"sytrd_panel {what} bk={bk} float32 ({t['plan']}, the card "
                f"holds {t['resident_clusters']} such clusters at once"
                f"{', the plan' if i == 0 else ''}): launch {t['ms']:.4f} ms,"
                f" column loop alone {t['column_loop_ms']:.4f} ms "
                f"({t['step_us']:.3f} µs a step), trailing update alone "
                f"{t['update_ms']:.4f} ms")
    return out


def jacobi_rrqr_breakdown(wj, wl, spd2, a) -> dict:
    """jacobi_sweeps (one sweep) and rrqr_kernel at the main path's shapes
    in the plan's launch and, at the 512² shapes, in every other launch the
    plan can choose (each cluster size; for the sweeps V in shared and in
    global memory), with the clusters the card holds at once and µs a
    dependent round or step of one wave."""
    out = {"jacobi_sweeps": {}, "rrqr_kernel": {}}
    dev = torch.device(DEVICE)
    for w in (wj, wl):
        nb, m, n = w.shape
        v = torch.eye(n, device=DEVICE).repeat(nb, 1, 1)
        plan = js.card_plan(nb, m, n, w.dtype, dev)
        plans = [plan] + ([js.launch_on(m, n, w.dtype, *p)
                           for p in js.placements(m, n, w.dtype)]
                          if plan[0] != 1 else [])
        for p in dict.fromkeys(plans):
            ms = cuda_ms(lambda p=p: js._jacobi_in(w, v, 1, p), 5)
            held = js.resident_clusters(p, w.dtype)
            waves = -(-nb // held)
            out["jacobi_sweeps"][f"{tuple(w.shape)} {js.regime(*p)}"] = {
                "ms": ms, "plan": p == plan, "resident_clusters": held,
                "waves": waves, "round_us": 1e3 * ms / waves / (n - 1)}
            say(f"jacobi_sweeps {tuple(w.shape)} float32 ({js.regime(*p)}"
                f"{', the plan' if p == plan else ''}; the card holds {held} "
                f"such clusters at once: {waves} waves): {ms:.4f} ms a sweep, "
                f"{1e3 * ms / waves / (n - 1):.3f} µs a round of a wave")
    for x in (spd2, a):
        nb, m, n = x.shape
        plan = rk.card_plan(nb, m, n, x.dtype, dev)
        plans = [plan] + ([rk.launch_on(m, n, x.dtype, c)
                           for c in rk.placements(m, n, x.dtype)]
                          if plan[0] != 1 else [])
        for p in dict.fromkeys(plans):
            ms = cuda_ms(lambda p=p: rk._rrqr_in(x, p), 5)
            held = rk.resident_clusters(p, x.dtype)
            waves = -(-nb // held)
            out["rrqr_kernel"][f"{tuple(x.shape)} {rk.regime(*p, n)}"] = {
                "ms": ms, "plan": p == plan, "resident_clusters": held,
                "waves": waves, "step_us": 1e3 * ms / waves / min(m, n)}
            say(f"rrqr_kernel {tuple(x.shape)} float32 ({rk.regime(*p, n)}"
                f"{', the plan' if p == plan else ''}; the card holds {held} "
                f"such clusters at once: {waves} waves): {ms:.4f} ms, "
                f"{1e3 * ms / waves / min(m, n):.3f} µs a step of a wave")
    return out


def launch_ms(key) -> float:
    """Device ms of one distinct launch of the log on the arguments it was
    first given, restored before every run (a kernel may work in place),
    less the restore."""
    fn_name = key[1]
    device, saved = LOG.first[key]
    work = [a.clone() if isinstance(a, torch.Tensor) else a for a in saved]
    pairs = [(w, a) for w, a in zip(work, saved)
             if isinstance(a, torch.Tensor)]

    def restore():
        for w, a in pairs:
            w.copy_(a)

    def run():
        restore()
        _build.launch(fn_name, device, *work)

    return cuda_ms(run, 3) - cuda_ms(restore, 3)


def launch_totals() -> dict:
    """Each distinct launch of the main path (LOG) timed once on the
    arguments it was first given, restored before every run (a kernel may
    work in place), less the restore; each kernel's device ms over the
    main path is the sum over its distinct launches of count × ms."""
    per = {k: {"main_path_ms": 0.0, "main_path_launches": 0,
               "main_path_distinct": 0} for k in KERNELS}
    for key, n in LOG.count.items():
        name = key[0]
        saved = LOG.first[key][1]
        ms = launch_ms(key)
        row = per[name]
        row["main_path_ms"] += n * ms
        row["main_path_launches"] += n
        row["main_path_distinct"] += 1
        shapes = [list(a.shape) if isinstance(a, torch.Tensor) else a
                  for a in saved if not isinstance(a, torch.Tensor)
                  or a.ndim >= 2]
        row.setdefault("distinct", []).append(
            {"shapes": shapes, "count": n, "ms": ms})
    for name, row in per.items():
        say(f"{name}: {row['main_path_launches']} launches on the main path, "
            f"{row['main_path_distinct']} distinct, "
            f"{row['main_path_ms']:.4f} ms of device time in all (each "
            "distinct launch timed once)")
        # the launches that carry the kernel's time, heaviest first
        heavy = sorted(row.get("distinct", []),
                       key=lambda d: -d["count"] * d["ms"])
        row["distinct"] = heavy[:DISTINCT_SHOWN]
        for d in row["distinct"]:
            say(f"  {name} {d['shapes']}: {d['count']} launches, "
                f"{d['ms']:.4f} ms each, {d['count'] * d['ms']:.4f} ms")
        if len(heavy) > DISTINCT_SHOWN:
            rest = heavy[DISTINCT_SHOWN:]
            say(f"  {name}: {len(rest)} more distinct launches, "
                f"{sum(d['count'] for d in rest)} launches, "
                f"{sum(d['count'] * d['ms'] for d in rest):.4f} ms")
    return per


def lu_breakdown(a, spd2, y2):
    """lu_panel on lu_decomp's four panel shapes (32, 512|384|256|128, 128)
    in every placement its plan can choose (cluster size, rows in shared or
    in global memory; the clusters of each the card holds at once, the
    plan's marked), and lu_gesv at config 2 in every layout, float32, CUDA
    events each. Returns (lu_panel's rows, lu_gesv's rows)."""
    dev = torch.device(DEVICE)
    panels, total = [], 0.0
    for k0 in range(0, a.shape[-1], 128):
        p = a[:, k0:, k0:k0 + 128].contiguous()
        nb, m, b = p.shape
        plan = lp.card_plan(nb, m, b, p.dtype, dev)
        holds = dict(lp._resident_on(m, b, p.dtype,
                                     torch.cuda.current_device()))
        row = {"shape": [nb, m, b], "plan": lp.regime(*plan, m), "by": []}
        for place in lp.placements(m, b, p.dtype):
            launch = lp.launch_on(m, b, p.dtype, *place)
            ms = cuda_ms(lambda: lp._lu_panel_in(p, launch), 5)
            row["by"].append({"cluster": place[0], "shared": place[1],
                              "resident": holds[place], "ms": ms,
                              "plan": launch == plan})
            if launch == plan:
                row["ms"] = ms
        total += row["ms"]
        say(f"lu_panel {row['shape']} float32, plan {row['plan']}: "
            f"{row['ms']:.4f} ms; by placement (cluster, memory, held at "
            "once: ms): " + ", ".join(
                f"{d['cluster']} {'shared' if d['shared'] else 'global'} "
                f"{d['resident']}: {d['ms']:.4f}" for d in row["by"]))
        panels.append(row)
    say(f"lu_panel on lu_decomp's four panels in their plans: {total:.4f} ms")
    gesv = []
    for launch in lp.gesv_layouts(spd2.shape[-1], y2.shape[-1], spd2.dtype):
        ms = cuda_ms(lambda: lp._lu_gesv_in(spd2, y2, launch), 10)
        gesv.append({"layout": lp.LAYOUTS[launch[0]], "threads": launch[1],
                     "smem": launch[2], "ms": ms})
        say(f"lu_gesv {list(spd2.shape) + [y2.shape[-1]]} float32, "
            f"{lp.LAYOUTS[launch[0]]} ({launch[1]} threads, {launch[2]} "
            f"bytes a block): {ms:.4f} ms")
    return {"panels": panels, "panels_ms": total}, {"by_layout": gesv}


def chol_leaf_cost(leaf):
    """(flops, bytes) of chol_leaf with L⁻¹ on a float32 batch (Nb, n, n):
    n³/3 for the factor and as many for the inverse; A's lower triangle
    read, L and L⁻¹ written dense."""
    lb, ln = leaf.shape[0], leaf.shape[-1]
    return lb * 2 / 3 * ln ** 3, 4 * lb * (ln * (ln + 1) // 2 + 2 * ln * ln)


def chol_leaf_rows(leaf, spd512) -> dict:
    """chol_leaf's device time at config 2's leaf without the host's share,
    and its times at the leaf shapes that carry most of its main-path
    launches: the 512² batch's (32, 64, 64) and a batch of one as eigh
    via_svd's, both with L⁻¹, each beside the library's Cholesky and
    triangular inverse and the bound."""
    out = {"device_ms": graph_ms(lambda: cl.chol_leaf(leaf, True)),
           "other_shapes": []}
    say(f"chol_leaf {list(leaf.shape)}: device {out['device_ms']:.4f} ms "
        "(graph replay, no host share)")
    for x in (spd512[:, :64, :64].contiguous(),
              spd512[:1, :64, :64].contiguous()):
        t_bound, by = bound(*chol_leaf_cost(x))
        eye = torch.eye(64, device=DEVICE).expand(x.shape)
        other = {
            "shape": list(x.shape), "with_inv": True,
            "warps": cl.card_plan(x.shape[0], 64, x.dtype, True, x.device),
            "ms": cuda_ms(lambda x=x: cl.chol_leaf(x, True), 20),
            "device_ms": graph_ms(lambda x=x: cl.chol_leaf(x, True)),
            "plain_ms": cuda_ms(lambda x=x: cl.chol_leaf_ref(x, True), 3),
            "library_ms": cuda_ms(
                lambda x=x, e=eye: torch.linalg.solve_triangular(
                    torch.linalg.cholesky(x), e, upper=False), 20),
            "bound_ms": t_bound, "bound_by": by}
        out["other_shapes"].append(other)
        say(f"chol_leaf {other['shape']} with L⁻¹ ({other['warps']} warps): "
            f"kernel {other['ms']:.4f} ms through the wrapper, device "
            f"{other['device_ms']:.4f} ms, plain {other['plain_ms']:.4f} ms, "
            f"library {other['library_ms']:.4f} ms, bound {t_bound:.6f} ms "
            f"({by})")
    # the device time of each layout the plan chooses from, at the three
    # leaf batches, with and without L⁻¹
    out["by_warps"] = {}
    for x in (leaf, spd512[:, :64, :64].contiguous(),
              spd512[:1, :64, :64].contiguous()):
        for inv in (True, False):
            key = f"{list(x.shape)} inv={inv}"
            out["by_warps"][key] = {
                w: graph_ms(lambda x=x, inv=inv, w=w:
                            cl._chol_leaf_in(x, inv, w)) for w in cl.WARPS}
            say(f"chol_leaf {key}, device ms by warps a block: "
                + ", ".join(f"{w}: {t:.4f}"
                            for w, t in out["by_warps"][key].items())
                + f"; the plan takes "
                f"{cl.card_plan(x.shape[0], 64, x.dtype, inv, x.device)}")
    return out


def trevc_breakdown(trevc_in) -> dict:
    """trevc_solve at config 4's shape on the plan's tiles (uniform, of
    tv.TILE columns) and on uniform tiles of 1, 2 and 8 columns; on the
    plan's tiles also the contractions alone (stages 1) and the
    recurrences alone on unit sums (stages 2)."""
    n = trevc_in[0].shape[-1]
    plan = tv.card_plan(1, n, trevc_in[0].dtype, trevc_in[0].device)
    out = {}
    for name, tiles, stages in (
            ("plan", plan, 3), ("plan, contractions alone", plan, 1),
            ("plan, recurrences alone", plan, 2),
            ("tiles of 1", uniform_tiles(n, 1), 3),
            ("tiles of 2", uniform_tiles(n, 2), 3),
            ("tiles of 8", uniform_tiles(n, 8), 3)):
        out[name] = {"tiles": len(tiles), "ms": cuda_ms(
            lambda t=tiles, st=stages: tv._trevc_solve_in(*trevc_in, t, st),
            10)}
        say(f"trevc_solve (1, {n}, {n}) {name}: {len(tiles)} tiles, "
            f"{out[name]['ms']:.4f} ms")
    return {"by_tiling": out}


def torch_lbfgs(z0):
    """torch.optim.LBFGS with its strong-Wolfe line search on the
    Rosenbrock from z0, to max|g| ≤ 1e-8 or 800 iterations with a memory of
    8, as lbfgs_minimize runs: a yardstick the port never calls."""
    z = z0.clone().requires_grad_(True)
    o = torch.optim.LBFGS([z], lr=1, max_iter=800, history_size=8,
                          tolerance_grad=1e-8, line_search_fn="strong_wolfe")

    def closure():
        o.zero_grad()
        f = rosen(z)
        f.backward()
        return f

    o.step(closure)
    return z.detach(), o.state[z]["n_iter"]


def device_busy(fn):
    """(device ms, wall ms) of one call of ``fn`` under torch.profiler,
    after a warm-up: the device time of every kernel and copy it ran, and
    the host clock around it, the profiler's own cost included. The device
    ms is None when the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies) only, as torch's table adds
    # them: a CPU op's self device time is its kernels' time over again
    dev = sum(e.self_device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)) / 1e3
    return (dev or None), wall


def config5_times(cfg5):
    """Config 5's wall times: the ODR fit, the L-BFGS run and
    torch.optim.LBFGS on the same Rosenbrock (one run each, each warmed by
    its earlier call); host breakdowns of each; the host reads an iteration over the timed
    runs; the device's busy share over the fit and over 100 L-BFGS
    iterations (torch.profiler); and the time of the fit's chol_leaf
    launches, each distinct launch on its first arguments: by CUDA events as
    launch_totals times it (``ms``; at these sizes the launch's host time)
    and on the device alone (``device_ms``, a CUDA graph of 20 launches).
    Returns (walls, chol_leaf's config 5 part)."""
    (x, y, p0, z0), keys, stats = cfg5
    per = []
    for k, n in keys.items():
        device, saved = LOG.first[k]
        work = [a.clone() if isinstance(a, torch.Tensor) else a
                for a in saved]
        per.append({"shapes": list(k[3][0][0]), "dtype": k[3][0][1],
                    "count": n, "ms": launch_ms(k),
                    "device_ms": graph_ms(lambda k=k, d=device, w=work:
                                          _build.launch(k[1], d, *w))})
    part = {"launches": sum(d["count"] for d in per),
            "ms": sum(d["count"] * d["ms"] for d in per),
            "device_ms": sum(d["count"] * d["device_ms"] for d in per),
            "distinct": per} | stats
    say(f"chol_leaf on config 5's fit: {part['launches']} launches, "
        f"{part['ms']:.4f} ms by events, {part['device_ms']:.4f} ms on the "
        "device alone: " + ", ".join(
            f"{d['shapes']} {d['count']} x ({d['ms']:.4f}, "
            f"{d['device_ms']:.4f}) ms" for d in per))
    zt, n_iter = torch_lbfgs(z0)
    say(f"torch.optim.LBFGS on config 5's Rosenbrock: f = "
        f"{float(rosen(zt)):.3e} after {n_iter} iterations")
    host.reads = 0
    # one run, phase 3's its warm-up (a warm-up and three runs until the
    # script neared its deadline)
    wall = {"config 5 odr_lm (4096 points, 40 iterations)":
                wall_ms(lambda: config5_odr(x, y, p0), 1, False)}
    odr_reads = host.reads
    host.reads = 0
    # phase 3's run was the warm-up; one run (three until the script
    # neared its deadline), at 8-15 s a run
    wall["config 5 lbfgs_minimize (128-d Rosenbrock)"] = \
        wall_ms(lambda: config5_lbfgs(z0), 1, False)
    lbfgs_reads = host.reads
    part["reads_an_iteration"] = {
        "odr_lm": odr_reads / stats["odr_iterations"],
        "lbfgs_minimize": lbfgs_reads / stats["lbfgs_iterations"]}
    say(f"config 5 host reads a run over the timed runs: odr_lm "
        f"{odr_reads:.0f} ({odr_reads / stats['odr_iterations']:.2f} an "
        f"iteration), lbfgs_minimize {lbfgs_reads:.0f} "
        f"({lbfgs_reads / stats['lbfgs_iterations']:.2f} an iteration)")
    part["busy"] = {}
    for what, fn in (("odr_lm", lambda: config5_odr(x, y, p0)),
                     ("lbfgs_minimize, 100 iterations",
                      lambda: opt.lbfgs_minimize(rosen, z0, max_iter=100))):
        dev, ms = device_busy(fn)
        part["busy"][what] = {"device_ms": dev, "wall_ms": ms}
        say(f"config 5 {what} under torch.profiler: "
            + ("no device time seen, busy share not measured" if dev is None
               else f"kernels and copies {dev:.3f} ms on the device of "
               f"{ms:.3f} ms "
               f"wall, busy share {dev / ms:.3f} (a lower bound: the "
               "profiler's own host time is in the wall)"))
    # the yardstick once, its call above the warm-up (config 5's two
    # paths together, the sum of the two walls above, is no longer run)
    wall |= {"torch.optim.LBFGS (128-d Rosenbrock), yardstick":
             wall_ms(lambda: torch_lbfgs(z0), 1, False)}
    host_breakdown(
        "config 5 odr_lm", lambda: config5_odr(x, y, p0),
        [(odr_mod, "tls_more_lambda_step",
          "Newton step and λ iteration"),
         (tls_mod, "_solve_structured", "of which structured solves"),
         (tls_mod, "_chol_core", "of which Cholesky (chol_leaf)"),
         (odr_mod, "_jx", "∂f/∂x by jvp")],
        ("tls_more_lambda_step", "_jx"))
    host_breakdown(
        "config 5 lbfgs_minimize", lambda: config5_lbfgs(z0),
        [(lbfgs_mod, "lbfgs_hv", "two-loop H·g"),
         (lbfgs_mod, "wolfe_line_search", "line search with f and ∇f"),
         (lbfgs_mod, "lbfgs_update", "curvature pair")],
        ("lbfgs_hv", "wolfe_line_search", "lbfgs_update"), warm=False)
    return wall, part


def ldl_yardstick(a, y):
    """torch.linalg.ldl_factor + ldl_solve, the yardstick of ldl and
    pldlp (Bunch-Kaufman in LAPACK's sytrf)."""
    ld, piv = torch.linalg.ldl_factor(a)
    return torch.linalg.ldl_solve(ld, piv, y)


def la_rest_walls(a, a3, spd2, y2, svd_in) -> dict:
    """Walls of phase3_la_rest's configurations, one run each (three
    until the script neared its deadline), phase 3's call on the same
    input its warm-up; their SVD yardsticks are the torch.linalg.svd
    walls of the same batches above."""
    sym, narrow = svd_in["sym"], svd_in["narrow"]

    def wall(fn):
        return wall_ms(fn, 1, False)

    def ldl():
        l, d = la.ldl_decomp(spd2)
        return la.ldl_solve(l, d, y2)

    def pldlp():
        return la.pldlp_solve(*la.pldlp_decomp(sym), y2)

    return {
        "svd_decomp(method='dc') (32, 512, 512)":
            wall(lambda: la.svd_decomp(a, method="dc")),
        "svd_decomp(method='blocked') (32, 512, 512)":
            wall(lambda: la.svd_decomp(a, method="blocked")),
        "config 3 svd_decomp(method='dc') (8, 512, 512)":
            wall(lambda: la.svd_decomp(a3, method="dc")),
        "config 3 svd_decomp(method='blocked') (8, 512, 512)":
            wall(lambda: la.svd_decomp(a3, method="blocked")),
        "bidiag_decomp (8, 512, 512)": wall(lambda: la.bidiag_decomp(a3)),
        "ldl_decomp + ldl_solve (1024, 128, 128)": wall(ldl),
        "pldlp_decomp + pldlp_solve indefinite (1024, 128, 128)":
            wall(pldlp),
        # 5-7 s a call: one run each, phase 3's call of the second its
        # warm-up
        "torch.linalg.ldl_factor + ldl_solve indefinite (1024, 128, 128), "
        "yardstick": wall_ms(lambda: ldl_yardstick(sym, y2), 1, False),
        "torch.linalg.ldl_factor + ldl_solve (1024, 128, 128), yardstick":
            wall_ms(lambda: ldl_yardstick(spd2, y2), 1, False),
        "svd_jac_2sided (8, 96, 64)":
            wall(lambda: la.svd_jac_2sided(narrow)),
        "svd_jac_classic (8, 96, 64)":
            wall(lambda: la.svd_jac_classic(narrow)),
        "RNG(seed).ortho (32, 512, 512)":
            wall(lambda: rand.RNG(SEED).ortho(32, 512, 512))}


def phase4(counts, errs, batch, cfg1, cfg2, spd512, eig, svd_in, geig,
           cfg5):
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
    eye_leaf = torch.eye(64, device=DEVICE).expand(leaf.shape)
    cl_flops, cl_bytes = chol_leaf_cost(leaf)
    lp_flops = nb * (m * bw ** 2 - bw ** 3 / 3)
    lp_bytes = nb * (4 * 2 * m * bw + 4 * m)   # panel in and out, rank
    gb, gn = spd2.shape[0], spd2.shape[-1]
    gk = y2.shape[-1]
    lg_flops = gb * (2 / 3 * gn ** 3 + 2 * gn ** 2 * gk)
    lg_bytes = 4 * gb * (gn * (gn + gk) + gn * gk)
    # sytrd_panel: the first panel of config 4's eigh and of the Gram
    # batch's, each as sytrd gives it, (A + Aᵀ)/2
    sym, g = eig
    c4 = ((sym + sym.mT) * 0.5)[None].contiguous()
    cg = ((g + g.mT) * 0.5).contiguous()
    sp_flops, sp_bytes = sytrd_panel_cost(c4, 64)
    # jacobi_sweeps: the first sweep of the small SVD path, on Rᵀ of its
    # pre-QR, (1024, 64, 64); config 3's Jacobi at (8, 512, 512) below
    small, _ = svd_in["small"]
    wj = qr_mod._qr_house_flat(small, True)[1].mT.contiguous()
    vj = torch.eye(64, device=DEVICE).repeat(wj.shape[0], 1, 1)
    js_flops, js_bytes = jacobi_cost(wj)
    # rrqr_kernel: config 2's systems, as solve gives them
    rk_flops, rk_bytes = rrqr_cost(spd2)
    rows = []
    for name, src, repl, kern, plain, lib, flops, nbytes, shape in (
            ("house_panel", "nd4js_tpu_torch/csrc/house_stripe.cu",
             "nd4js_tpu/ops/house_panel.py:71",
             lambda: hp.house_panel(panel), lambda: hp.house_panel_ref(panel),
             lambda: torch.geqrf(panel), hp_flops, hp_bytes,
             list(panel.shape)),
            ("qr_gesv", "nd4js_tpu_torch/csrc/house_stripe.cu",
             "nd4js_tpu/ops/house_stripe.py:206",
             lambda: hs.qr_gesv(a3, y3), lambda: hs.qr_gesv_ref(a3, y3),
             lambda: torch.linalg.solve(a3, y3), gs_flops, gs_bytes,
             list(a3.shape) + [k]),
            # the drop-in for house_panel: the same work, the same bound
            ("house_stripe_t", "nd4js_tpu_torch/csrc/house_stripe.cu",
             "nd4js_tpu/ops/house_stripe.py:273",
             lambda: hs.house_stripe_t(panel),
             lambda: hs.house_stripe_t_ref(panel),
             lambda: torch.geqrf(panel), hp_flops, hp_bytes,
             list(panel.shape)),
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
             list(spd2.shape) + [gk]),
            # no single PyTorch call computes a latrd panel: library_ms null
            ("sytrd_panel", "nd4js_tpu_torch/csrc/sytrd_panel.cu",
             "nd4js_tpu/ops/sytrd_panel.py:138",
             lambda: sp.sytrd_panel(c4, 64), lambda: sp.sytrd_panel_ref(c4, 64),
             None, sp_flops, sp_bytes, list(c4.shape) + [64]),
            # no single PyTorch call computes one Jacobi sweep
            ("jacobi_sweeps", "nd4js_tpu_torch/csrc/jacobi_sweep.cu",
             "nd4js_tpu/ops/jacobi_sweep.py:122",
             lambda: js.jacobi_sweeps(wj, vj, 1),
             lambda: js.jacobi_sweeps_ref(wj, vj, 1), None, js_flops,
             js_bytes, list(wj.shape)),
            # nor a column-pivoted QR (PyTorch has no geqp3)
            ("rrqr_kernel", "nd4js_tpu_torch/csrc/rrqr.cu",
             "nd4js_tpu/ops/rrqr_kernel.py:114",
             lambda: rk.rrqr_kernel(spd2), lambda: rk.rrqr_kernel_ref(spd2),
             None, rk_flops, rk_bytes, list(spd2.shape))):
        t_bound, by = bound(flops, nbytes)
        row = {"name": name, "route": "cuda", "source": src, "replaces": repl,
               "launches": counts[name], "max_abs_err": errs[name],
               "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 3),
               "bound_ms": t_bound, "bound_by": by,
               "library_ms": cuda_ms(lib, 10) if lib else None,
               "shape": shape, "dtype": "float32"}
        lib_txt = "none" if lib is None else f"{row['library_ms']:.4f} ms"
        say(f"{name} {shape}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib_txt}, "
            f"bound {t_bound:.5f} ms ({by})")
        rows.append(row)
    by_name = {row["name"]: row for row in rows}
    by_name["qr_gesv"].update(gesv_breakdown(a3, y3))
    by_name["house_stripe_t"].update(stripe_breakdown(a))
    by_name["house_panel"].update(house_breakdown(a))
    by_name["sytrd_panel"].update(sytrd_breakdown(c4, cg))
    by_name["chol_leaf"].update(chol_leaf_rows(leaf, spd512))
    lu_rows = lu_breakdown(a, spd2, y2)
    by_name["lu_panel"].update(lu_rows[0])
    by_name["lu_gesv"].update(lu_rows[1])
    # sytrd_panel also at the Gram batch's first panel, jacobi_sweeps at
    # config 3's Rᵀ (clusters of 16), rrqr_kernel at the 512² batch
    a3, _ = svd_in["cfg3"]
    wl = qr_mod._qr_house_flat(a3, True)[1].mT.contiguous()
    vl = torch.eye(512, device=DEVICE).repeat(wl.shape[0], 1, 1)
    for name, shape, cost, kern, plain, iters in (
            ("sytrd_panel", list(cg.shape) + [64], sytrd_panel_cost(cg, 64),
             lambda: sp.sytrd_panel(cg, 64),
             lambda: sp.sytrd_panel_ref(cg, 64), 10),
            ("jacobi_sweeps", list(wl.shape), jacobi_cost(wl),
             lambda: js.jacobi_sweeps(wl, vl, 1),
             lambda: js.jacobi_sweeps_ref(wl, vl, 1), 3),
            ("rrqr_kernel", list(a.shape), rrqr_cost(a),
             lambda: rk.rrqr_kernel(a), lambda: rk.rrqr_kernel_ref(a), 3)):
        t_bound, by = bound(*cost)
        other = {"shape": shape, "ms": cuda_ms(kern, iters),
                 "plain_ms": cuda_ms(plain, 2), "bound_ms": t_bound,
                 "bound_by": by}
        by_name[name]["other_shapes"] = [other]
        say(f"{name} {shape}: kernel {other['ms']:.4f} ms, plain "
            f"{other['plain_ms']:.4f} ms, bound {t_bound:.5f} ms ({by})")
    for name, per in jacobi_rrqr_breakdown(wj, wl, spd2, a).items():
        by_name[name]["by_launch"] = per
    rows += eigen_rows(counts, errs, *geig)
    main = launch_totals()
    for row in rows:
        row.update(main[row["name"]])

    a, y = batch

    def headline():
        q, r = la.qr_decomp(a)
        return la.qr_lstsq(q, r, y)

    wall = {"qr_decomp + qr_lstsq": wall_ms(headline),
            "config 1 qr_lstsq_fused (256, 256)":
                wall_ms(lambda: la.qr_lstsq_fused(a1, y1)),
            "config 2": wall_ms(lambda: config2(spd2, y2)),
            "lu_decomp": wall_ms(lambda: la.lu_decomp(a)),
            "cholesky_decomp": wall_ms(lambda: la.cholesky_decomp(spd512)),
            "qr_decomp(method='auto')":
                wall_ms(lambda: la.qr_decomp(a, method="auto")),
            "config 4 eigh (1024, 1024)": wall_ms(lambda: la.eigh(sym)),
            "torch.linalg.eigh (1024, 1024), yardstick":
                wall_ms(lambda: torch.linalg.eigh(sym)),
            "eigh_tridiag_dc Gram (32, 512, 512)":
                wall_ms(lambda: la.eigh_tridiag_dc(g)),
            "torch.linalg.eigh Gram (32, 512, 512), yardstick":
                wall_ms(lambda: torch.linalg.eigh(g))}
    small, ys = svd_in["small"]
    a3, y3 = svd_in["cfg3"]

    def cfg3(method):
        u, sv, v = la.svd_decomp(a3, method=method)
        return la.svd_lstsq(u, sv, v, y3)

    wall |= {
        "svd_decomp (32, 512, 512)": wall_ms(lambda: la.svd_decomp(a)),
        "torch.linalg.svd (32, 512, 512), yardstick":
            wall_ms(lambda: torch.linalg.svd(a)),
        "config 3 svd_decomp + svd_lstsq (8, 512, 512)":
            wall_ms(lambda: cfg3("auto")),
        "config 3 by one-sided Jacobi": wall_ms(lambda: cfg3("jacobi")),
        "torch.linalg.svd (8, 512, 512), yardstick":
            wall_ms(lambda: torch.linalg.svd(a3)),
        "lstsq (1024, 128, 64)": wall_ms(lambda: la.lstsq(small, ys)),
        "torch.linalg.svd (1024, 128, 64), yardstick":
            wall_ms(lambda: torch.linalg.svd(small)),
        "solve (1024, 128, 128)": wall_ms(lambda: la.solve(spd2, y2)),
        "torch.linalg.solve (1024, 128, 128), yardstick":
            wall_ms(lambda: torch.linalg.solve(spd2, y2)),
        "rrqr_decomp (32, 512, 512)": wall_ms(lambda: la.rrqr_decomp(a)),
        "torch.linalg.qr (32, 512, 512), unpivoted yardstick":
            wall_ms(lambda: torch.linalg.qr(a)),
        "config 4 eigh(method='via_svd') (1024, 1024)":
            wall_ms(lambda: la.eigh(sym, method="via_svd")),
        "torch.linalg.svd (1024, 1024), yardstick":
            wall_ms(lambda: torch.linalg.svd(sym))}
    wall |= la_rest_walls(a, a3, spd2, y2, svd_in)
    # svd_gram: the spectral seed, the iterations (their Cholesky
    # inverses), the repair's Householder QR; svd_jac_1sided: the pre-QR
    # and repair, the sweeps; eigh: sytrd (its panels), the tridiagonal
    # D&C (its Jacobi leaves, its merges)
    gram = [(svd_gram_mod, "eigh_tridiag_dc", "eigh_tridiag_dc"),
            (svd_gram_mod, "_gram_iterations", "iterations"),
            (svd_gram_mod, "_chol_inv_core", "of which Cholesky inverses"),
            (svd_gram_mod, "_robust_qr", "Householder QR")]
    gram_top = ("eigh_tridiag_dc", "_gram_iterations", "_robust_qr")
    jac = [(svd_jac_mod, "_qr_house_flat",
            "Householder QR (pre-QR and repair)"),
           (svd_jac_mod, "jacobi_sweeps", "sweeps")]
    jac_top = ("_qr_house_flat", "jacobi_sweeps")
    eig = [(eigh_mod, "sytrd", "sytrd"),
           (sytrd_mod, "sytrd_panel", "of which sytrd_panel"),
           (eigh_mod, "tridiag_eigh_dc", "tridiagonal D&C"),
           (tridiag_dc, "_base_eigh", "of which Jacobi leaves"),
           (tridiag_dc, "_merge", "merges")]
    eig_top = ("sytrd", "tridiag_eigh_dc")
    # the headline: its house_panel launches, the T of each panel (host
    # loops of small ops), Q formation and the rest (trailing GEMMs, solve)
    qr_parts = [(qr_mod, "house_panel", "house_panel"),
                (qr_mod, "_form_t_batched", "T of the panels"),
                (qr_mod, "_apply_q_batched", "Q formation")]
    host_breakdown("qr_decomp + qr_lstsq (32, 512, 512)", headline, qr_parts,
                   [name for _, name, _ in qr_parts])
    for what, fn, parts, top in (
            ("svd_decomp (32, 512, 512)", lambda: la.svd_decomp(a), gram,
             gram_top),
            ("config 3 svd_decomp (8, 512, 512)", lambda: la.svd_decomp(a3),
             gram, gram_top),
            ("config 3 by one-sided Jacobi",
             lambda: la.svd_decomp(a3, method="jacobi"), jac, jac_top),
            ("svd_decomp (1024, 128, 64)", lambda: la.svd_decomp(small), jac,
             jac_top),
            ("config 4 eigh (1024, 1024)", lambda: la.eigh(sym), eig,
             eig_top),
            ("eigh_tridiag_dc Gram (32, 512, 512)",
             lambda: la.eigh_tridiag_dc(g), eig, eig_top)):
        host_breakdown(what, fn, parts, top)
    # sytrd_panel on each of config 4's 16 panel shapes, against the whole
    # sytrd on the device
    spanels = [cuda_ms(lambda p=c4[:, k:, k:].contiguous(),
                       b=min(64, 1023 - k): sp.sytrd_panel(p, b), 3)
               for k in range(0, 1023, 64)]
    say("sytrd_panel on config 4's panels (1, 1024|960|…|64, …) ms: "
        + ", ".join(f"{t:.4f}" for t in spanels)
        + f"; sum {sum(spanels):.4f}; whole sytrd on the device "
        f"{cuda_ms(lambda: sytrd_mod.sytrd(sym), 3):.4f}")
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
    wall |= eigen_walls(*geig)
    cfg5_wall, by_name["chol_leaf"]["config5"] = config5_times(cfg5)
    wall |= cfg5_wall
    return rows, wall


# ---- phase 5: the rest of opt/ and utils/ -------------------------------
# L-BFGS-B's box on config 5's Rosenbrock: the upper bound binds
LBFGSB_BOX = (-2.0, 0.5)
# the float32 KKT gate: near the solution ∇f's entries are sums of terms up
# to 400·|z|³ ≈ 50-400, which float32 rounds to about 5e-5; 20× that
LBFGSB_KKT = 1e-3
BRATU_N = 512
# the float64 Newton tolerance on the h⁻²-scaled Bratu residual, 40× its
# rounding floor 4·eps·h⁻² ≈ 2.3e-10
BRATU_TOL64 = 1e-8
CHEB_P = 16
KD_N, KD_D, KD_Q, KD_K, KD_SAMPLE = 262144, 8, 1024, 16, 32
LORENZ_B, LORENZ_STEPS, LORENZ_HELD = 4096, 1000, 8
# the largest Lyapunov exponent of the classic Lorenz system
LORENZ_LYAPUNOV = 0.906


class OpCount(TorchDispatchMode):
    """Counts the aten ops the host dispatches inside it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def rosen_np(z):
    """The Rosenbrock and its gradient in float64 numpy, for scipy."""
    d = z[1:] - z[:-1] ** 2
    g = np.zeros_like(z)
    g[:-1] = -400.0 * z[:-1] * d - 2.0 * (1.0 - z[:-1])
    g[1:] += 200.0 * d
    return float(np.sum(100.0 * d ** 2 + (1.0 - z[:-1]) ** 2)), g


def scipy_lbfgsb(z0):
    """scipy's L-BFGS-B in float64 on the host, memory 8, 500 iterations:
    a witness printed beside the port, never a gate. None without
    scipy."""
    try:
        import scipy.optimize
    except ImportError:
        return None
    return scipy.optimize.minimize(
        rosen_np, z0.double().cpu().numpy(), jac=True, method="L-BFGS-B",
        bounds=[LBFGSB_BOX] * 128, options={"maxcor": 8, "maxiter": 500})


def lbfgsb_run(z0, bounds, max_iter=500):
    return opt.lbfgsb_minimize(rosen, z0, bounds, hist_size=8,
                               max_iter=max_iter)


def phase5_lbfgsb(totals, z0):
    """lbfgsb_minimize of config 5's 128-d Rosenbrock from −1s in the box
    [−2, 0.5]¹²⁸ (float32, memory 8, 500 iterations) against the port's
    float64 run on the card, scipy's L-BFGS-B beside it; with infinite
    bounds (every breakpoint infinite) to f < 1e-4; the host reads an
    iteration and the aten ops of one Cauchy point."""
    kkt = lbfgsb_mod._kkt_residual
    runs, walls = {}, {}
    for what, z, bounds in (
            ("box float32", z0, LBFGSB_BOX),
            ("box float64", z0.double(), LBFGSB_BOX),
            ("unbounded float32", z0, (-math.inf, math.inf))):
        reset_counts()
        host.reads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, f, g, it = lbfgsb_run(z, bounds)
        torch.cuda.synchronize()
        walls[what] = (time.perf_counter() - t0) * 1e3
        check_counts(f"lbfgsb_minimize {what}", read_counts(), {}, totals)
        lo = torch.full_like(x, bounds[0])
        hi = torch.full_like(x, bounds[1])
        runs[what] = (x, f, g, int(it), host.reads, float(kkt(x, g, lo, hi)))
        say(f"lbfgsb_minimize {what}: f = {float(f):.9e}, {int(it)} "
            f"iterations, {host.reads} host reads "
            f"({host.reads / max(int(it), 1):.2f} an iteration), KKT "
            f"residual {runs[what][5]:.3e}, "
            f"{int((x == bounds[1]).sum())} variables at the upper bound")
    x, f, _, it, _, res = runs["box float32"]
    f64 = float(runs["box float64"][1])
    check(tuple(x.shape) == (128,) and x.dtype == torch.float32
          and bool(torch.isfinite(x).all()) and res <= LBFGSB_KKT
          and bool((x == LBFGSB_BOX[1]).any())
          and float(f) <= f64 + 1e-4 * max(1.0, abs(f64)),
          f"lbfgsb_minimize box float32: KKT residual {res:.3e} <= "
          f"{LBFGSB_KKT:g}, the upper bound binds, f = {float(f):.9e} no "
          f"worse than the float64 run's {f64:.9e} + 1e-4·max(1, |f|)")
    witness = scipy_lbfgsb(z0)
    say("scipy L-BFGS-B (float64, host, witness): " + (
        "scipy not available" if witness is None else
        f"f = {witness.fun:.9e}, {witness.nit} iterations, "
        f"{witness.message}"))
    fu = float(runs["unbounded float32"][1])
    check(fu < 1e-4, f"lbfgsb_minimize unbounded float32: f = {fu:.3e} < "
          "1e-4 (config 5's gate)")
    # the aten ops of one Cauchy point, from the state after 10 steps
    fg, lo, hi, s = lbfgsb_mod._init_b(rosen, z0, LBFGSB_BOX, 8, None)
    for _ in range(10):
        s = lbfgsb_mod._lbfgsb_step(fg, lo, hi, s)
    wk = lbfgsb_solver.compact_wk(s.mem)
    with OpCount() as cp_ops:
        lbfgsb_solver.cauchy_point(wk, s.x, s.g, lo, hi)
    with OpCount() as step_ops:
        lbfgsb_mod._lbfgsb_step(fg, lo, hi, s)
    torch.cuda.synchronize()
    say(f"lbfgsb: one Cauchy point dispatches {cp_ops.ops} aten ops (n = "
        f"128, memory 8; the count does not grow with n); one iteration "
        f"{step_ops.ops}, its direction replayed as one CUDA graph")
    stats = {what: {"iterations": r[3], "reads": r[4], "kkt": r[5],
                    "f": float(r[1])} for what, r in runs.items()}
    stats["cauchy_point_ops"] = cp_ops.ops
    stats["iteration_ops"] = step_ops.ops
    stats["walls"] = walls
    return stats


def bratu(n, dtype):
    """−u″ = eᵘ on (0, 1), u = 0 at both ends, n interior points: (fJ, h),
    F the h⁻²-scaled residual and J dense (n, n), on the card."""
    h = 1.0 / (n + 1)
    one = torch.ones(n - 1, dtype=dtype, device=DEVICE)
    tri = (2 * torch.eye(n, dtype=dtype, device=DEVICE) - torch.diag(one, 1)
           - torch.diag(one, -1)) / h ** 2

    def fJ(u):
        up = torch.cat([u[1:], u.new_zeros(1)])
        um = torch.cat([u.new_zeros(1), u[:-1]])
        e = torch.exp(u)
        return (2 * u - up - um) / h ** 2 - e, tri - torch.diag(e)
    return fJ, h


def phase5_newton(totals):
    """root_newton on the discretised Bratu problem, n = 512, dense J, in
    float64 to max|F| ≤ BRATU_TOL64 and in float32 with the default tol
    (1e-12, out of float32's reach: 64 iterations, as the JAX package);
    lu_panel four launches an iteration (512 columns in panels of 128)."""
    out = {}
    for dtype, tol in ((torch.float64, BRATU_TOL64), (torch.float32, 1e-12)):
        fJ, h = bratu(BRATU_N, dtype)
        u0 = torch.zeros(BRATU_N, dtype=dtype, device=DEVICE)
        reset_counts()
        host.reads = 0
        u, it = opt.root_newton(fJ, u0, tol=tol)
        name = str(dtype).removeprefix("torch.")
        check_counts(f"root_newton Bratu {name}", read_counts(),
                     {"lu_panel": 4 * int(it)}, totals)
        out[dtype] = (u, int(it), host.reads, fJ, h)
        say(f"root_newton Bratu n = {BRATU_N} {name}: {int(it)} iterations, "
            f"{host.reads} host reads, lu_panel {4 * int(it)} launches, "
            f"max|F| = {maxabs(fJ(u)[0]):.3e}")
    u64, it64, _, fJ64, h = out[torch.float64]
    r64 = maxabs(fJ64(u64)[0])
    check(r64 <= BRATU_TOL64 and it64 < 64,
          f"root_newton Bratu float64: max|F| = {r64:.3e} <= {BRATU_TOL64:g} "
          f"in {it64} iterations (the floor 4·eps·h⁻² is "
          f"{4 * 2.0 ** -52 / h ** 2:.2e})")
    u32, it32 = out[torch.float32][:2]
    floor32 = 4 * float(torch.finfo(torch.float32).eps) / h ** 2
    r32 = maxabs(fJ64(u32.double())[0])
    gap = maxabs(u32.double() - u64)
    check(it32 == 64 and r32 <= floor32,
          f"root_newton Bratu float32: {it32} iterations, max|F| of its u "
          f"evaluated in float64 {r32:.3e} <= the float32 floor "
          f"4·eps·h⁻² = {floor32:.3e}; max|u32 - u64| = {gap:.3e}")
    return {str(d).removeprefix("torch."): {"iterations": v[1], "reads": v[2]}
            for d, v in out.items()}


def chebyshev(t, p):
    """T_0(t), …, T_{p-1}(t) stacked on the last axis."""
    cols = [torch.ones_like(t), t]
    while len(cols) < p:
        cols.append(2 * t * cols[-1] - cols[-2])
    return torch.stack(cols[:p], -1)


def phase5_fit_lin(totals, x, y):
    """fit_lin of config 5's 4096 points against 16 Chebyshev polynomials
    of x/2, with regularization 0 (the basis as a sequence of functions)
    and 1e-3 (as one function giving the design matrix): house_panel for
    the tall pre-QR, jacobi_sweeps once a sweep; bench.py's normal
    equations gate on the stacked system, and the coefficients against
    numpy's float64 lstsq within its forward-error bound."""
    basis = [lambda t, k=k: chebyshev(t / 2, k + 1)[:, k]
             for k in range(CHEB_P)]
    design = chebyshev(x / 2, CHEB_P)
    out = {}
    for reg, funcs in ((0.0, basis), (1e-3, lambda t: chebyshev(t / 2,
                                                                 CHEB_P))):
        reset_counts()
        p = opt.fit_lin(x, y, funcs, regularization=reg)
        counts = read_counts()
        a, ys = design, y
        if reg > 0:
            a = torch.cat([a, reg ** 0.5 * torch.eye(CHEB_P, device=DEVICE)])
            ys = torch.cat([y, y.new_zeros(CHEB_P)])
        sweeps = counts["jacobi_sweeps"]
        sv = la.svd_decomp(a)[1]
        check(1 <= sweeps <= MAX_SWEEPS, f"fit_lin reg {reg:g}: {sweeps} "
              "Jacobi sweeps")
        check_counts(f"fit_lin ({len(a)}, {CHEB_P}) reg {reg:g}", counts,
                     {"house_panel": 2 if jacobi_repair(sv, CHEB_P) else 1,
                      "jacobi_sweeps": sweeps}, totals)
        a64, y64 = a.double().cpu().numpy(), ys.double().cpu().numpy()
        # bench.py:418-422's gate, max|Aᵀ(A·p − y)| ≤ 1e-3·max|A|²·√N, is
        # written for square A (M = N = 512); Aᵀ sums the rounding of M
        # rows, so a tall A takes √M. Evaluated in float64, with the
        # backward error ‖Aᵀr‖/(‖A‖·(‖A‖·‖p‖ + ‖y‖)) ≤ N·eps beside it
        p_64 = p.double().cpu().numpy()
        grad = a64.T @ (a64 @ p_64 - y64)
        ne = float(np.abs(grad).max())
        ne_tol = 1e-3 * float(np.abs(a64).max()) ** 2 * len(a64) ** 0.5
        norm_a = float(np.linalg.norm(a64, 2))
        be = float(np.linalg.norm(grad) / (norm_a * (
            norm_a * np.linalg.norm(p_64) + np.linalg.norm(y64))))
        be_tol = CHEB_P * float(torch.finfo(torch.float32).eps)
        check(ne <= ne_tol and be <= be_tol,
              f"fit_lin reg {reg:g}: max |Aᵀ(A·p - y)| = {ne:.3e} <= "
              f"{ne_tol:.3e} (bench.py:418 with √M), backward error "
              f"{be:.3e} <= N·eps = {be_tol:.3e}")
        p64, res, _, s64 = np.linalg.lstsq(a64, y64, rcond=None)
        kappa = s64[0] / s64[-1]
        r = np.linalg.norm(a64 @ p64 - y64)
        # least squares' forward error in float32: eps·(κ + κ²·‖r‖/(‖A‖‖x‖))
        # relative to ‖x‖, with a factor of 16 for the algorithm's constant
        bound = 16 * float(torch.finfo(torch.float32).eps) * (
            kappa + kappa ** 2 * r / (s64[0] * np.linalg.norm(p64))) \
            * np.linalg.norm(p64)
        err = float(np.linalg.norm(p.double().cpu().numpy() - p64))
        check(err <= bound, f"fit_lin reg {reg:g}: ‖p - numpy's float64 "
              f"lstsq‖ = {err:.3e} <= {bound:.3e} (κ = {kappa:.2f})")
        out[reg] = {"sweeps": sweeps}
    return out


def phase5_kdtree(totals):
    """KDTree.nearest of 1024 queries among 262144 points in 8-d, k = 16,
    float32 (a 1 GiB distance matrix): the returned distances against a
    float64 recomputation at the returned indices, and on 32 sampled
    queries the k-th distance against a float64 brute force on the host,
    both within the float32 rounding of ‖p‖² − 2·q·p + ‖q‖²:
    8·eps·(‖p‖ + ‖q‖)²."""
    gen = torch.Generator().manual_seed(SEED + 50)
    pts = torch.randn((KD_N, KD_D), generator=gen)
    qs = torch.randn((KD_Q, KD_D), generator=gen)
    tree = utils.KDTree(pts.to(DEVICE))
    q = qs.to(DEVICE)
    reset_counts()
    dist, idx = tree.nearest(q, k=KD_K)
    check_counts("KDTree.nearest", read_counts(), {}, totals)
    p64, q64 = pts.double(), qs.double()
    near = p64[idx.cpu()]                                   # (Q, k, D)
    d2 = ((near - q64[:, None, :]) ** 2).sum(-1)
    eps = float(torch.finfo(torch.float32).eps)
    tol = 8 * eps * (near.norm(dim=-1) + q64.norm(dim=-1)[:, None]) ** 2
    gap = float(((dist.double().cpu() ** 2 - d2).abs() / tol).max())
    ordered = bool((dist[:, 1:] >= dist[:, :-1]).all())
    distinct = bool((idx.sort(1).values.diff(dim=1) > 0).all())
    check(tuple(idx.shape) == (KD_Q, KD_K) and ordered and distinct
          and gap <= 1.0,
          f"KDTree.nearest ({KD_Q} queries, {KD_N} points, k = {KD_K}): "
          "ascending, distinct, distances within the float32 bound of a "
          f"float64 recomputation (worst {gap:.3f} of it)")
    sample = torch.arange(0, KD_Q, KD_Q // KD_SAMPLE)
    qs64 = q64[sample]
    brute = (p64 * p64).sum(1)[None] - 2 * qs64 @ p64.T \
        + (qs64 * qs64).sum(1)[:, None]
    kth = brute.topk(KD_K, 1, largest=False).values[:, -1]
    kth_tol = 8 * eps * (p64.norm(dim=-1).max() + qs64.norm(dim=-1)) ** 2
    kgap = float(((dist[sample, -1].double().cpu() ** 2 - kth).abs()
                  / kth_tol).max())
    check(kgap <= 1.0, f"KDTree.nearest: the k-th distance of {KD_SAMPLE} "
          "queries against a float64 brute force on the host, worst "
          f"{kgap:.3f} of the float32 bound")
    return tree, q


def lorenz(t, y):
    x, yy, z = y[..., 0], y[..., 1], y[..., 2]
    return torch.stack([10.0 * (yy - x), x * (28.0 - z) - yy,
                        x * yy - 8.0 / 3.0 * z], -1)


def lorenz_rk4_np(y, ts):
    """The classic RK4 of the Lorenz system in float64 numpy."""
    def f(y):
        x, yy, z = y[..., 0], y[..., 1], y[..., 2]
        return np.stack([10.0 * (yy - x), x * (28.0 - z) - yy,
                         x * yy - 8.0 / 3.0 * z], -1)
    out = [y]
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = t1 - t0
        k1 = f(y)
        k2 = f(y + h / 2 * k1)
        k3 = f(y + h / 2 * k2)
        k4 = f(y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return np.stack(out)


def rosen_point():
    gen = torch.Generator().manual_seed(SEED + 51)
    return (1.0 + 0.1 * torch.randn(128, generator=gen)).to(DEVICE)


def small_solvers():
    """The small solvers of phase 5, once each, as their timed runs repeat
    them: (name, fn) pairs."""
    gen = torch.Generator().manual_seed(SEED + 52)
    y0 = (30 * torch.rand((LORENZ_B, 3), generator=gen) - 15).to(DEVICE)
    ts = torch.linspace(0.0, 1.0, LORENZ_STEPS + 1, device=DEVICE)
    z = rosen_point()
    cubic = lambda r: r ** 3 - 2 * r - 5                    # noqa: E731
    return [
        ("odeint_rk4 (4096 Lorenz systems, 1000 steps)",
         lambda: utils.odeint_rk4(lorenz, y0, ts)),
        ("num_grad (128-d Rosenbrock)", lambda: opt.num_grad(rosen)(z)),
        ("num_grad_forward (128-d Rosenbrock)",
         lambda: opt.num_grad_forward(rosen)(z)),
        ("min1d_gss float64", lambda: opt.min1d_gss(
            lambda r: (r - 1.234) ** 2 + 0.5, -10.0, 10.0)),
        ("root1d_bisect float64",
         lambda: opt.root1d_bisect(cubic, 2.0, 3.0)),
        ("root1d_brent float64", lambda: opt.root1d_brent(cubic, 2.0, 3.0)),
        ("root1d_illinois float64",
         lambda: opt.root1d_illinois(cubic, 2.0, 3.0)),
        ("min_nelder_mead helical_valley float64",
         lambda: opt.min_nelder_mead(opt.test_fn.helical_valley,
                                     np.array([-1.0, 0.0, 0.0]))),
        ("min_nelder_mead beale float64",
         lambda: opt.min_nelder_mead(opt.test_fn.beale,
                                     np.array([1.0, 1.0]), scale=0.5))], \
        (y0, ts, z, cubic)


def phase5_small(totals):
    """The small solvers at the reference tests' sizes, each held to its
    gate; returns their outputs' inputs for the timed runs."""
    runs, (y0, ts, z, cubic) = small_solvers()
    outs = {}
    for what, fn in runs:
        reset_counts()
        host.reads = 0
        outs[what] = fn()
        check_counts(what, read_counts(), {}, totals)
        outs[what + " reads"] = host.reads
    traj = outs[runs[0][0]]
    held = lorenz_rk4_np(y0[:LORENZ_HELD].double().cpu().numpy(),
                         ts.double().cpu().numpy())
    eps = float(torch.finfo(torch.float32).eps)
    ymax = float(np.abs(held).max())
    # float32 rounding a step, a random walk over the steps, grown by the
    # flow's largest Lyapunov exponent over the interval
    tol = 4 * LORENZ_STEPS ** 0.5 * eps * math.exp(LORENZ_LYAPUNOV) * ymax
    gap = float(np.abs(traj[:, :LORENZ_HELD].double().cpu().numpy()
                       - held).max())
    check(tuple(traj.shape) == (LORENZ_STEPS + 1, LORENZ_B, 3)
          and bool(torch.isfinite(traj).all()) and gap <= tol,
          f"odeint_rk4: {LORENZ_HELD} of {LORENZ_B} Lorenz systems over "
          f"{LORENZ_STEPS} steps within {gap:.3e} <= {tol:.3e} of a float64 "
          "numpy RK4 (4·√steps·eps·e^(λ·T)·max|y|)")
    g = torch.func.grad(rosen)(z)
    f = float(rosen(z))
    eps_h = {"num_grad": eps ** (1 / 3), "num_grad_forward": eps ** 0.5}
    hmax = float(torch.diagonal(torch.func.hessian(rosen)(z)).abs().max())
    for kind in ("num_grad", "num_grad_forward"):
        got = outs[f"{kind} (128-d Rosenbrock)"]
        h = eps_h[kind] * float(z.abs().clamp(min=1.0).max())
        # f's float32 rounding, a few eps·|f|, amplified by 1/h (h ≥ the
        # root of eps); the forward difference also truncates by up to
        # h·max|f″|/2 (the central one is exact for the quartic Rosenbrock)
        tol = 16 * eps * max(1.0, f) / eps_h[kind] + (
            h * hmax / 2 if kind == "num_grad_forward" else 0.0)
        err = maxabs(got - g)
        check(err <= tol, f"{kind} of the 128-d Rosenbrock: max|g - "
              f"torch.func.grad| = {err:.3e} <= {tol:.3e}")
    xg = float(outs["min1d_gss float64"])
    check(abs(xg - 1.234) < 1e-7, f"min1d_gss: x = {xg:.12f}, |x - 1.234| "
          "< 1e-7")
    for what in ("root1d_bisect float64", "root1d_brent float64",
                 "root1d_illinois float64"):
        r = outs[what]
        fr = abs(float(cubic(r)))
        check(r.dtype == torch.float64 and fr < 1e-10,
              f"{what}: r = {float(r):.15f}, |f(r)| = {fr:.2e} < 1e-10, "
              f"{outs[what + ' reads']} host reads")
    for what, sol in (("min_nelder_mead helical_valley float64",
                       [1.0, 0.0, 0.0]),
                      ("min_nelder_mead beale float64", [3.0, 0.5])):
        x, fx, it = outs[what]
        err = maxabs(x.cpu() - torch.tensor(sol, dtype=x.dtype))
        check(err < 1e-4, f"{what}: {int(it)} iterations, "
              f"{outs[what + ' reads']} host reads, f = {float(fx):.3e}, "
              f"max|x - x*| = {err:.3e} < 1e-4")
    return runs


def phase5(cfg5):
    """The rest of opt/ and utils/: each path once with its gates and its
    launches counted, then three timed runs of each (its gated run the
    warm-up; the unbounded L-BFGS-B's gated run, warm already, is one of
    its three). Returns (launches by kernel, walls, stats)."""
    totals = dict.fromkeys(KERNELS, 0)
    x, y, _, z0 = cfg5[0]
    stats = {"lbfgsb": phase5_lbfgsb(totals, z0),
             "root_newton": phase5_newton(totals),
             "fit_lin": phase5_fit_lin(totals, x, y)}
    tree, q = phase5_kdtree(totals)
    runs = phase5_small(totals)
    fJ32, _ = bratu(BRATU_N, torch.float32)
    fJ64, _ = bratu(BRATU_N, torch.float64)
    u32 = torch.zeros(BRATU_N, device=DEVICE)
    design = lambda t: chebyshev(t / 2, CHEB_P)              # noqa: E731
    wall = {
        "lbfgsb_minimize box float32 (128-d Rosenbrock)":
            wall_ms(lambda: lbfgsb_run(z0, LBFGSB_BOX), 3, False),
        # its gated run, warm (it replays the box runs' graph), and two more
        "lbfgsb_minimize unbounded float32 (128-d Rosenbrock)":
            [stats["lbfgsb"]["walls"]["unbounded float32"]]
            + wall_ms(lambda: lbfgsb_run(z0, (-math.inf, math.inf)), 2,
                      False),
        "root_newton Bratu float64 (n = 512)":
            wall_ms(lambda: opt.root_newton(fJ64, u32.double(),
                                            tol=BRATU_TOL64), 3, False),
        "root_newton Bratu float32 (n = 512, 64 iterations)":
            wall_ms(lambda: opt.root_newton(fJ32, u32), 3, False),
        "fit_lin (4096, 16)": wall_ms(lambda: opt.fit_lin(x, y, design),
                                      3, False),
        "fit_lin (4096, 16) regularization 1e-3":
            wall_ms(lambda: opt.fit_lin(x, y, design, regularization=1e-3),
                    3, False),
        "KDTree.nearest (1024 of 262144, k = 16)":
            wall_ms(lambda: tree.nearest(q, k=KD_K), 3, False)}
    for what, fn in runs:
        wall[what] = wall_ms(fn, 3, False)
    return totals, wall, stats


# ---- phase 6: the core surface, io and parallel --------------------------
# kahan_sum against its plain version on the card (both types), alone on
# 1 GiB of float32, and the 1-D sums
KAHAN_CMP = (4096, 4096)
KAHAN_BIG = (4096, 65536)
KAHAN_1D = 2 ** 20
HEADLINE = (32, 512, 512)
# float32 ulps within which the math wrappers on the card stand to numpy on
# the host: CUDA's expf, atan2f, hypotf and powf are within 2-3 ulps of the
# correctly rounded result, the rest are exact
MATH_ULPS = 8


def spread(what: str, runs) -> list:
    """Print a timed path's median and spread (max − min) in ms."""
    say(f"{what}: median {float(np.median(runs)):.3f} ms, spread "
        f"{max(runs) - min(runs):.3f} ms over {len(runs)} runs ("
        + ", ".join(f"{r:.3f}" for r in runs) + ")")
    return runs


def kahan_cost(n: int, lanes: int, dtype):
    """(flops, bytes) of one compensated sum of an (n, lanes) operand: four
    adds an element; each input read once, each output written once."""
    elem = torch.finfo(dtype).bits // 8
    return 4 * n * lanes, elem * (n * lanes + lanes)


def neumaier_gap(s, exact, abs_sum, n, dtype) -> float:
    """The worst ratio of |ŝ − S| to the Neumaier bound
    2·eps·|S| + n·eps²·Σ|x| (plus n·eps₆₄·Σ|x| for a float64 reference
    sum's own rounding)."""
    eps = torch.finfo(dtype).eps
    bound = 2 * eps * exact.abs() + (n * eps ** 2 + n * 2.0 ** -52) * abs_sum
    return float(((s.double() - exact).abs() / bound).max())


def phase6_kahan(totals, walls):
    """kahan_sum through core.kahan_sum: bit-equal to its plain version on
    the card at (4096, 4096) over axis 0 in both types; alone on (4096,
    65536) float32 (1 GiB) within the Neumaier bound of a float64 sum;
    axis=None of 2²⁰ float32 within that bound of math.fsum on the host;
    kahan_dot of two 2²⁰ vectors the same way. Returns the kernels line's
    row."""
    rng = np.random.default_rng(SEED + 60)
    errs, other, main_ms = [], [], 0.0
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.standard_normal(KAHAN_CMP)
                             * 10.0 ** rng.uniform(-4, 4, KAHAN_CMP)) \
            .to(DEVICE, dtype)
        reset_counts()
        got = kahan.kahan_sum(x, axis=0)
        check_counts(f"kahan_sum {KAHAN_CMP} {dtype} over axis 0",
                     read_counts(), {"kahan_sum": 1}, totals)
        want = ks.kahan_sum_cols_ref(x)
        check(torch.equal(got, want), f"kahan_sum {KAHAN_CMP} {dtype}: the "
              "kernel bit-equal to its plain version on the card (the same "
              "order)")
        errs.append(maxabs(got - want))
        t_bound, by = bound(*kahan_cost(*KAHAN_CMP, dtype))
        ms = cuda_ms(lambda: ks.kahan_sum_cols(x), 10)
        main_ms += ms
        other.append({"shape": list(KAHAN_CMP), "dtype": str(dtype)[6:],
                      "ms": ms, "plain_ms": cuda_ms(
                          lambda: ks.kahan_sum_cols_ref(x), 1),
                      "bound_ms": t_bound, "bound_by": by,
                      "library_ms": cuda_ms(lambda: torch.sum(x, 0), 10)})
        say(f"kahan_sum {KAHAN_CMP} {dtype}: kernel {ms:.4f} ms, plain "
            f"{other[-1]['plain_ms']:.4f} ms, torch.sum "
            f"{other[-1]['library_ms']:.4f} ms, bound {t_bound:.5f} ms ({by})")
        del x, got, want
    # alone on 1 GiB: entries over 7 decades with cancelling signs
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
    x = torch.randn(KAHAN_BIG, generator=gen, device=DEVICE)
    x *= torch.empty(KAHAN_BIG, device=DEVICE).uniform_(
        -8.0, 8.0, generator=gen).exp_()
    reset_counts()
    s = kahan.kahan_sum(x, axis=0)
    check_counts(f"kahan_sum {KAHAN_BIG} float32 over axis 0", read_counts(),
                 {"kahan_sum": 1}, totals)
    exact = torch.sum(x, 0, dtype=torch.float64)
    abs_sum = x.abs().sum(0, dtype=torch.float64)
    gap = neumaier_gap(s, exact, abs_sum, KAHAN_BIG[0], torch.float32)
    plain_gap = neumaier_gap(torch.sum(x, 0), exact, abs_sum, KAHAN_BIG[0],
                             torch.float32)
    check(gap <= 1.0, f"kahan_sum {KAHAN_BIG} float32: within the Neumaier "
          f"bound of a float64 sum, worst {gap:.3e} of it (torch.sum's "
          f"float32 sum: worst {plain_gap:.3e})")
    t_bound, by = bound(*kahan_cost(*KAHAN_BIG, torch.float32))
    row = {"name": "kahan_sum", "route": "cuda",
           "source": "nd4js_tpu_torch/csrc/kahan_sum.cu",
           "replaces": "nd4js_tpu/core/kahan.py:26",
           "replaces_note": "no Pallas counterpart: the XLA lax.scan at "
                            "nd4js_tpu/core/kahan.py:26-48",
           "max_abs_err": max(errs),
           "ms": cuda_ms(lambda: ks.kahan_sum_cols(x), 10),
           "plain_ms": cuda_ms(lambda: ks.kahan_sum_cols_ref(x), 1),
           "bound_ms": t_bound, "bound_by": by,
           "library_ms": cuda_ms(lambda: torch.sum(x, 0), 10),
           "library_f64_ms": cuda_ms(
               lambda: torch.sum(x, 0, dtype=torch.float64), 10),
           "shape": list(KAHAN_BIG), "dtype": "float32",
           "neumaier_gap": gap}
    main_ms += row["ms"]
    say(f"kahan_sum {KAHAN_BIG} float32: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.sum {row['library_ms']:.4f} ms, "
        f"its float64 sum {row['library_f64_ms']:.4f} ms, bound "
        f"{t_bound:.5f} ms ({by})")
    del x, s, exact, abs_sum
    # the 1-D sums: one thread's dependent chain
    v = torch.from_numpy((rng.standard_normal(KAHAN_1D) * 10.0 ** rng.uniform(
        -4, 4, KAHAN_1D)).astype(np.float32)).to(DEVICE)
    w = torch.from_numpy(rng.standard_normal(KAHAN_1D).astype(np.float32)) \
        .to(DEVICE)
    for what, fn, terms in (
            ("kahan_sum(axis=None) of 2^20 float32",
             lambda: kahan.kahan_sum(v), v),
            ("kahan_dot of two 2^20 float32 vectors",
             lambda: kahan.kahan_dot(v, w), v * w)):
        reset_counts()
        got = fn()
        check_counts(what, read_counts(), {"kahan_sum": 1}, totals)
        host_terms = terms.double().cpu().numpy()
        exact = torch.tensor(math.fsum(host_terms.tolist()),
                             dtype=torch.float64)
        gap = neumaier_gap(got.cpu(), exact,
                           torch.tensor(np.abs(host_terms).sum()),
                           KAHAN_1D, torch.float32)
        check(gap <= 1.0, f"{what}: within the Neumaier bound of math.fsum "
              f"on the host, worst {gap:.3e} of it")
        runs = spread(f"{what} (kernel, one thread)",
                      [cuda_ms(fn, 1) for _ in range(3)])
        walls[what] = runs
        main_ms += float(np.median(runs))
    t_bound, by = bound(*kahan_cost(KAHAN_1D, 1, torch.float32))
    other.append({"shape": [KAHAN_1D], "dtype": "float32",
                  "ms": float(np.median(walls[
                      "kahan_sum(axis=None) of 2^20 float32"])),
                  "plain_ms": "not measured (2^20 dependent steps of about "
                              "six launches each)",
                  "bound_ms": t_bound, "bound_by": by,
                  "library_ms": cuda_ms(lambda: torch.sum(v), 10)})
    row["other_shapes"] = other
    row["main_path_ms"] = main_ms
    return row


def phase6_arrays(totals, walls):
    """array/asarray of the headline batch from numpy float64, tabulate of
    the 4096² Hilbert matrix, zip_elems, concat/stack, reduce_elems,
    slice_elems and the NDArray wrapper on the card, each against numpy on
    the host; no kernel."""
    rng = np.random.default_rng(SEED + 62)
    host_a = rng.standard_normal(HEADLINE)
    reset_counts()
    a32, a64 = nd.array(host_a), nd.asarray(host_a)
    check_counts("array/asarray (32, 512, 512)", read_counts(), {}, totals)
    check(a32.dtype == torch.float32 and a32.device.type == torch.device(DEVICE).type
          and np.array_equal(a32.cpu().numpy(), host_a.astype(np.float32)),
          "array of the (32, 512, 512) numpy float64 batch: float32 on the "
          "card, each entry the float32 rounding of the host's")
    check(a64.dtype == torch.float64 and a64.device.type == torch.device(DEVICE).type
          and np.array_equal(a64.cpu().numpy(), host_a),
          "asarray of the same batch: float64 on the card, exact")
    walls["array (32, 512, 512) from numpy float64"] = spread(
        "array (32, 512, 512)", wall_ms(lambda: nd.array(host_a), 3, False))
    walls["asarray (32, 512, 512) from numpy float64"] = spread(
        "asarray (32, 512, 512)",
        wall_ms(lambda: nd.asarray(host_a), 3, False))

    def hilbert():
        return nd.tabulate((4096, 4096), "float64",
                           lambda i, j: 1 / (i + j + 1).to(torch.float64))
    reset_counts()
    h = hilbert()
    check_counts("tabulate (4096, 4096)", read_counts(), {}, totals)
    i, j = np.indices((4096, 4096))
    check(h.dtype == torch.float64 and np.array_equal(h.cpu().numpy(),
                                                      1.0 / (i + j + 1)),
          "tabulate of the 4096² Hilbert matrix (float64): equal to numpy's")
    walls["tabulate Hilbert (4096, 4096) float64"] = spread(
        "tabulate Hilbert (4096, 4096) float64", wall_ms(hilbert, 3, False))
    del h, i, j
    parts = [rng.standard_normal(s).astype(np.float32)
             for s in ((32, 512, 1), (1, 1, 512), (32, 1, 512))]
    cards = [torch.from_numpy(p).to(DEVICE) for p in parts]
    reset_counts()
    z = nd.zip_elems(cards, lambda p, q, r: p * q + r)
    check_counts("zip_elems", read_counts(), {}, totals)
    want = parts[0] * parts[1] + parts[2]
    # the product and the sum each rounded: equal where the two sides round
    # alike, 2 ulps apart at most where one contracts them into an FMA
    tol = 2 * np.finfo(np.float32).eps * (np.abs(parts[0] * parts[1])
                                          + np.abs(parts[2]))
    check(tuple(z.shape) == HEADLINE and bool(
        (np.abs(z.cpu().numpy() - want) <= tol).all()),
        "zip_elems (32, 512, 1) × (1, 1, 512) × (32, 1, 512), p·q + r: "
        "within 2 ulps of numpy's")
    walls["zip_elems (32, 512, 512)"] = spread(
        "zip_elems (32, 512, 512)", wall_ms(
            lambda: nd.zip_elems(cards, lambda p, q, r: p * q + r), 3, False))
    mixed = [a32.to(torch.int32), a32, a64]
    reset_counts()
    cat, stk = nd.concat(mixed, 1), nd.stack(mixed)
    check_counts("concat/stack", read_counts(), {}, totals)
    host_mixed = [host_a.astype(np.float32).astype(np.int32),
                  host_a.astype(np.float32), host_a]
    check(cat.dtype == stk.dtype == torch.float64
          and np.array_equal(cat.cpu().numpy(),
                             np.concatenate(host_mixed, 1))
          and np.array_equal(stk.cpu().numpy(), np.stack(host_mixed)),
          "concat and stack of int32, float32 and float64 batches: "
          "promoted to float64, equal to numpy's")
    del cat, stk, mixed
    reset_counts()
    fast = nd.reduce_elems(a32, (1, 2), torch.add)
    x64 = torch.from_numpy(rng.standard_normal((64, 512, 512))
                           .astype(np.float32)).to(DEVICE)
    lse = nd.reduce_elems(x64, 0, torch.logaddexp)
    check_counts("reduce_elems", read_counts(), {}, totals)
    eps = float(torch.finfo(torch.float32).eps)
    fast_gap = float(((fast.double().cpu() - torch.from_numpy(
        host_a.astype(np.float32)).double().sum((1, 2))).abs()
        / (512 * 512 * eps * torch.from_numpy(np.abs(host_a)).sum((1, 2))))
        .max())
    ref = torch.logsumexp(x64.double(), 0)
    lse_gap = float(((lse.double() - ref).abs() / (64 * 4 * eps * ref.abs()
                                                  + 64 * eps)).max())
    check(fast_gap <= 1.0 and lse_gap <= 1.0,
          "reduce_elems: torch.add over (1, 2) of the batch within "
          f"N·eps·Σ|x| of a float64 sum (worst {fast_gap:.3e} of it); a "
          "fold of torch.logaddexp over a 64-long axis within "
          f"64·(4·eps·|lse| + eps) of a float64 logsumexp ({lse_gap:.3e})")
    walls["reduce_elems torch.add (32, 512, 512) over (1, 2)"] = spread(
        "reduce_elems torch.add", wall_ms(
            lambda: nd.reduce_elems(a32, (1, 2), torch.add), 3, False))
    walls["reduce_elems torch.logaddexp over 64 of (64, 512, 512)"] = spread(
        "reduce_elems torch.logaddexp", wall_ms(
            lambda: nd.reduce_elems(x64, 0, torch.logaddexp), 3, False))
    del x64, ref, lse
    reset_counts()
    sl = nd.slice_elems(a32, [None, None, -3], "...", [500, 3, -7], "new")
    check_counts("slice_elems", read_counts(), {}, totals)
    check(np.array_equal(sl.cpu().numpy(), host_a.astype(np.float32)[
        ::-3, ..., 500:3:-7, None]),
        "slice_elems with negative steps and 'new': equal to numpy's")
    wa = nd.NDArray(a32)
    reset_counts()
    prod = wa @ wa
    t, hh = wa.T, wa.H
    mod = wa.set((0, 0, 0), 7.0).modify((1, 2), lambda r: r * 2)
    total = wa.reduce_elems(None, torch.add)
    rows = list(wa)
    check_counts("NDArray", read_counts(), {}, totals)
    check(torch.equal(prod.data, la.matmul2(a32, a32))
          and torch.equal(t.data, a32.mT) and torch.equal(hh.data, a32.mT)
          and float(mod(0, 0, 0)) == 7.0
          and torch.equal(mod(1, 2), a32[1, 2] * 2)
          and float(wa(0, 0, 0)) == float(a32[0, 0, 0])
          and torch.equal(total, torch.sum(a32))
          and len(rows) == 32 and torch.equal(rows[5].data, a32[5])
          and torch.equal(torch.sum(wa), torch.sum(a32)),
          "NDArray of the batch: @, .T, .H, set and modify out of place, "
          "reduce_elems, iteration, torch functions unwrap it")
    walls["NDArray @ (32, 512, 512)"] = spread(
        "NDArray @ (32, 512, 512)", wall_ms(lambda: wa @ wa, 3, False))
    return a32, host_a


def phase6_math(totals, a32, host_a):
    """Each of math's sixteen names on a card tensor against numpy on the
    host, within MATH_ULPS float32 ulps (is_close exactly)."""
    x = a32[0]
    hx = host_a[0].astype(np.float32)
    y = a32[1].abs() + 0.5
    hy = np.abs(host_a[1].astype(np.float32)) + np.float32(0.5)
    cases = {
        "add": ((x, y), hx + hy), "sub": ((x, y), hx - hy),
        "mul": ((x, y), hx * hy), "div": ((x, y), hx / hy),
        "neg": ((x,), -hx), "abs": ((x,), np.abs(hx)),
        "sqrt": ((y,), np.sqrt(hy)), "exp": ((x,), np.exp(hx)),
        "conj": ((x,), np.conj(hx)),
        "cbrt": ((x,), np.cbrt(hx.astype(np.float64)).astype(np.float32)),
        "atan2": ((x, y), np.arctan2(hx, hy)),
        "hypot": ((x, y), np.hypot(hx, hy)), "sign": ((x,), np.sign(hx)),
        "min": ((x, y), np.minimum(hx, hy)),
        "max": ((x, y), np.maximum(hx, hy)),
        "is_close": ((x, x + 1e-3 * (x > 0)),
                     np.isclose(hx, hx + np.float32(1e-3) * (hx > 0),
                                rtol=1e-5, atol=1e-8))}
    reset_counts()
    for name, (args, want) in cases.items():
        got = getattr(ndmath, name)(*args).cpu().numpy()
        if name == "is_close":
            check(np.array_equal(got, want), "math.is_close on the card: "
                  "equal to numpy's isclose with the same defaults")
            continue
        ulp = np.spacing(np.abs(want).astype(np.float32))
        worst = float((np.abs(got - want) / ulp).max())
        check(got.dtype == np.float32 and worst <= MATH_ULPS,
              f"math.{name} on the card: within {MATH_ULPS} float32 ulps of "
              f"numpy ({worst:.1f})")
    check_counts("math", read_counts(), {}, totals)


def phase6_io(totals, walls, a32):
    """npy bytes, save_npy/load_npy through a temporary file, istr and b64
    of card tensors: each bit-exact after the round trip, the .npy also
    read by np.load."""
    f64 = a32[0].double() * 3.7
    reset_counts()
    raw = tio.npy_serialize(a32)
    back = tio.npy_deserialize(raw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batch.npy")
        tio.save_npy(path, a32)
        loaded = tio.load_npy(path)
        from_np = np.load(path)
    text = tio.istr_stringify(f64)
    parsed = tio.istr_parse(text)
    b64 = tio.b64_encode(f64)
    decoded = tio.b64_decode(b64, torch.float64, (512, 512))
    check_counts("io", read_counts(), {}, totals)
    host = a32.cpu().numpy()
    check(back.device.type == loaded.device.type
          == torch.device(DEVICE).type
          and back.cpu().numpy().tobytes() == host.tobytes()
          and loaded.cpu().numpy().tobytes() == host.tobytes()
          and np.load(pyio.BytesIO(raw)).tobytes() == host.tobytes()
          and from_np.tobytes() == host.tobytes(),
          "npy bytes and save_npy/load_npy of the (32, 512, 512) float32 "
          "batch: bit-exact round trips onto the card, np.load reads them")
    check(parsed.dtype == decoded.dtype == torch.float64
          and torch.equal(parsed, f64) and torch.equal(decoded, f64)
          and text.startswith("float64[512,512]\n"),
          "istr and b64 of a (512, 512) float64 matrix: bit-exact")
    walls["npy_serialize (32, 512, 512) float32"] = spread(
        "npy_serialize (32, 512, 512)",
        wall_ms(lambda: tio.npy_serialize(a32), 3, False))
    walls["npy_deserialize (32, 512, 512) float32"] = spread(
        "npy_deserialize (32, 512, 512)",
        wall_ms(lambda: tio.npy_deserialize(raw), 3, False))
    walls["istr_stringify + istr_parse (512, 512) float64"] = spread(
        "istr round trip (512, 512)", wall_ms(
            lambda: tio.istr_parse(tio.istr_stringify(f64)), 3, False))


def phase6_parallel(totals, walls, gen):
    """make_mesh over the one card (NCCL, world size 1), batch_sharded of
    entry.forward on the headline batch against the unsharded call, and
    dryrun_multichip(1) on the card."""
    import torch.distributed as dist
    a = torch.randn(HEADLINE, generator=gen).to(DEVICE)
    y = torch.randn((32, 512, 1), generator=gen).to(DEVICE)
    reset_counts()
    mesh = parallel.make_mesh()
    sharded = parallel.batch_sharded(entry_forward, mesh)
    x, resid = sharded(a, y)
    got = read_counts()
    say(f"batch_sharded(entry.forward) over make_mesh() ({dist.get_backend()}"
        f", world size {dist.get_world_size()}): house_panel launched "
        f"{got['house_panel']} times")
    check_counts("batch_sharded(entry.forward)", got,
                 {"house_panel": HEADLINE[-1] // 128}, totals)
    reset_counts()
    x_ref, resid_ref = entry_forward(a, y)
    check_counts("entry.forward unsharded", read_counts(),
                 {"house_panel": HEADLINE[-1] // 128}, totals)
    check(dist.get_backend() == parallel.mesh._BACKEND[
              torch.device(DEVICE).type]
          and tuple(x.full_tensor().shape) == (32, 512, 1)
          and torch.equal(x.full_tensor(), x_ref)
          and torch.equal(resid.full_tensor(), resid_ref),
          "batch_sharded(entry.forward, make_mesh()) on the headline batch: "
          "NCCL, equal to the unsharded call")
    walls["batch_sharded(entry.forward) (32, 512, 512)"] = spread(
        "batch_sharded(entry.forward)", wall_ms(lambda: sharded(a, y), 3))
    walls["entry.forward unsharded (32, 512, 512)"] = spread(
        "entry.forward unsharded", wall_ms(lambda: entry_forward(a, y), 3,
                                           False))
    reset_counts()
    dryrun_multichip(1)
    got = read_counts()
    check(got["house_panel"] > 0 and got["lu_panel"] > 0
          and got["jacobi_sweeps"] + got["sytrd_panel"] > 0,
          f"dryrun_multichip(1) on the card (NCCL): sharded against "
          f"replicated within 1e-4; launches {got}")
    for k, v in got.items():
        totals[k] += v
    dist.destroy_process_group()


def phase6(gen):
    """The core surface, io and parallel, each path with the counters reset
    before and read after. Returns (launches by kernel, kahan_sum's row,
    walls)."""
    totals = dict.fromkeys(KERNELS, 0)
    walls = {}
    t0 = time.perf_counter()
    row = phase6_kahan(totals, walls)
    a32, host_a = phase6_arrays(totals, walls)
    phase6_math(totals, a32, host_a)
    phase6_io(totals, walls, a32)
    phase6_parallel(totals, walls, gen)
    row["launches"] = totals["kahan_sum"]
    check(totals["kahan_sum"] > 0, "kahan_sum was launched on phase 6's "
          f"paths: {totals['kahan_sum']} launches")
    say(f"phase 6 took {time.perf_counter() - t0:.1f} s")
    return totals, row, walls


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
        counts, batch, cfg1, cfg2, spd512, eig, svd_in, geig, cfg5 = \
            phase3(gen)
    with phase("4 times"):
        rows, wall = phase4(counts, errs, batch, cfg1, cfg2, spd512, eig,
                            svd_in, geig, cfg5)
    with phase("5 the rest of opt and utils"):
        more, wall5, stats5 = phase5(cfg5)
    with phase("6 core surface, io and parallel"):
        more6, kahan_row, wall6 = phase6(gen)
    for row in rows:
        row["launches"] += more[row["name"]] + more6[row["name"]]
        row["launches_opt_utils"] = more[row["name"]]
        row["launches_core_surface"] = more6[row["name"]]
    rows.append(kahan_row)
    wall |= wall5 | wall6
    say("phase 5 stats: " + json.dumps(stats5))
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    for what, runs in wall.items():
        # the keys of the paths that are not float32 name their dtype
        dtype = "" if "float64" in what or "float32" in what else " float32"
        say(f"{what}{dtype} wall ms, {len(runs)} runs: "
            + ", ".join(f"{w:.3f}" for w in runs)
            + (f"; before the redesign of bulge_chase_steps and schur_small "
               f"{WALLS_BEFORE[what]}" if what in WALLS_BEFORE else ""))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
