"""The port's CUDA kernels and its QR, Cholesky, LU, symmetric eigen, SVD,
rank-revealing QR, general eigen and optimisation slices on the card.

Imports neither JAX nor the JAX package, so it runs on a machine without
them, skipping the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test skips. Each kernel is held against its
plain PyTorch version on the same inputs, from numpy with a fixed seed:
1e-4·max|A| in float32 and 1e-10·max|A| in float64 on R, V and taus (the
two sum in different orders); x within the forward-error bound of the
solve, and its backward error, which does not loosen with κ(A), within
N·eps and 8× the plain version's. ``chol_leaf``'s L and L⁻¹ within the
same TOL·max|A| and TOL·max|L⁻¹|; ``lu_panel``'s factored panel within
TOL·max|A| and its rank exactly equal (the kernel and the plain version
round each quotient, product and difference alike), in its plan's launch
and in every placement the plan can choose; ``lu_gesv`` in every layout;
``sytrd_panel`` within SYTRD_C·eps·m·max|C| (reason below), its trailing
block exactly symmetric, and backward stable (``panel_backward_error``);
``house_stripe_t`` within the same TOL·max|A| of its plain version
and of ``house_panel``'s kernel, and in every cluster size of both
regimes, and on transposed views; the cluster plan's rule, whose
byte counts come from the kernel library; ``qr_gesv`` in each regime (clusters of 1 to 8 blocks in shared
memory, global memory) against its plain version by x and by backward
error. ``jacobi_sweeps``' W within 64·eps·n·max|W| and V and off within 64·eps·n
on a near-converged W (the two sum in different orders over n − 1 rounds),
and consistent on a random one, in both of its regimes (a sweep in shared
memory, or one launch a round); ``rrqr_kernel``'s pivots exactly equal (in
float32, on the matrices where no near-tie flipped one) and R, V, taus
within 32·eps·max(M, N)·max|A|, in both of its regimes.
``bulge_chase_steps`` over a full slide by its contract (Vᵀ·B·V
Hessenberg outside the bulges, the carries its bulge columns, V_acc
orthogonal) and over 8 steps entry by entry within TOL (a long bulge train
amplifies rounding); ``schur_small`` by its
contract (64·eps·W) and its eigenvalues against the plain version's
(rounding may flip a deflation decision, so T itself is not compared);
``trevc_solve``'s unit columns within TOL of the plain version's; the
general eigen slice under bench.py's config 4 gate; ``chol_leaf`` at config
5's (4096, 1, 1) and (1, 4, 4); a short ``odr_lm`` and ``lbfgs_minimize``
in float64 within 1e-8 of the CPU port's; config 5 under bench.py's
gate; L-BFGS-B's Cauchy point and subspace step within 1e-12 and its steps
(the direction replayed as a CUDA graph) within 1e-10 of the CPU port's;
and ``KDTree.nearest``'s indices equal to the CPU's, ties included;
``kahan_sum``'s kernel bit-equal to its plain version (the same order of
adds, each rounded alone), NaN and ±inf lanes included, and ``io`` of a
card tensor byte-identical to that of its host copy.
"""
import importlib

import numpy as np
import pytest
import torch

from nd4js_tpu_torch import la, opt, utils
from nd4js_tpu_torch.core import host
from nd4js_tpu_torch.la import qr
from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import chol_leaf as cl
from nd4js_tpu_torch.ops import house_panel as hp
from nd4js_tpu_torch.ops import house_stripe as hs
from nd4js_tpu_torch.ops import jacobi_sweep as js
from nd4js_tpu_torch.ops import lu_panel as lp
from nd4js_tpu_torch.ops import rrqr_kernel as rk
from nd4js_tpu_torch.ops import sytrd_panel as sp
from nd4js_tpu_torch.ops import bulge_chase as bc
from nd4js_tpu_torch.ops import schur_small as ss
from nd4js_tpu_torch.ops import trevc_solve as tv

rrqr_mod = importlib.import_module("nd4js_tpu_torch.la.rrqr")
schur_mod = importlib.import_module("nd4js_tpu_torch.la.schur")

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(cuda, arr, dtype):
    return torch.from_numpy(arr).to(cuda, dtype)


def backward_error(a, y, x):
    """Per system, over the worst right-hand side, ‖A·x − y‖₂/(‖A‖₂·‖x‖₂)
    for a square A, and ‖Aᵀ(A·x − y)‖₂/(‖A‖₂·(‖A‖₂·‖x‖₂ + ‖y‖₂)) for a
    tall one (least squares): near eps for a backward-stable solve,
    whatever κ(A)."""
    a, y, x = (t.double().cpu().numpy() for t in (a, y, x))
    res = a @ x - y
    norm_a = np.linalg.norm(a, 2, axis=(-2, -1))[..., None]
    if a.shape[-2] == a.shape[-1]:
        return (np.linalg.norm(res, axis=-2)
                / (norm_a * np.linalg.norm(x, axis=-2))).max(-1)
    grad = np.linalg.norm(np.swapaxes(a, -1, -2) @ res, axis=-2)
    return (grad / (norm_a * (norm_a * np.linalg.norm(x, axis=-2)
                              + np.linalg.norm(y, axis=-2)))).max(-1)


def assert_backward_stable(a, y, x, x_ref, dtype):
    """x's backward error ≤ N·eps and ≤ 8× x_ref's (floored at eps): two
    Householder solves that round differently stay within 1.4× of each
    other on random systems. Unlike a bound on x, this does not loosen
    with κ(A)."""
    eps = torch.finfo(dtype).eps
    be, be_ref = backward_error(a, y, x), backward_error(a, y, x_ref)
    assert (be <= np.minimum(a.shape[-1] * eps,
                             8 * np.maximum(be_ref, eps))).all(), (be, be_ref)


@pytest.mark.parametrize("shape", [(3, 48, 16), (2, 32, 32), (5, 130, 20),
                                   (2, 6, 8), (1, 600, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_house_panel_kernel_matches_plain_version(cuda, shape, dtype):
    a = _on(cuda, np.random.default_rng(31).standard_normal(shape), dtype)
    a[0, :, min(shape[1:]) // 2] = 0            # a zero column: tau = 0
    before = hp.launches
    got = hp.house_panel(a)
    torch.cuda.synchronize()
    assert hp.launches == before + 1
    tol = TOL[dtype] * float(a.abs().max())
    for g, w in zip(got, hp.house_panel_ref(a)):
        assert g.device.type == "cuda"
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("nb,n,k", [(3, 13, 3), (2, 64, 1), (1, 256, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_gesv_kernel_matches_plain_version(cuda, nb, n, k, dtype):
    rng = np.random.default_rng(32 + n)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    before = hs.launches
    x = hs.qr_gesv(a, y)
    torch.cuda.synchronize()
    assert hs.launches == before + 1
    x_ref = hs.qr_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """qr_decomp over two panels and both branches of qr_lstsq_fused on
    the card against the same calls on the CPU (plain kernels there)."""
    rng = np.random.default_rng(33)
    a = rng.standard_normal((2, 200, 150))
    y = rng.standard_normal((2, 200, 2))
    sq = rng.standard_normal((3, 40, 40))
    ys = rng.standard_normal((3, 40, 2))
    tol = 100 * TOL[dtype]
    q, r = la.qr_decomp(_on(cuda, a, dtype))
    qc, rc = la.qr_decomp(torch.from_numpy(a).to(dtype))
    assert float((r.cpu() - rc).abs().max()) <= tol * np.abs(a).max()
    assert float((q.cpu() - qc).abs().max()) <= tol
    for aa, yy in ((a, y), (sq, ys)):
        x = la.qr_lstsq_fused(_on(cuda, aa, dtype), _on(cuda, yy, dtype))
        xc = la.qr_lstsq_fused(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype))
        assert x.device.type == "cuda"
        assert float((x.cpu() - xc).abs().max()) <= \
            tol * float(xc.abs().max()) * np.linalg.cond(aa).max()
        assert_backward_stable(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype), x, xc, dtype)


# (Nb, M, B) for house_stripe_t: a B not a multiple of 8, a wide panel,
# 128² and the headline's 512 rows in shared memory, and one global-regime
# shape per type
STRIPE_SHAPES = [(3, 48, 16), (2, 64, 17), (3, 96, 24), (2, 6, 12),
                 (4, 128, 128), (2, 512, 128)]
STRIPE_GLOBAL = {torch.float32: (1, 2048, 128), torch.float64: (1, 1024, 128)}
# more rows than one block can stage: the stripe and V staged in global
# memory too (fit_lin's (4096, 16) panel of config 5's points)
STRIPE_STAGED = {torch.float32: (1, 4096, 16), torch.float64: (2, 2048, 40)}


@pytest.mark.parametrize("shape", STRIPE_SHAPES + ["global", "staged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_house_stripe_t_kernel_matches_plain_version(cuda, shape, dtype):
    """R, V and taus within TOL·max|A| of the plain version, with a zero
    column (τ = 0), in the plan's regime; and against house_panel's kernel
    (a drop-in) within the same tolerance."""
    want = {"global": False, "staged": hs.STAGED}.get(shape, True)
    shape = {"global": STRIPE_GLOBAL[dtype],
             "staged": STRIPE_STAGED[dtype]}.get(shape, shape)
    a = _on(cuda, np.random.default_rng(34).standard_normal(shape), dtype)
    a[0, :, shape[-1] // 2] = 0
    c, shared = hs.stripe_plan(a)
    assert shared == want
    before = hs.stripe_launches
    got = hs.house_stripe_t(a)
    torch.cuda.synchronize()
    assert hs.stripe_launches == before + 1
    tol = TOL[dtype] * float(a.abs().max())
    for g, w, p in zip(got, hs.house_stripe_t_ref(a), hp.house_panel(a)):
        assert g.device.type == "cuda" and g.shape == w.shape
        assert float((g - w).abs().max()) <= tol
        assert float((g - p).abs().max()) <= tol
    assert float(got[2][0, shape[-1] // 2]) == 0.0


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_house_stripe_t_kernel_in_every_cluster_size(cuda, cluster, shared,
                                                      dtype):
    """Every cluster size in both regimes on (4, 128, 128): 16 stripes,
    so a block of 8 still owns two."""
    a = _on(cuda, np.random.default_rng(35).standard_normal((4, 128, 128)),
            dtype)
    got = hs._house_stripe_t_in(a, cluster, shared)
    tol = TOL[dtype] * float(a.abs().max())
    for g, w in zip(got, hs.house_stripe_t_ref(a)):
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(32, 512, 128), (1024, 128, 64),
                                   (4, 128, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_house_panel_kernel_in_every_regime(cuda, shape, dtype):
    """house_panel on the stripe body, one launch each, against its plain
    version in every regime that house_stripe.stripe_plan can give it: the
    shared regime on each cluster size that holds the panel, the plan's,
    and the global regime on the plan's cluster size; in the plan's
    shared regime also through the column-major scratch (the route of a
    transposed view) instead of the direct load. Shapes: the headline's
    first panel, lstsq's pre-QR and the entry's."""
    a = _on(cuda, np.random.default_rng(36).standard_normal(shape), dtype)
    a[0, :, shape[-1] // 2] = 0                 # a zero column: tau = 0
    nb, m, b = shape
    plan = hs.stripe_plan(a)
    regimes = {(c, True) for c in hs.CLUSTER_SIZES
               if c <= -(-min(m, b) // hs.STRIPE)
               and hs.smem_bytes(m, b, min(m, b), 0, c, True, dtype)
               <= _build.SMEM_MAX} | {plan, (plan[0], False)}
    want = hp.house_panel_ref(a)
    tol = TOL[dtype] * float(a.abs().max())
    outs = []
    for cluster, shared in sorted(regimes):
        before = hp.launches
        outs.append(hp._house_panel_in(a, cluster, shared))
        assert hp.launches == before + 1
    if plan[1]:
        outs.append(hs._stripe_panel(a, *plan, "house_panel", False))
    for got in outs:
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol


# (Nb, N, K, cluster, shared) of qr_gesv: config 1 in each cluster size and
# in the global regime, a system that fits one block, and the plan's choice
# (None) for N not a multiple of 8 with K > 8 and for the 768² global regime
GESV_REGIMES = [(2, 128, 1, 1, True), (1, 256, 4, 2, True),
                (1, 256, 4, 4, True), (1, 256, 4, 8, True),
                (1, 256, 4, 4, False), (3, 40, 2, 1, False),
                (2, 21, 11, None, None), (2, 768, 2, None, None)]


@pytest.mark.parametrize("nb,n,k,cluster,shared", GESV_REGIMES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_gesv_kernel_in_each_regime(cuda, nb, n, k, cluster, shared,
                                       dtype):
    """x within the forward-error bound of the plain version and backward
    stable. A cluster too small for the system's shared memory (config 1
    in float64 on 2 blocks) must raise instead."""
    rng = np.random.default_rng(36 + n)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    plan = hs.gesv_plan(a, y)
    c = cluster or plan[0]
    sh = plan[1] if shared is None else shared
    n8 = -(-n // 8) * 8
    if hs.smem_bytes(n, n8 + k, n, k, c, sh, dtype) > _build.SMEM_MAX:
        with pytest.raises(RuntimeError, match="launch failed"):
            hs._qr_gesv_in(a, y, c, sh)
        return
    if n == 768:
        assert not sh
    x = hs._qr_gesv_in(a, y, c, sh)
    x_ref = hs.qr_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


# The cluster plan reads each launch's shared memory from the kernel
# library (smem_plan of csrc/house_stripe.cuh), so it is checked here.
@pytest.mark.parametrize("what,args,want", [
    # config 1: 33 groups, 266 KB in float32 — a cluster of 2 would hold it;
    # one system leaves the card free, so the rule takes the largest, 8
    ("config 1 f32", (1, 256, 264, 256, 4, torch.float32), (8, True)),
    ("config 1 f64", (1, 256, 264, 256, 4, torch.float64), (8, True)),
    # house_stripe_t's (32, 512, 128): 256 KB needs 2 blocks in float32, 4
    # in float64; 512-thread blocks allow 32·2 of them at 256 threads an SM
    ("panel 512 f32", (32, 512, 128, 128, 0, torch.float32), (2, True)),
    ("panel 512 f64", (32, 512, 128, 128, 0, torch.float64), (4, True)),
    # 128² with one right-hand side fits one block; 128-thread blocks
    ("(64, 128) K=1 f32", (64, 128, 129, 128, 1, torch.float32), (4, True)),
    ("(300, 128) K=1 f32", (300, 128, 129, 128, 1, torch.float32),
     (1, True)),
    # a panel of one stripe runs on one block whatever the batch
    ("one stripe", (2, 64, 8, 8, 0, torch.float32), (1, True)),
    # 768² does not fit 8 blocks: the global regime
    ("768 f32", (2, 768, 776, 768, 2, torch.float32), (8, False)),
])
def test_plan_states_its_rule(cuda, what, args, want):
    assert hs.plan(*args) == want, what


def test_plan_shared_regime_fits_and_global_regime_is_a_last_resort(
        cuda):
    """Whatever the plan picks fits 227 KB a block; the shared regime is
    taken whenever some cluster of at most 8 holds the columns; beyond
    what one block can stage, the stripe is staged in global memory too;
    plan raises only where the back substitution's right-hand sides
    alone overflow a block."""
    for m in (8, 64, 200, 256, 512, 700, 1000):
        for dtype in (torch.float32, torch.float64):
            for ncols, nh, kt in ((m + 8, m, 3), (min(m, 128), min(m, 128),
                                                    0)):
                c, shared = hs.plan(1, m, ncols, nh, kt, dtype)
                assert hs.smem_bytes(m, ncols, nh, kt, c, shared, dtype) \
                    <= _build.SMEM_MAX
                fits8 = hs.smem_bytes(m, ncols, nh, kt, 8, True, dtype) \
                    <= _build.SMEM_MAX
                assert shared == fits8
    assert hs.plan(1, 4000, 4008, 4000, 1, torch.float64)[1] == hs.STAGED
    assert hs.plan(1, 4096, 16, 16, 0, torch.float32)[1] == hs.STAGED
    with pytest.raises(ValueError, match="global regime"):
        hs.plan(1, 4000, 4000 + 8000, 4000, 8000, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_house_stripe_kernels_take_transposed_views(cuda, dtype):
    """A transposed (non-contiguous) panel or system gives contiguous
    outputs equal to those of its contiguous copy, within TOL of the
    plain version."""
    rng = np.random.default_rng(37)
    panel = _on(cuda, rng.standard_normal((3, 64, 96)), dtype).mT
    assert not panel.is_contiguous()
    got = hs.house_stripe_t(panel)
    tol = TOL[dtype] * float(panel.abs().max())
    for g, c, w in zip(got, hs.house_stripe_t(panel.contiguous()),
                       hs.house_stripe_t_ref(panel)):
        assert g.is_contiguous() and torch.equal(g, c)
        assert float((g - w).abs().max()) <= tol
    a = _on(cuda, rng.standard_normal((2, 40, 40)), dtype).mT
    y = _on(cuda, rng.standard_normal((2, 3, 40)), dtype).mT
    x = hs.qr_gesv(a, y)
    assert x.is_contiguous()
    assert torch.equal(x, hs.qr_gesv(a.contiguous(), y.contiguous()))
    assert_backward_stable(a, y, x, hs.qr_gesv_ref(a, y), dtype)


def _spd(rng, shape):
    """SPD blocks a·aᵀ/n + 2I from a seeded normal, with the upper
    triangle overwritten by garbage that a correct kernel never reads."""
    a = rng.standard_normal(shape)
    n = shape[-1]
    spd = a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)
    return np.tril(spd) + np.triu(rng.standard_normal(spd.shape) * 1e3, 1)


# the main path's leaf batches (config 2's 1024, the 512² batch's 32,
# eigh via_svd's 1), ragged widths, and config 5's leaves (the per-point
# blocks Cᵢ of the 4096-point ODR fit and its 4 × 4 Schur complement S);
# each in the plan's layout (None: through the wrapper) and in every layout
# of the kernel
CHOL_SHAPES = [(1024, 64, 64), (32, 64, 64), (1, 64, 64), (5, 64, 64),
               (3, 33, 33), (2, 8, 8), (1, 1, 1), (4096, 1, 1), (1, 4, 4)]


@pytest.mark.parametrize("shape", CHOL_SHAPES)
@pytest.mark.parametrize("with_inv", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warps", (None,) + cl.WARPS)
def test_chol_leaf_kernel_matches_plain_version(cuda, shape, with_inv, dtype,
                                                warps):
    a = _on(cuda, _spd(np.random.default_rng(34), shape), dtype)
    before = cl.launches
    l, li = (cl.chol_leaf(a, with_inv) if warps is None
             else cl._chol_leaf_in(a, with_inv, warps))
    torch.cuda.synchronize()
    assert cl.launches == before + 1
    l_ref, li_ref = cl.chol_leaf_ref(a, with_inv)
    amax = float(torch.tril(a).abs().max())
    assert float((l - l_ref).abs().max()) <= TOL[dtype] * amax
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    if with_inv:
        assert float((li - li_ref).abs().max()) <= \
            TOL[dtype] * float(li_ref.abs().max())
        assert float(torch.triu(li, 1).abs().max()) == 0.0
    else:
        assert li is None


def test_chol_leaf_plan_on_the_card_is_one_of_its_layouts(cuda):
    for nb in (1, 32, 1024):
        for dtype in DTYPES:
            assert cl.card_plan(nb, 64, dtype, True, cuda) in cl.WARPS


@pytest.mark.parametrize("warps", (None,) + cl.WARPS)
@pytest.mark.parametrize("with_inv", [False, True])
def test_chol_leaf_kernel_gives_nan_on_non_spd(cuda, warps, with_inv):
    """Through the wrapper (its plan) and in every layout, with and
    without L⁻¹ (the kernel's two instances of each layout)."""
    a = -torch.eye(4, device=cuda, dtype=torch.float64)[None]
    l, li = (cl.chol_leaf(a, with_inv) if warps is None
             else cl._chol_leaf_in(a, with_inv, warps))
    assert bool(torch.isnan(l).any())
    assert (li is None) != with_inv
    if with_inv:
        assert bool(torch.isnan(li).any())


def _panel(rng, shape):
    """A random panel with a zero column in the first matrix and tied
    |pivots| (3 and −3, twice) in column 0 of the second."""
    a = rng.standard_normal(shape)
    a[0, :, shape[2] // 2] = 0
    if shape[0] > 1:
        a[1, :4, 0] = [1.0, -3.0, 3.0, -3.0]
        a[1, 4:, 0] = 0.5
    return a


@pytest.mark.parametrize("shape", [(3, 136, 40), (2, 512, 128),
                                   (2, 384, 128), (2, 16, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_kernel_matches_plain_version(cuda, shape, dtype):
    a = _on(cuda, _panel(np.random.default_rng(35), shape), dtype)
    before = lp.launches["lu_panel"]
    out, rank = lp.lu_panel(a)
    torch.cuda.synchronize()
    assert lp.launches["lu_panel"] == before + 1
    out_ref, rank_ref = lp.lu_panel_ref(a)
    assert rank.dtype == torch.int32
    assert torch.equal(rank, rank_ref)
    assert float((out - out_ref).abs().max()) <= TOL[dtype] * float(a.abs().max())


@pytest.mark.parametrize("nb,n,k", [(3, 13, 3), (4, 128, 1), (2, 128, 4),
                                    (1, 128, 160)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_gesv_kernel_matches_plain_version(cuda, nb, n, k, dtype):
    """(1, 128, 160) in float64 does not fit in shared memory and runs on
    the kernel's global-memory branch."""
    rng = np.random.default_rng(36 + n + k)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    before = lp.launches["lu_gesv"]
    x = lp.lu_gesv(a, y)
    torch.cuda.synchronize()
    assert lp.launches["lu_gesv"] == before + 1
    x_ref = lp.lu_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


# every launch lu_panel's plan can choose (cluster size, rows in shared or
# in global memory) on the card tests' panels, and every layout of lu_gesv
# (registers, shared, global) that takes the card tests' systems; pure
# Python, the same on every machine
LU_PANEL_LAUNCHES = [(shape, place, dtype) for dtype in DTYPES
                     for shape in ((2, 512, 128), (3, 136, 40),
                                   (2, 300, 200))
                     for place in lp.placements(*shape[1:], dtype)]
LU_GESV_LAUNCHES = [(shape, launch, dtype) for dtype in DTYPES
                    for shape in ((2, 128, 4), (2, 128, 160), (3, 13, 3))
                    for launch in lp.gesv_layouts(*shape[1:], dtype)]


@pytest.mark.parametrize("shape,place,dtype", LU_PANEL_LAUNCHES)
def test_lu_panel_kernel_in_every_placement(cuda, shape, place, dtype):
    """Rank exactly equal to the plain version's in both types (the kernel
    rounds each quotient, product and difference as the plain version
    does), the panel within TOL·max|A|."""
    nb, m, b = shape
    a = _on(cuda, _panel(np.random.default_rng(38), shape), dtype)
    out, rank = lp._lu_panel_in(a, lp.launch_on(m, b, dtype, *place))
    torch.cuda.synchronize()
    out_ref, rank_ref = lp.lu_panel_ref(a)
    assert torch.equal(rank, rank_ref)
    assert float((out - out_ref).abs().max()) <= TOL[dtype] * float(
        a.abs().max())


@pytest.mark.parametrize("place", [(1, True), (3, True), (3, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_kernel_nan_candidate_gives_no_pivot(cuda, place, dtype):
    """A NaN among a step's candidates: no pivot at that step or after (the
    NaN spreads through the multipliers), as the plain version's
    max-then-first-index gives; rank and NaN positions equal."""
    a = np.random.default_rng(41).standard_normal((2, 136, 40))
    a[1, 70, 3] = np.nan
    a = _on(cuda, a, dtype)
    out, rank = lp._lu_panel_in(a, lp.launch_on(136, 40, dtype, *place))
    torch.cuda.synchronize()
    out_ref, rank_ref = lp.lu_panel_ref(a)
    assert torch.equal(rank, rank_ref)
    assert int((rank[1] < 40).sum()) == 3  # steps 0-2 only: column 3 holds it
    torch.testing.assert_close(out, out_ref, rtol=0, equal_nan=True,
                               atol=TOL[dtype] * float(a[0].abs().max()))


@pytest.mark.parametrize("shape,launch,dtype", LU_GESV_LAUNCHES)
def test_lu_gesv_kernel_in_every_layout(cuda, shape, launch, dtype):
    nb, n, k = shape
    rng = np.random.default_rng(39 + n + k)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    x = lp._lu_gesv_in(a, y, launch)
    torch.cuda.synchronize()
    x_ref = lp.lu_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


def test_lu_gesv_kernel_singular_gives_non_finite(cuda):
    a = torch.ones((1, 4, 4), device=cuda)
    x = lp.lu_gesv(a, torch.ones((1, 4, 1), device=cuda))
    assert not bool(torch.isfinite(x).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_chol_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """lu_decomp over three panels, lu_solve, both branches of
    lu_solve_fused, det, cholesky_decomp with and without the inverse,
    cholesky_solve both ways, and qr_decomp with cholqr2 and auto, on the
    card against the same calls on the CPU (plain kernels there)."""
    rng = np.random.default_rng(37)
    tol = 100 * TOL[dtype]

    def both(f, *arrs, **kw):
        on = f(*(_on(cuda, x, dtype) for x in arrs), **kw)
        off = f(*(torch.from_numpy(x).to(dtype) for x in arrs), **kw)
        return on, off

    a = rng.standard_normal((2, 300, 260))
    (lu, p), (luc, pc) = both(la.lu_decomp, a)
    assert torch.equal(p.cpu(), pc)
    assert float((lu.cpu() - luc).abs().max()) <= tol * float(luc.abs().max())
    sq = rng.standard_normal((3, 200, 200))
    y = rng.standard_normal((3, 200, 2))
    for aa, yy in ((sq, y), (sq[:, :100, :100], y[:, :100])):
        x, xc = both(la.lu_solve_fused, aa, yy)
        assert_backward_stable(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype), x, xc, dtype)
    d, dc = both(la.det, sq[:, :12, :12])
    assert float(((d.cpu() - dc) / dc).abs().max()) <= tol
    spd = _spd(rng, (4, 256, 256))
    amax = np.abs(np.tril(spd)).max()
    for inv in (False, True):
        on, off = both(la.cholesky_decomp, spd, inv=inv)
        on, off = (on, off) if inv else ((on, None), (off, None))
        assert float((on[0].cpu() - off[0]).abs().max()) <= tol * amax
        if inv:
            assert float((on[1].cpu() - off[1]).abs().max()) <= \
                tol * float(off[1].abs().max())
    ys = rng.standard_normal((4, 256, 3))
    L, Li = la.cholesky_decomp(_on(cuda, spd, dtype), inv=True)
    x1 = la.cholesky_solve(L, _on(cuda, ys, dtype), l_inv=Li)
    x2 = la.cholesky_solve(L, _on(cuda, ys, dtype))
    full = torch.tril(_on(cuda, spd, dtype))
    full = full + torch.tril(full, -1).mT
    for x in (x1, x2):
        resid = float((torch.matmul(full, x) - _on(cuda, ys, dtype)).abs().max())
        assert resid <= TOL[dtype] * amax * 256 ** 0.5
    tall = rng.standard_normal((2, 300, 200))
    for method in ("cholqr2", "auto"):
        (q, r), (qc, rc) = both(la.qr_decomp, tall, method=method)
        assert float((r.cpu() - rc).abs().max()) <= tol * np.abs(tall).max() * 10
        eye = torch.eye(200, device=cuda, dtype=dtype)
        assert float((q.mT @ q - eye).abs().max()) <= \
            4 * torch.finfo(dtype).eps * 300
    assert qr.auto_branches["cholqr2"] >= 2


# sytrd_panel, kernel against plain version: SYTRD_C·eps·m·max|C| on the
# trailing block, W, d and e, and SYTRD_C·eps·m on V and taus, which are
# scale-free. The two sum in different orders. At the main path's shapes
# (64 of 512 or 1024 columns) the plain version in float32 is within about
# eps·m·max|C| of itself in float64 (tests/test_torch_sytrd.py), so two
# float32 roundings differ by about twice that. Late in a reduction (bk
# close to m) the entries grow sensitive to rounding, by a factor that
# depends on the input; 32 covers the inputs here. Every panel is also held
# to its contract, which does not depend on that: see panel_backward_error.
SYTRD_C = 32
# H = Π(I − τ·v·vᵀ) orthogonal to BACKWARD_C·eps·m, and Hᵀ·C·H equal to the
# tridiagonal columns (d, e) beside the trailing block to
# BACKWARD_C·eps·m·max|C|; at most 0.15 of each on the CPU, float32 and
# float64, for any seed tried (tests/test_torch_sytrd.py).
BACKWARD_C = 2


def panel_backward_error(c, out, bk):
    """(max|Hᵀ·C·H − T|, max|Hᵀ·H − I|) in float64 for a panel's outputs:
    H = H_0···H_{bk−1}, T the tridiagonal columns d, e of the first bk
    columns and rows, zeros elsewhere beside them, and C_trailing below
    and right of them."""
    trail, V, _, taus, d, e = (x.double() for x in out)
    c = c.double()
    nb, m, _ = c.shape
    eye = torch.eye(m, dtype=torch.float64, device=c.device)
    H = eye.repeat(nb, 1, 1)
    for j in range(bk):
        v = V[:, :, j:j + 1]
        H = H - taus[:, j, None, None] * (H @ v) @ v.mT
    T = torch.zeros_like(c)
    i = torch.arange(bk, device=c.device)
    T[:, i, i] = d
    T[:, i + 1, i] = e
    T[:, i, i + 1] = e
    T[:, bk:, bk:] = trail
    return (float((H.mT @ c @ H - T).abs().max()),
            float((H.mT @ H - eye).abs().max()))


def assert_panel_backward_stable(c, out, bk):
    eps = torch.finfo(c.dtype).eps
    m = c.shape[-1]
    resid, orth = panel_backward_error(c, out, bk)
    assert resid <= BACKWARD_C * eps * m * float(c.abs().max()), resid
    assert orth <= BACKWARD_C * eps * m, orth


def _sym(rng, shape):
    a = rng.standard_normal(shape)
    return (a + np.swapaxes(a, -1, -2)) / 2


def _tau_zero(rng, nb, m):
    """Symmetric blocks whose first columns are already tridiagonal and
    whose other half is a separate block: τ = 0 on those columns."""
    a = _sym(rng, (nb, m, m))
    h = m // 2
    a[:, h:, :h] = 0
    a[:, :h, h:] = 0
    band = np.triu(np.tril(np.ones((h, h)), 1), -1)
    a[:, :h, :h] *= band
    return a


def assert_sytrd_panel_close(got, want, c, bk, dtype):
    m = c.shape[-1]
    unit = SYTRD_C * torch.finfo(dtype).eps * m
    cmax = float(c.abs().max())
    for name, g, w, scale in zip(("C_trailing", "V", "W", "taus", "d", "e"),
                                 got, want, (cmax, 1, cmax, 1, cmax, cmax)):
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= unit * scale, (name, err, unit * scale)
    trail = got[0]
    assert torch.equal(trail, trail.mT)


@pytest.mark.parametrize("shape,bk", [((1, 1024, 1024), 64),
                                      ((4, 512, 512), 64), ((3, 100, 100), 63),
                                      ((2, 70, 70), 1), ((2, 33, 33), 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sytrd_panel_kernel_matches_plain_version(cuda, shape, bk, dtype):
    c = _on(cuda, _sym(np.random.default_rng(38), shape), dtype)
    before = sp.launches
    got = sp.sytrd_panel(c, bk)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    assert_sytrd_panel_close(got, sp.sytrd_panel_ref(c, bk), c, bk, dtype)
    assert_panel_backward_stable(c, got, bk)


# every cluster size in each dtype: on config 4's first panel each size
# that places it, on a small batch the sizes below those, and the Gram
# batch's shape on a few; then slabs of more rows than a block's 1024
# threads, one cluster a matrix
SYTRD_CLUSTERS = (
    [((1, 1024, 1024), 64, c, dtype) for dtype in DTYPES
     for c in sp.placeable_sizes(1024, 64, dtype)]
    + [((3, 100, 100), 63, c, dtype) for dtype in DTYPES
       for c in range(1, 6)]
    + [((4, 512, 512), 64, c, dtype) for dtype in DTYPES for c in (3, 4, 8)]
    + [((2, 1100, 1100), 16, 1, torch.float32),
       ((1, 2100, 2100), 8, 1, torch.float32),
       ((2, 1100, 1100), 4, 1, torch.float64)])


@pytest.mark.parametrize("shape,bk,cluster,dtype", SYTRD_CLUSTERS)
def test_sytrd_panel_kernel_in_every_cluster_size(cuda, shape, bk, cluster,
                                                  dtype):
    c = _on(cuda, _sym(np.random.default_rng(37), shape), dtype)
    before = sp.launches
    got = sp._sytrd_panel_in(c, bk, sp.launch_on(shape[1], bk, dtype,
                                                  cluster))
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    assert_sytrd_panel_close(got, sp.sytrd_panel_ref(c, bk), c, bk, dtype)
    assert_panel_backward_stable(c, got, bk)


def test_sytrd_panel_kernel_on_a_batch_the_card_places_on_single_blocks(
        cuda):
    """100 matrices of 1100², a panel of 16: more clusters of 2 than the
    card holds at once, so the plan gives each matrix one block of 1024
    threads and its 1100 rows."""
    c = _on(cuda, _sym(np.random.default_rng(36), (100, 1100, 1100)),
            torch.float32)
    _, threads, rows, _, _ = sp.card_plan(100, 1100, 16, c.dtype, c.device)
    assert rows > threads
    got = sp.sytrd_panel(c, 16)
    assert_sytrd_panel_close(got, sp.sytrd_panel_ref(c, 16), c, 16,
                             torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sytrd_panel_kernel_on_columns_with_tau_zero(cuda, dtype):
    c = _on(cuda, _tau_zero(np.random.default_rng(39), 2, 96), dtype)
    got = sp.sytrd_panel(c, 63)
    want = sp.sytrd_panel_ref(c, 63)
    assert_sytrd_panel_close(got, want, c, 63, dtype)
    assert_panel_backward_stable(c, got, 63)
    assert float(got[3][:, :47].abs().max()) == 0.0
    assert float(got[3][:, 48:].abs().min()) > 0.0
    assert torch.equal(got[5][:, :47], torch.diagonal(c, -1, 1, 2)[:, :47])


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigh_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """eigh (dc, at n = 130 over three panels, and jacobi), eigh_tridiag_dc
    on a batch and tridiag_eigh_dc on the card against the same calls on
    the CPU: w directly, V by its contract (orthogonality and
    reconstruction). Reconstruction within 100·eps·n·max|A| in float32 and
    the JAX package's own 1e-9·n·max|A| for its dc path in float64, where
    its eps-scale jitter of close poles leaves more than Jacobi does."""
    rng = np.random.default_rng(40)
    eps = torch.finfo(dtype).eps
    rtol = 100 * eps if dtype == torch.float32 else 1e-9
    a = _sym(rng, (130, 130))
    b = _sym(rng, (2, 3, 70, 70))
    before = sp.launches
    for arr, fn, panels in ((a, la.eigh, 3), (b, la.eigh_tridiag_dc, 2),
                            (b[0, 0, :20, :20], la.eigh, 0)):
        w, v = fn(_on(cuda, arr, dtype))
        torch.cuda.synchronize()
        assert sp.launches == before + panels
        before = sp.launches
        wc, _ = fn(torch.from_numpy(arr).to(dtype))
        n = arr.shape[-1]
        amax = np.abs(arr).max()
        assert w.device.type == "cuda"
        assert float((w.cpu() - wc).abs().max()) <= 100 * eps * n * amax
        assert bool((torch.diff(w, dim=-1) >= 0).all())
        eye = torch.eye(n, device=cuda, dtype=dtype)
        assert float((v.mT @ v - eye).abs().max()) <= 100 * eps * n
        recon = (v * w[..., None, :]) @ v.mT - _on(cuda, arr, dtype)
        assert float(recon.abs().max()) <= rtol * n * amax
    d, e = rng.standard_normal((2, 100)), rng.standard_normal((2, 99))
    w, v = la.tridiag_eigh_dc(_on(cuda, d, dtype), _on(cuda, e, dtype))
    wc, _ = la.tridiag_eigh_dc(torch.from_numpy(d).to(dtype),
                               torch.from_numpy(e).to(dtype))
    assert float((w.cpu() - wc).abs().max()) <= 100 * eps * 100 * 4


def test_eigh_auto_below_128_runs_jacobi_and_no_kernel(cuda):
    a = _on(cuda, _sym(np.random.default_rng(41), (4, 127, 127)),
            torch.float32)
    before = sp.launches
    w, v = la.eigh(a)
    torch.cuda.synchronize()
    assert sp.launches == before
    wj, _ = la.eigh(a, method="jacobi")
    assert torch.equal(w, wj)
    eps = torch.finfo(torch.float32).eps
    eye = torch.eye(127, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) <= 4 * eps * 127


# (Nb, M, n) of W for jacobi_sweeps: 16² and 96×64 run a sweep in shared
# memory in both dtypes, 128² in float32 only (256 KB in float64 does not
# fit 227 KB), 256² in global memory in both
JACOBI_SHAPES = [(5, 16, 16), (3, 96, 64), (2, 128, 128), (2, 256, 256)]


def test_jacobi_and_rrqr_shapes_cover_both_regimes_in_both_dtypes():
    for small_regime, shapes in (
            (js.small_regime, [s[1:] for s in JACOBI_SHAPES]),
            (rk.small_regime, [s[1:] for s in RRQR_SHAPES])):
        for dtype in DTYPES:
            assert {small_regime(m, n, dtype) for m, n in shapes} == \
                {True, False}


def _near_converged(rng, shape):
    """W = U·diag(σ)·(I + (0.1/n)·G), σ from 10 to 1: nearly orthogonal
    columns, as late in a Jacobi iteration, where a sweep is a contraction
    and two roundings of it agree entry by entry. (A sweep of a random W
    amplifies rounding by orders of magnitude: there only W_in·V = W and
    VᵀV = I are well posed.)"""
    nb, m, n = shape
    u = np.linalg.qr(rng.standard_normal((nb, m, n)))[0]
    return (u * np.geomspace(10.0, 1.0, n)) @ \
        (np.eye(n) + 0.1 / n * rng.standard_normal((nb, n, n)))


@pytest.mark.parametrize("shape", JACOBI_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_sweeps_kernel_matches_plain_version(cuda, shape, dtype):
    """One sweep, and two in one call, from a near-converged W with a zero
    column (its pairs have apq = 0 and are left alone) and V = I, against
    the plain version; a sweep of a random W consistent (W_in·V = W, V
    orthogonal); the inputs are not written to."""
    rng = np.random.default_rng(60 + shape[-1])
    nb, m, n = shape
    w0 = _near_converged(rng, shape)
    w0[0, :, 1] = 0.0
    w = _on(cuda, w0, dtype)
    v = torch.eye(n, device=cuda, dtype=dtype).repeat(nb, 1, 1)
    w_in, v_in = w.clone(), v.clone()
    unit = 64 * torch.finfo(dtype).eps * n
    wmax = float(w.abs().max())
    for sweeps in (1, 2):
        before = js.launches
        got = js.jacobi_sweeps(w, v, sweeps)
        torch.cuda.synchronize()
        assert js.launches == before + 1
        want = js.jacobi_sweeps_ref(w, v, sweeps)
        for g, r, scale in zip(got, want, (wmax, 1.0, 1.0)):
            assert g.device.type == "cuda" and g.shape == r.shape
            assert float((g - r).abs().max()) <= sweeps * unit * scale
    assert torch.equal(w, w_in) and torch.equal(v, v_in)
    # a later call reads the transposed views the kernel returned
    again = js.jacobi_sweeps(*got[:2], 1)
    want = js.jacobi_sweeps_ref(*got[:2], 1)
    assert float((again[0] - want[0]).abs().max()) <= unit * wmax
    wr = _on(cuda, rng.standard_normal(shape), dtype)
    wk, vk, _ = js.jacobi_sweeps(wr, v, 1)
    cons = (wr.double() @ vk.double() - wk.double()).abs().max()
    assert float(cons) <= unit * float(wr.abs().max())
    assert float((vk.mT @ vk - v).abs().max()) <= unit


# every launch jacobi_sweeps' plan can choose, in both dtypes: one block a
# matrix (lstsq's 64²), each cluster size of config 3's 512² with V in shared
# and in global memory, a cluster of 2 (the ring wraps between its two
# blocks), and one launch a round (what no cluster holds); config 3's batch
# of 8 at 512² needs two waves of clusters of 16
JACOBI_LAUNCHES = (
    [((64, 64, 64), 1, False, dtype) for dtype in DTYPES]
    + [((2, 512, 512), c, vg, dtype) for dtype in DTYPES
       for c, vg in js.placements(512, 512, dtype) if c > 1]
    + [((3, 256, 256), 2, True, torch.float32),
       ((3, 128, 128), 2, True, torch.float64)]
    + [((3, 96, 64), 2, False, dtype) for dtype in DTYPES]
    + [((8, 512, 512), 16, False, torch.float32)]
    + [((1, 1024, 1024), 0, False, dtype) for dtype in DTYPES])


@pytest.mark.parametrize("shape,cluster,vglobal,dtype", JACOBI_LAUNCHES)
def test_jacobi_sweeps_kernel_in_every_launch(cuda, shape, cluster, vglobal,
                                              dtype):
    """One sweep from a near-converged W against the plain version, in a
    given launch of the kernel; a random W's sweep consistent."""
    rng = np.random.default_rng(63 + cluster)
    nb, m, n = shape
    the_plan = js.launch_on(m, n, dtype, cluster, vglobal) if cluster \
        else js.ROUNDS
    w = _on(cuda, _near_converged(rng, shape), dtype)
    v = torch.eye(n, device=cuda, dtype=dtype).repeat(nb, 1, 1)
    unit = 64 * torch.finfo(dtype).eps * n
    before = js.launches
    got = js._jacobi_in(w, v, 1, the_plan)
    torch.cuda.synchronize()
    assert js.launches == before + 1
    want = js.jacobi_sweeps_ref(w, v, 1)
    for g, r, scale in zip(got, want, (float(w.abs().max()), 1.0, 1.0)):
        assert float((g - r).abs().max()) <= unit * scale
    wr = _on(cuda, rng.standard_normal(shape), dtype)
    wk, vk, _ = js._jacobi_in(wr, v, 1, the_plan)
    cons = (wr.double() @ vk.double() - wk.double()).abs().max()
    assert float(cons) <= unit * float(wr.abs().max())
    assert float((vk.mT @ vk - v).abs().max()) <= unit


# (Nb, M, N) for rrqr_kernel: the first three in shared memory in both
# dtypes; (2, 300, 260) on a cluster in both
RRQR_SHAPES = [(3, 24, 16), (2, 16, 24), (4, 128, 128), (2, 300, 260)]

# every cluster size rrqr_kernel's plan can choose, on the 512² shape of
# rrqr_decomp's batch (clusters of 1-4 leave columns in L2 in float32, 1-8
# in float64); config 2's systems in shared memory; the batch of 32 of
# 512², one wave of clusters of 3
RRQR_LAUNCHES = (
    [((4, 512, 512), c, dtype) for dtype in DTYPES
     for c in rk.placements(512, 512, dtype)]
    + [((256, 128, 128), 1, dtype) for dtype in DTYPES]
    + [((32, 512, 512), 3, torch.float32)])


@pytest.mark.parametrize("shape,cluster,dtype", RRQR_LAUNCHES)
def test_rrqr_kernel_in_every_launch(cuda, shape, cluster, dtype):
    """The kernel in a given launch against its plain version: pivots equal
    in float64 (in float32 a near-tie of two norms may pivot either way,
    and then the rest of that matrix differs), R, V and taus within
    32·eps·max(M, N)·max|A| on the matrices with equal pivots, and
    A[:, P] = Q·R by the port's Q build on every matrix."""
    rng = np.random.default_rng(64 + cluster)
    nb, m, n = shape
    a = _on(cuda, rng.standard_normal(shape), dtype)
    before = rk.launches
    got = rk._rrqr_in(a, rk.launch_on(m, n, dtype, cluster))
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    want = rk.rrqr_kernel_ref(a)
    same = (got[3] == want[3]).all(dim=-1)
    if dtype == torch.float64:
        assert bool(same.all())
    unit = 32 * torch.finfo(dtype).eps * max(m, n)
    amax = float(a.abs().max())
    if bool(same.any()):
        for g, r, scale in zip(got[:3], want[:3], (amax, 1.0, 1.0)):
            assert float((g[same] - r[same]).abs().max()) <= unit * scale
    q, r, p = rrqr_mod._rrqr_assemble(*got, True)
    ap = torch.gather(a, 2, p.long()[:, None, :].expand(a.shape))
    assert float((q @ r - ap).abs().max()) <= unit * amax


@pytest.mark.parametrize("shape", RRQR_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rrqr_kernel_matches_plain_version(cuda, shape, dtype):
    """The kernel against its plain version, from an A with a zero column
    (τ = 0 when it is reached) and two equal columns (the lower index
    first, and a numerically zero column left once one is taken, where
    K = N); A[:, P] = Q·R by the port's Q build."""
    rng = np.random.default_rng(61 + shape[-1])
    a0 = rng.standard_normal(shape)
    a0[0, :, 2] = 0.0
    a0[-1, :, 5] = a0[-1, :, 3]
    a = _on(cuda, a0, dtype)
    before = rk.launches
    got = rk.rrqr_kernel(a)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    want = rk.rrqr_kernel_ref(a)
    assert got[3].dtype == torch.int32
    # in float32 a near-tie of two norms may pivot either way (and then
    # the rest of that matrix differs); in float64 the pivots must agree
    same = (got[3] == want[3]).all(dim=-1)
    if dtype == torch.float64:
        assert bool(same.all())
    assert bool(same.any())
    eps = torch.finfo(dtype).eps
    unit = 32 * eps * max(shape[1:])
    amax = float(a.abs().max())
    # the reflector of a numerically zero trailing column (the duplicate's,
    # once its twin is taken) is rounding noise over rounding noise, in
    # either version: V and taus are compared on the live steps, those
    # with |R_jj| above rrqr_rank's eps·max(M, N)·|R_00|
    d = torch.diagonal(want[0], dim1=-2, dim2=-1).abs()
    live = (d > eps * max(shape[1:]) * d[:, :1])[same]
    assert float((got[0][same] - want[0][same]).abs().max()) <= unit * amax
    vg, vw = got[1][same], want[1][same]
    assert float(((vg - vw).abs() * live[:, None, :]).max()) <= unit
    tg, tw = got[2][same], want[2][same]
    assert float(((tg - tw).abs() * live).max()) <= unit
    q, r, p = rrqr_mod._rrqr_assemble(*got, True)
    ap = torch.gather(a, 2, p.long()[:, None, :].expand(a.shape))
    assert float((q @ r - ap).abs().max()) <= unit * amax


@pytest.mark.parametrize("dtype", DTYPES)
def test_svd_rrqr_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """svd_decomp (jacobi below 128, gram with both preconditioners),
    lstsq, eigh via the SVD, rrqr_decomp and solve on the card against the
    same calls on the CPU: σ, w, R and x directly (within 100·TOL), U, V,
    Q by their contracts; each kernel launched as the path says."""
    rng = np.random.default_rng(62)
    eps = torch.finfo(dtype).eps
    tol = 100 * TOL[dtype]
    a = rng.standard_normal((3, 40, 30))
    y = rng.standard_normal((3, 40, 2))
    before = js.launches
    u, sv, v = la.svd_decomp(_on(cuda, a, dtype))
    torch.cuda.synchronize()
    assert js.launches > before
    _, svc, _ = la.svd_decomp(torch.from_numpy(a).to(dtype))
    assert float((sv.cpu() - svc).abs().max()) <= tol * float(svc.max())
    rec = (u * sv[..., None, :]) @ v - _on(cuda, a, dtype)
    assert float(rec.abs().max()) <= 32 * eps * 40 * np.abs(a).max()
    eye = torch.eye(30, device=cuda, dtype=dtype)
    assert float((u.mT @ u - eye).abs().max()) <= 4 * eps * 40
    assert float((v @ v.mT - eye).abs().max()) <= 4 * eps * 40
    x = la.lstsq(_on(cuda, a, dtype), _on(cuda, y, dtype))
    xc = la.lstsq(torch.from_numpy(a).to(dtype), torch.from_numpy(y).to(dtype))
    assert float((x.cpu() - xc).abs().max()) <= \
        tol * float(xc.abs().max()) * np.linalg.cond(a).max()
    sq = rng.standard_normal((2, 130, 130))
    before = sp.launches
    for precond in ("qlp", "spectral"):
        _, sv, _ = la.svd_gram(_on(cuda, sq, dtype), precond=precond)
        _, svc, _ = la.svd_gram(torch.from_numpy(sq).to(dtype),
                                precond=precond)
        assert float((sv.cpu() - svc).abs().max()) <= tol * float(svc.max())
    torch.cuda.synchronize()
    assert sp.launches == before + 3       # the spectral seed: 3 panels
    sym = sq + np.swapaxes(sq, -1, -2)
    w, _ = la.eigh(_on(cuda, sym, dtype), method="via_svd")
    wc, _ = la.eigh(torch.from_numpy(sym).to(dtype), method="via_svd")
    assert float((w.cpu() - wc).abs().max()) <= \
        tol * float(np.sqrt((sym * sym).sum(axis=(-2, -1))).max())
    before = rk.launches
    q, r, p = la.rrqr_decomp(_on(cuda, sq, dtype))
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    qc, rc, pc = la.rrqr_decomp(torch.from_numpy(sq).to(dtype))
    if dtype == torch.float64 or torch.equal(p.cpu(), pc):
        assert torch.equal(p.cpu(), pc)
        assert float((r.cpu() - rc).abs().max()) <= tol * np.abs(sq).max()
    ap = torch.gather(_on(cuda, sq, dtype), 2,
                      p.long()[:, None, :].expand(2, 130, 130))
    assert float((q @ r - ap).abs().max()) <= 32 * eps * 130 * np.abs(sq).max()
    eye = torch.eye(130, device=cuda, dtype=dtype)
    assert float((q.mT @ q - eye).abs().max()) <= 4 * eps * 130
    ys = rng.standard_normal((2, 130, 1))
    xs = la.solve(_on(cuda, sq, dtype), _on(cuda, ys, dtype))
    xsc = la.solve(torch.from_numpy(sq).to(dtype),
                   torch.from_numpy(ys).to(dtype))
    assert_backward_stable(torch.from_numpy(sq).to(dtype),
                           torch.from_numpy(ys).to(dtype), xs, xsc, dtype)


# ---------------------------------------------------------- general eigen


def chase_case(rng, w, nb, k0, lo, hi, seed):
    """A slide's input as the Schur loop hands it over: a Hessenberg block,
    zero subdiagonals at the window's edges lo and hi, and each carried
    bulge's column B[kb..kb+2, kb−1] equal to its carry."""
    off = 3 * (nb - 1)
    b = np.triu(rng.standard_normal((w, w)), -1)
    sh = rng.standard_normal((nb, 2))
    p = np.zeros((nb, 3)) if seed else rng.standard_normal((nb, 3))
    for r in (lo - k0 + off, hi - k0 + off):
        if 1 <= r < w:
            b[r, r - 1] = 0.0
    for i in range(0 if seed else nb):
        kb = off - 3 * i
        if lo <= k0 - 3 * i <= hi - 2 and kb >= 1:
            b[kb:kb + 3, kb - 1] = p[i]
    return b, p, sh


def chase_contract(b, v, pp, k0, lo, hi, sl):
    """The largest entry of B' = Vᵀ·B·V below the subdiagonal outside the
    three entries of each bulge active at the last step, and the largest
    miss between those bulges' carries and their columns
    B'[kb+1..kb+3, kb], in float64 on the host."""
    b, v, pp = (x.double().cpu().numpy() for x in (b, v, pp))
    w, nb = b.shape[-1], pp.shape[0]
    off, t = 3 * (nb - 1), sl - 1
    bp = v.T @ b @ v
    junk = np.tril(bp, -2)
    miss = 0.0
    for i in range(nb):
        k, kb = k0 + t - 3 * i, t + off - 3 * i
        if not lo <= k <= hi - 2:
            continue
        for r, c in ((kb + 2, kb), (kb + 3, kb), (kb + 3, kb + 1)):
            if r < w:
                junk[r, c] = 0.0
        want = [bp[kb + 1 + j, kb] if kb + 1 + j < w and (j < 2 or k + 3 < hi)
                else 0.0 for j in range(3)]
        miss = max(miss, np.abs(pp[i] - want).max())
    return np.abs(junk).max(), miss


# the main path's slides, then each W of the layouts (ld, update and
# accumulator warps, V_acc in shared or global memory) with NB ∈ {1, 4, 16}
# where a slide of 8 steps fits, seeded (k0 = 0) and carried mid-sweep: every
# bulge active from the first step (as the Schur loop's later slides hand
# them over: a carried bulge never enters unseeded), the lead one leaving
# at hi − 2 within the slide
CHASE_CASES = [(128, 16, 0), (128, 16, 80), (128, 1, 0), (32, 2, 7)] + [
    (w, nb, k0) for w in (32, 64, 100, 128) for nb in (1, 4, 16)
    if 8 + 3 * nb <= w for k0 in (0, 3 * (nb - 1) + (w - 3 * nb) // 2)
    if (w, nb, k0) not in ((128, 16, 0), (128, 1, 0))]


@pytest.mark.parametrize("w,nb,k0", CHASE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bulge_chase_kernel_matches_plain_version(cuda, w, nb, k0, dtype):
    """The full slide by its contract (a long train amplifies the two
    sides' rounding, so V_acc itself is not compared): Vᵀ·B·V Hessenberg
    outside the bulges' last positions and the carries equal to its bulge
    columns, within eps·W·max|B| (the plain version stays under 0.04 of
    that), V_acc orthogonal. Its first 8 steps entry by entry within
    TOL. Float64 at W = 128 keeps V_acc in global memory."""
    rng = np.random.default_rng(70 + w + nb + k0)
    lo, hi = 0, w - 2
    seed = k0 == 0
    b, p, sh = (_on(cuda, x, dtype)
                for x in chase_case(rng, w, nb, k0, lo, hi, seed))
    eps = torch.finfo(dtype).eps
    eye = torch.eye(w, device=cuda, dtype=dtype)
    unit = eps * w * float(b.abs().max())
    for sl in (w - 3 * nb, 8):
        before = bc.launches
        v, pp = bc.bulge_chase_steps(b, p, sh, k0, lo, hi, sl, seed)
        torch.cuda.synchronize()
        assert bc.launches == before + 1
        junk, miss = chase_contract(b, v, pp, k0, lo, hi, sl)
        assert junk <= unit and miss <= unit
        assert float((v.mT @ v - eye).abs().max()) <= 64 * eps * w
    vr, pr = bc.bulge_chase_steps_ref(b, p, sh, k0, lo, hi, sl, seed)
    assert float((v - vr).abs().max()) <= TOL[dtype]
    assert float((pp - pr).abs().max()) <= \
        TOL[dtype] * max(1.0, float(pr.abs().max()))


@pytest.mark.parametrize("shape", [(1, 48, 48), (1, 128, 128), (6, 64, 64),
                                   (3, 8, 8), (2, 31, 31), (2, 33, 33),
                                   (1, 100, 100), (300, 64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_schur_small_kernel_contract_and_eigenvalues(cuda, shape, dtype):
    """Every matrix by the contract; the eigenvalues of the first 8 against
    the plain version's (run on the host). W = 31 and 33 sit on either side
    of a whole warp, 300 matrices are more than the card's SMs, and float64
    at 128 keeps Q in global memory."""
    rng = np.random.default_rng(80 + shape[-1])
    a = _on(cuda, np.triu(rng.standard_normal(shape), -1), dtype)
    before = ss.launches
    t, q, lk, its = ss.schur_small(a)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    nb, w, _ = shape
    eps = torch.finfo(dtype).eps
    unit = 64 * eps * w
    a64, t64, q64 = a.double(), t.double(), q.double()
    amax = float(a.abs().max())
    eye = torch.eye(w, device=cuda, dtype=torch.float64)
    assert float((q64.mT @ q64 - eye).abs().max()) <= unit
    assert float((q64 @ t64 @ q64.mT - a64).abs().max()) <= unit * amax
    assert float(torch.tril(t64, -2).abs().max()) <= unit * amax
    assert bool((its > 0).all() and (its <= 40 * w).all())
    for i in range(nb):
        for j in (lk[i, :w - 1] > 0.5).nonzero()[:, 0].tolist():
            blk = t64[i, j:j + 2, j:j + 2]
            assert float((blk[0, 0] - blk[1, 1]) ** 2
                         + 4 * blk[0, 1] * blk[1, 0]) < 0
    tr, _, lkr, _ = ss.schur_small_ref(a[:8].cpu())
    for i in range(min(nb, 8)):
        ev = np.linalg.eigvals(np.triu(t64[i].cpu().numpy(), -1))
        evr = list(np.linalg.eigvals(np.triu(tr[i].double().numpy(), -1)))
        truth = np.linalg.eigvals(a64[i].cpu().numpy())
        own = max(np.min(np.abs(truth - x)) for x in evr)
        tol = 1e3 * eps * w * max(1.0, amax) + 4 * own
        for x in ev:
            d = np.abs(np.asarray(evr) - x)
            k = int(np.argmin(d))
            assert d[k] <= tol
            evr.pop(k)


def _uniform_tiles(n, w):
    return tuple((max(0, k1 - w), k1 - max(0, k1 - w))
                 for k1 in range(n, 0, -w))


def _triangular_batch(rng, B, n, cluster, dtype, cuda):
    tre = np.triu(rng.standard_normal((B, n, n)))
    tim = np.triu(rng.standard_normal((B, n, n)))
    if cluster:
        for i in (10, 70):
            tre[:, i, i], tim[:, i, i] = tre[:, 5, 5], tim[:, 5, 5]
    tre, tim = _on(cuda, tre, dtype), _on(cuda, tim, dtype)
    fi = torch.finfo(dtype)
    small = fi.eps * torch.sqrt((tre ** 2 + tim ** 2).sum((-2, -1))) + fi.tiny
    return [tre, tim, torch.diagonal(tre, dim1=-2, dim2=-1),
            torch.diagonal(tim, dim1=-2, dim2=-1), small, fi.max ** 0.5 / n]


def _unit_cols(x):
    nrm = torch.sqrt((x[0].double() ** 2 + x[1].double() ** 2).sum(
        -2, keepdim=True))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return x[0].double() / nrm, x[1].double() / nrm


# (B, n, cluster, bignum): n = 100 leaves a ragged tile of columns, the
# cluster is three equal diagonal entries (rows 5, 10, 70), a bignum of 30
# rescales many columns several times a block; config 4's (1, 1024, 1024)
TREVC_CASES = [(2, 192, True, None), (2, 256, False, None),
               (2, 100, True, None), (1, 1024, False, None),
               (2, 100, True, 30.0), (1, 192, True, 30.0)]
# the plan's tiles (through the wrapper) and tiles of every width that
# fits one block; config 4's size on the plan's tiles and on 1 and 8
TREVC_LAUNCHES = [
    (case, dtype, tiling) for case in TREVC_CASES for dtype in DTYPES
    for tiling in ["plan"] + list(range(1, 9))
    if (case[1] != 1024 or tiling in ("plan", 1, 8))
    and (tiling == "plan" or max(
        tv.smem_bytes(k0 + w, w, dtype)
        for k0, w in _uniform_tiles(case[1], tiling)) <= _build.SMEM_MAX)]


@pytest.mark.parametrize("case,dtype,tiling", TREVC_LAUNCHES)
def test_trevc_solve_kernel_matches_plain_version(cuda, case, dtype, tiling):
    """Unit columns within TOL of the plain version's; at n = 1024 in
    float32, where the back substitution amplifies rounding by up to ~10³
    eps in both versions alike, within 8 times the plain version's distance
    to a float64 witness (the plain version in float64 on the same input),
    as chip_smoke.py's phase2_trevc."""
    B, n, cluster, bignum = case
    args = _triangular_batch(np.random.default_rng(90 + n), B, n, cluster,
                             dtype, cuda)
    if bignum is not None:
        args[-1] = bignum
    tiles = None if tiling == "plan" else _uniform_tiles(n, tiling)
    before = tv.launches
    xk = tv.trevc_solve(*args) if tiles is None \
        else tv._trevc_solve_in(*args, tiles)
    torch.cuda.synchronize()
    assert tv.launches == before + 1
    assert bool((torch.tril(xk[0], -1) == 0).all())
    xr = tv.trevc_solve_ref(*args)
    gap = max(float((g - r).abs().max())
              for g, r in zip(_unit_cols(xk), _unit_cols(xr)))
    if n == 1024 and dtype == torch.float32:
        wide = [a.double() if torch.is_tensor(a) else a for a in args]
        xw = _unit_cols(tv.trevc_solve_ref(*wide))
        pw = max(float((g - r).abs().max())
                 for g, r in zip(_unit_cols(xr), xw))
        kw = max(float((g - r).abs().max())
                 for g, r in zip(_unit_cols(xk), xw))
        assert kw <= max(TOL[dtype], 8 * pw)
    else:
        assert gap <= TOL[dtype]


def test_trevc_plan_on_the_card_covers_every_column(cuda):
    for dtype in DTYPES:
        tiles = tv.card_plan(1, 1024, dtype, cuda)
        cover = np.zeros(1024, int)
        for k0, w in tiles:
            cover[k0:k0 + w] += 1
        assert (cover == 1).all()


def _eigen_resid(a, lam, vec):
    lr, li = (x.double()[..., None, :] for x in lam)
    vr, vi = (x.double() for x in vec)
    er = a.double() @ vr - (vr * lr - vi * li)
    ei = a.double() @ vi - (vr * li + vi * lr)
    return torch.sqrt(er ** 2 + ei ** 2).amax((-2, -1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigen_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """eigen at n = 192 (AED, sweeps, small_win and the trevc_solve kernel),
    n = 200 (trevc's plain blocked form on the card) and a (4, 30, 30)
    batch (one schur_small launch): bench.py's gate per matrix, unit
    columns, and the eigenvalues nearest-matched with the CPU's."""
    rng = np.random.default_rng(95)
    for shape in ((192, 192), (200, 200), (4, 30, 30)):
        a = rng.standard_normal(shape)
        n = shape[-1]
        before = (ss.launches, bc.launches, tv.launches)
        lam, vec = la.eigen(_on(cuda, a, dtype), split=True)
        torch.cuda.synchronize()
        got = (ss.launches - before[0], bc.launches - before[1],
               tv.launches - before[2])
        if len(shape) == 3:
            assert got == (1, 0, 0)
        else:
            assert got[0] > 0 and got[1] > 0 and got[2] == int(n % 64 == 0)
        resid = _eigen_resid(_on(cuda, a, dtype), lam, vec)
        gate = 1e-4 * np.abs(a).max(axis=(-2, -1)) * n ** 0.5
        assert bool((resid.cpu().numpy() <= gate).all())
        nrm = (vec[0].double() ** 2 + vec[1].double() ** 2).sum(-2)
        assert float((nrm - 1).abs().max()) <= 1e-4
        lc = la.eigenvals(torch.from_numpy(a).to(dtype), split=True)
        lk = (lam[0].cpu().double().numpy()
              + 1j * lam[1].cpu().double().numpy())
        lcc = lc[0].double().numpy() + 1j * lc[1].double().numpy()
        for i in range(lk.reshape(-1, n).shape[0]):
            ref = list(lcc.reshape(-1, n)[i])
            for x in lk.reshape(-1, n)[i]:
                d = np.abs(np.asarray(ref) - x)
                k = int(np.argmin(d))
                assert d[k] <= 100 * TOL[dtype] * np.abs(a).max() * n ** 0.5
                ref.pop(k)


def test_config4_eigen_meets_the_bench_gate(cuda):
    """Config 4's eigen: one 1024² float32 matrix of standard normals under
    bench.py's gate max‖A·v − λ·v‖ ≤ 1e-4·max|A|·√N (bench.py:446-455),
    through all three kernels, trevc_solve once."""
    a = _on(cuda, np.random.default_rng(96).standard_normal((1024, 1024)),
            torch.float32)
    before = (ss.launches, bc.launches, tv.launches)
    lam, vec = la.eigen(a, split=True)
    torch.cuda.synchronize()
    assert ss.launches > before[0] and bc.launches > before[1]
    assert tv.launches == before[2] + 1
    resid = float(_eigen_resid(a, lam, vec).max())
    assert resid <= 1e-4 * float(a.abs().max()) * 1024 ** 0.5


def _poly4(p, x):
    return p[0] + x * (p[1] + x * (p[2] + x * p[3]))


def _rosen(z):
    return torch.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1.0 - z[:-1]) ** 2)


def _poly4_data(m, dtype):
    rng = np.random.default_rng(40)
    p_true = np.array([0.5, -1.0, 0.25, 2.0])
    x = rng.uniform(-2.0, 2.0, m)
    y = _poly4(p_true, x) + 0.01 * rng.standard_normal(m)
    return x.astype(dtype), y.astype(dtype), p_true


def test_odr_lm_on_the_card_matches_the_cpu_port(cuda):
    """Ten LM iterations of a 256-point poly-4 ODR fit in float64: p, Δx
    and the mse within 1e-8 of the CPU port's (two summation orders), the
    same iterations, and the structured solves' Cholesky leaves on the
    kernel, two launches a solve."""
    x, y, _ = _poly4_data(256, np.float64)
    want = opt.odr_lm(x, y, _poly4, np.zeros(4), max_iter=10, device="cpu")
    before = cl.launches
    got = opt.odr_lm(x, y, _poly4, np.zeros(4), max_iter=10, device=cuda)
    torch.cuda.synchronize()
    launched = cl.launches - before
    assert launched > 0 and launched % 2 == 0
    assert int(got[3]) == int(want[3]) == 10
    for g, w in zip(got[0], want[0]):
        assert float((g.cpu() - w).abs().max()) <= 1e-8 * float(w.abs().max())
    assert abs(float(got[1]) - float(want[1])) <= 1e-8 * float(want[1])


def test_lbfgs_minimize_on_the_card_matches_the_cpu_port(cuda):
    """Thirty L-BFGS iterations of a 16-d Rosenbrock in float64, the
    gradient by torch.func: x and f within 1e-8 of the CPU port's."""
    z0 = -np.ones(16)
    want = opt.lbfgs_minimize(_rosen, z0, max_iter=30, device="cpu")
    got = opt.lbfgs_minimize(_rosen, z0, max_iter=30, device=cuda)
    assert int(got[3]) == int(want[3]) == 30
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-8
    assert abs(float(got[1]) - float(want[1])) <= 1e-8 * float(want[1])


def test_f_closing_over_a_card_tensor_is_taken_as_f(cuda):
    """An f that closes over data on the card (0.5·‖A·z − b‖²) is taken
    as f, its gradient by torch.func, and lbfgs_minimize on the card
    reaches the CPU port's least-squares solution."""
    rng = np.random.default_rng(41)
    a, b = rng.standard_normal((20, 5)), rng.standard_normal(20)
    runs = []
    for dev in ("cpu", cuda):
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

        def f(z, at=at, bt=bt):
            r = at @ z - bt
            return 0.5 * (r * r).sum()
        runs.append(opt.lbfgs_minimize(f, np.zeros(5), max_iter=200,
                                       device=dev)[0].cpu())
    want = np.linalg.lstsq(a, b, rcond=None)[0]
    assert float((runs[1] - runs[0]).abs().max()) <= 1e-8
    assert np.abs(runs[1].numpy() - want).max() < 1e-6


def test_config5_on_the_card_through_the_bench_gate(cuda):
    """bench.py's config 5 at full size in float32 (bench.py:461-516):
    max|p − p_true| < 0.05 and f < 1e-4, one host read an LM iteration
    of the driver plus the λ iteration's."""
    x, y, p_true = _poly4_data(4096, np.float32)
    before = host.reads
    (p, dx), mse, g, it = opt.odr_lm(x, y, _poly4, np.zeros(4, np.float32),
                                     max_iter=40, device=cuda)
    assert host.reads - before <= 40 * 36
    z, fz, gz, itz = opt.lbfgs_minimize(_rosen, -np.ones(128, np.float32),
                                        max_iter=800, device=cuda)
    assert p.is_cuda and p.dtype == torch.float32 and int(it) == 40
    assert float((p.cpu() - torch.from_numpy(p_true)).abs().max()) < 0.05
    assert float(fz) < 1e-4


def _svd_recon(a, u, sv, v) -> float:
    u, sv, v, a = (x.double().cpu() for x in (u, sv, v, a))
    return float(((u * sv[..., None, :]) @ v - a).abs().max())


@pytest.mark.parametrize("method", ["dc", "blocked"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_svd_dc_and_blocked_on_the_card_match_the_cpu(cuda, method, dtype):
    """svd_decomp(method='dc'|'blocked') of a batch (4, 160, 96) with a
    rank-40 matrix on the card, by the contract the CPU port meets on the
    same input: U and V orthonormal to 4·eps·max(M, N), σ descending and
    within 32·eps·max(M, N)·σ₀ of the CPU port's, and U·diag(σ)·V within
    32·eps·max(M, N)·max|A| of A or within 4× the CPU port's own miss
    (the divide and conquer's TGK solve at 2K = 192 misses by about 5e-10
    of max|A| in float64, as the JAX package's does). Both polish with
    chol_leaf and pre-reduce with house_panel."""
    rng = np.random.default_rng(60)
    a = rng.standard_normal((4, 160, 96))
    a[1] = rng.standard_normal((160, 40)) @ rng.standard_normal((40, 96))
    a = torch.from_numpy(a).to(dtype)
    eps = torch.finfo(dtype).eps
    before = (hp.launches, cl.launches)
    u, sv, v = la.svd_decomp(a.to(cuda), method=method)
    torch.cuda.synchronize()
    assert hp.launches > before[0] and cl.launches > before[1]
    ref = la.svd_decomp(a, method=method)
    eye = torch.eye(96, dtype=torch.float64)
    for q in (u.mT @ u, v @ v.mT):
        assert float((q.double().cpu() - eye).abs().max()) <= 4 * eps * 160
    assert bool((sv >= 0).all() and (torch.diff(sv, dim=-1) <= 0).all())
    assert float((sv.cpu() - ref[1]).abs().max()) \
        <= 32 * eps * 160 * float(ref[1][..., 0].max())
    assert _svd_recon(a, u, sv, v) <= max(
        32 * eps * 160 * float(a.abs().max()), 4 * _svd_recon(a, *ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pldlp_on_the_card_matches_the_cpu(cuda, dtype):
    """pldlp_decomp of symmetric indefinite (64, 48, 48) on the card: A[P]
    [:, P] = L·D·Lᵀ and the solve's residual within N·eps·max|A|·max|x|,
    P and blk equal to the CPU port's in float64 (both round alike
    there)."""
    rng = np.random.default_rng(61)
    s = rng.standard_normal((64, 48, 48))
    a = torch.from_numpy((s + np.swapaxes(s, -1, -2)) / 2).to(dtype)
    y = torch.from_numpy(rng.standard_normal((64, 48, 2))).to(dtype)
    ld, p, blk = la.pldlp_decomp(a.to(cuda))
    x = la.pldlp_solve(ld, p, blk, y.to(cuda)).cpu()
    l, d = la.pldlp_l(ld, blk).cpu(), la.pldlp_d(ld, blk).cpu()
    ap = torch.gather(torch.gather(a, 1, p.long().cpu()[:, :, None]
                                   .expand(a.shape)),
                      2, p.long().cpu()[:, None, :].expand(a.shape))
    eps = torch.finfo(dtype).eps
    amax = float(a.abs().max())
    assert float((l @ d @ l.mT - ap).abs().max()) <= 1e3 * eps * amax
    assert float((a @ x - y).abs().max()) \
        <= 48 * eps * amax * float(x.abs().max()) * 48
    if dtype == torch.float64:
        _, p_ref, blk_ref = la.pldlp_decomp(a)
        assert torch.equal(p.cpu(), p_ref) and torch.equal(blk.cpu(),
                                                          blk_ref)


@pytest.mark.parametrize("method", ["2sided", "classic"])
def test_sequential_jacobi_on_the_card_matches_the_cpu(cuda, method):
    """svd_jac_2sided and svd_jac_classic of a (4, 14, 10) float64 batch
    with a rank-4 matrix on the card, run twice (the second run replays
    its sweeps or runs of rotations as CUDA graphs): σ within
    32·eps·max(M, N)·σ₀ of the CPU port's, U and V orthonormal to
    4·eps·max(M, N), U·diag(σ)·V = A within 32·eps·max(M, N)·max|A|;
    Kogbetliantz's sweeps per matrix equal the CPU's."""
    rng = np.random.default_rng(62)
    a = rng.standard_normal((4, 14, 10))
    a[1] = rng.standard_normal((14, 4)) @ rng.standard_normal((4, 10))
    a = torch.from_numpy(a)
    fn = la.svd_jac_2sided if method == "2sided" else la.svd_jac_classic
    ref = fn(a)
    eps = torch.finfo(torch.float64).eps
    for _ in range(2):
        u, sv, v = (x.cpu() for x in fn(a.to(cuda)))
        assert float((sv - ref[1]).abs().max()) \
            <= 32 * eps * 14 * float(ref[1][:, 0].max())
        eye = torch.eye(10, dtype=torch.float64)
        assert float((u.mT @ u - eye).abs().max()) <= 4 * eps * 14
        assert float((v @ v.mT - eye).abs().max()) <= 4 * eps * 14
        assert float(((u * sv[..., None, :]) @ v - a).abs().max()) \
            <= 32 * eps * 14 * float(a.abs().max())
    if method == "2sided":
        kog = importlib.import_module("nd4js_tpu_torch.la.svd_kogbetliantz")
        r = torch.linalg.qr(a)[1]
        tol = 10 * eps
        want = kog._kog_core(r, 30, tol)[3]
        for _ in range(2):
            got = kog._kog_core(r.to(cuda), 30, tol)[3]
            assert got.cpu().tolist() == want.tolist()


def _lbfgsb_state(n, steps):
    """The port's L-BFGS-B state after ``steps`` steps on the n-d
    Rosenbrock in [−2, 0.5]ⁿ from −1s, float64 on the CPU."""
    lbfgsb = importlib.import_module("nd4js_tpu_torch.opt.lbfgsb")
    fg, lo, hi, st = lbfgsb._init_b(_rosen, -np.ones(n), (-2.0, 0.5), 8,
                                    "cpu")
    for _ in range(steps):
        st = lbfgsb._lbfgsb_step(fg, lo, hi, st)
    return lbfgsb, fg, lo, hi, st


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*(_to(t, dev) for t in tree))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def test_lbfgsb_cauchy_point_subspace_step_and_steps_on_the_card(cuda):
    """On a 64-d state with a full memory, float64: the Cauchy point, c
    and the subspace minimiser within 1e-12·max(1, |value|) of the CPU
    port's and ``free`` equal; then three L-BFGS-B steps from that state
    (the card's direction eager, captured as a CUDA graph, replayed),
    every field within 1e-10 relative of the CPU's."""
    sol = importlib.import_module("nd4js_tpu_torch.opt._lbfgsb_solver")
    lbfgsb, fg, lo, hi, st = _lbfgsb_state(64, 12)
    rng = np.random.default_rng(70)
    g = torch.from_numpy(rng.standard_normal(64))
    outs = []
    for dev in ("cpu", cuda):
        wk = sol.compact_wk(_to(st.mem, dev))
        x, gd, lod, hid = (t.to(dev) for t in (st.x, g, lo, hi))
        x_cp, c, free = sol.cauchy_point(wk, x, gd, lod, hid)
        x_bar = sol.subspace_step(wk, x, gd, x_cp, c, free, lod, hid)
        outs.append([t.cpu() for t in (x_cp, c, free, x_bar)])
    (x_cp, c, free, x_bar), want = outs[1], outs[0]
    assert torch.equal(free, want[2]) and (~free).any()
    for got, w in ((x_cp, want[0]), (c, want[1]), (x_bar, want[3])):
        assert float((got - w).abs().max()) \
            <= 1e-12 * max(1.0, float(w.abs().max()))
    cpu_st, card_st = st, _to(st, cuda)
    for _ in range(3):
        cpu_st = lbfgsb._lbfgsb_step(fg, lo, hi, cpu_st)
        card_st = lbfgsb._lbfgsb_step(fg, lo.to(cuda), hi.to(cuda), card_st)
        for got, w in zip(_leaves(card_st), _leaves(cpu_st)):
            got = got.cpu()
            if w.dtype.is_floating_point:
                assert float((got - w).abs().max()) \
                    <= 1e-10 * max(1e-300, float(w.abs().max()))
            else:
                assert torch.equal(got, w)


def test_lbfgsb_minimize_on_the_card_matches_the_cpu_port(cuda):
    """lbfgsb_minimize of a 16-d Rosenbrock in [−2, 0.5]¹⁶, float64: the
    same iterations, x within 1e-8 of the CPU port's."""
    z0 = -np.ones(16)
    want = opt.lbfgsb_minimize(_rosen, z0, (-2.0, 0.5), device="cpu")
    got = opt.lbfgsb_minimize(_rosen, z0, (-2.0, 0.5), device=cuda)
    assert int(got[3]) == int(want[3])
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-8


@pytest.mark.parametrize("dtype", DTYPES)
def test_kdtree_nearest_on_the_card_matches_the_cpu(cuda, dtype):
    """KDTree.nearest on the card returns the CPU's indices, ties
    included (a 6×6 lattice queried at lattice points, cell centres and
    edge midpoints, whose squared distances are exact), and on 2000
    seeded normal points in 4-d; distances within TOL·max(1, max dist)."""
    g = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0),
                             indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(71)
    lattice = (g[rng.permutation(len(g))],
               np.array([[2.0, 2.0], [1.5, 1.5], [2.0, 0.5], [0.0, 0.0],
                         [5.5, 5.5], [3.0, 1.5]]))
    normal = (rng.standard_normal((2000, 4)), rng.standard_normal((64, 4)))
    for pts, q in (lattice, normal):
        for k in (1, 4, 9, 17):
            want = utils.KDTree(torch.from_numpy(pts).to(dtype)).nearest(
                torch.from_numpy(q).to(dtype), k=k)
            got = utils.KDTree(torch.from_numpy(pts).to(cuda, dtype)).nearest(
                torch.from_numpy(q).to(cuda, dtype), k=k)
            assert torch.equal(got[1].cpu(), want[1]), k
            assert float((got[0].cpu() - want[0]).abs().max()) \
                <= TOL[dtype] * max(1.0, float(want[0].abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstsq_of_a_tall_matrix_on_the_card_matches_the_cpu(cuda, dtype):
    """lstsq of (4096, 16), fit_lin's shape on config 5's points: its
    pre-QR panel has more rows than one block of the stripe kernel can
    stage, so the stripe is staged in global memory (before, the plan
    raised). x within 1e3·eps·max|x| of the CPU port's (κ(A) about 5)."""
    rng = np.random.default_rng(72)
    t = rng.uniform(-1.0, 1.0, 4096)
    a = np.stack([np.cos(k * np.arccos(t)) for k in range(16)], -1)
    y = (t ** 3 - t + 0.01 * rng.standard_normal(4096))[:, None]
    want = la.lstsq(torch.from_numpy(a).to(dtype), torch.from_numpy(y).to(
        dtype))
    before = hp.launches
    got = la.lstsq(_on(cuda, a, dtype), _on(cuda, y, dtype))
    torch.cuda.synchronize()
    assert hp.launches >= before + 1
    eps = torch.finfo(dtype).eps
    assert float((got.cpu() - want).abs().max()) \
        <= 1e3 * eps * float(want.abs().max())


# ------------------------------------------------- core surface and io

def _hard_sum(rng, shape):
    """Entries over 16 decades with cancelling signs."""
    return rng.standard_normal(shape) * 10.0 ** rng.uniform(-8, 8, shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,axis", [((300, 1000), 0), ((5000,), None),
                                        ((7, 64, 33), 1), ((40, 3), -1)])
def test_kahan_sum_kernel_is_bit_equal_to_its_plain_version(cuda, dtype,
                                                            shape, axis):
    """The kernel and its plain version run the same recurrence in the
    same order with every add rounded alone: bit-equal, NaN and ±inf
    lanes included; one launch a call."""
    from nd4js_tpu_torch.core import kahan
    from nd4js_tpu_torch.ops import kahan_sum as ks
    x = _hard_sum(np.random.default_rng(sum(shape)), shape)
    x.reshape(-1)[:4] = [np.inf, np.nan, -np.inf, 1.0]
    want = kahan.kahan_sum(torch.from_numpy(x).to(dtype), axis=axis)
    before = ks.launches
    got = kahan.kahan_sum(_on(cuda, x, dtype), axis=axis)
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == dtype
    assert torch.equal(got.isnan().cpu(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got.cpu()[fin], want[fin])


def test_kahan_sum_on_the_card_refuses_other_types_and_skips_empty(cuda):
    from nd4js_tpu_torch.core import kahan
    from nd4js_tpu_torch.ops import kahan_sum as ks
    with pytest.raises(TypeError):
        kahan.kahan_sum(torch.arange(5, device=cuda))
    before = ks.launches
    out = kahan.kahan_sum(torch.zeros(0, 4, device=cuda), axis=0)
    assert ks.launches == before and torch.equal(out.cpu(), torch.zeros(4))


@pytest.mark.parametrize("fmt", ["npy", "b64", "istr"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.int32, torch.bool])
def test_io_of_a_card_tensor_round_trips_bit_exact(cuda, fmt, dtype):
    """Serializing a card tensor gives the bytes of its host copy; the
    deserializers put the result on the card by default."""
    from nd4js_tpu_torch import io as tio
    host = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 5)) * 100).to(dtype)
    card = host.to(cuda)
    if fmt == "npy":
        text = tio.npy_serialize(card)
        assert text == tio.npy_serialize(host)
        back = tio.npy_deserialize(text)
    elif fmt == "b64":
        text = tio.b64_encode(card)
        assert text == tio.b64_encode(host)
        back = tio.b64_decode(text, dtype, (6, 5))
    else:
        text = tio.istr_stringify(card)
        assert text == tio.istr_stringify(host)
        back = tio.istr_parse(text)
    assert back.device.type == "cuda" and back.dtype == dtype
    assert back.cpu().numpy().tobytes() == host.numpy().tobytes()


def test_array_creation_lands_on_the_card(cuda):
    import nd4js_tpu_torch as nd
    a = nd.array(np.arange(6.0).reshape(2, 3))
    assert a.device.type == "cuda" and a.dtype == torch.float32
    h = nd.tabulate((64, 64), "float64", lambda i, j: 1 / (i + j + 1).double())
    i, j = np.indices((64, 64))
    assert h.device.type == "cuda"
    assert np.array_equal(h.cpu().numpy(), 1 / (i + j + 1))
    w = nd.NDArray(np.eye(3))
    assert (w @ w).data.device.type == "cuda"
    assert np.array_equal(np.asarray(w), np.eye(3, dtype=np.float64))
