#!/usr/bin/env python3
"""Drive the gpx_torch main path on one CUDA card and hold every kernel of
that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi); TF32 off; build the CUDA
   sources under gpx_torch/csrc (nvcc, sm_90a), printing the build time;
2. each kernel against its plain version at the shapes the main paths give
   it, with the tolerance and its reason (the Gram at N = 16384 and on its
   edge paths: ragged and odd n, a cross block with an odd m, D = 12 with
   duplicated points where White must fire exactly, K bitwise K^T and
   repeated calls bitwise, its time beside the card's fill floor; trmm and
   syrk_lower in f32 ulps
   of each entry's sum of |terms| against float64, on ragged shapes and
   unaligned views too; syrk_lower's writes on i >= j only, aliased and
   repeated calls bitwise; the leaf at t = 128 and 100; the gradient at
   n = 4096, 4160 and 16384, repeated calls bitwise; the probe kernel at
   s = 64 and 128 (N = 16384), 96, 41 and 1 (n = 4096), 64 (n = 4160), on
   the hybrid's own two blocks, against the plain version of its 3xTF32
   product, with identity probes against the exact kernel, repeated calls
   bitwise); kernel, plain and
   library times; the spine factorization and its solves; chol_inv's
   products by level; chol_inv at base 64 and 128 on a padded Gram;
   then (``phase_families``) the Gram and gradient kernels on every other
   family of the term table (Matern 1/2 ... 7/2, RQ, Periodic, each plus
   White, SE * Periodic + White, and F3 = (SE + Matern 3/2) * Periodic +
   White, a Product of a Sum whose Periodic sits in two products of the
   expansion) against float64, the ARD leg at D = 3 in both gradient
   kernels (Ard(F3) among them), F3's probe kernel at s = 64, each
   family's times beside SE + White's, and the ARD leg's cost at D = 3
   and 16;
3. the end-to-end bench case (numpy seed 0, x ~ U(-10, 10) of shape
   (16384, 1), y ~ N(0, 1), SE(3.0, 5.5) + White(0.5), float32) through
   ``gp.logml_value_and_grad``, held against the non-fused route run in
   float64 on the card, and each term of its value against float64; every
   kernel's launch count in that call; ms/eval;
   fused against non-fused times at n = 1024 ... 16384; then the same case
   through ``method="hybrid"`` (three probe seeds, and n = 9000), its
   launch counts, ms/eval and the times of its stages; then
   (``phase_families_e2e``) F1, SE(2, 3) * Matern(1, 5/2, 4) + White(0.1),
   F2, Ard(Matern(2, 5/2, 1) + White(0.25)) on D = 3, and F3 through the
   exact path on the same data, F2 and F3 through the hybrid, a Product
   of Sums past the term table (the torch.linalg route; the hybrid
   raises), and a Gram that is not positive definite (NaN on both exact
   routes, -inf when safe);
3b. prediction (``phase_predict``, BASELINE config 5): ``gp.fit`` from the
   bench data to the grid linspace(-10, 10, 16384), first as drawn (its
   one coincident pair), then with the pair merged, for SE + White and F3
   on the fused route (launch counts, mean and variance against float64
   beside the float32 torch.linalg route, ms per fit on both routes, the
   stages and the left_lower trmm against its bound), ``full_cov`` and
   ``posterior_draw`` at M = 1024, ``draw`` at N = 16,384;
4. the matrix-free path (``phase_iterative``, the case of
   ``examples/large_n.py``): the two matvec kernels against float64 and
   against their plain TF32 versions (SE + White at R = 1, 8, 9, 256,
   Matern 3/2 + White, a product, F3, D = 2, 12 and 20, a repeated call
   bitwise; every family timed),
   ``gp_iterative.logml_value_and_grad_iterative`` at N = 32,768
   (three seeds) against the dense float64 logML and against the same
   estimator in float64, one Matern 3/2 + White eval and one F3 eval
   likewise,
   ``fit_iterative`` against a dense float64 posterior, one eval at
   N = 131,072 with its memory, launch counts, stage times and ms/eval;
5. the sampler slice (``phase_sampler``): the 2-pass legs (``fast=True``)
   of trmm (both M21 modes, 8192^2, ragged and unaligned views) and of
   logml_kernel_grads (n = 4096, 4160, 16384; F2's ARD leg) against
   plain versions that round the same operand to TF32, within the 3-pass
   checks' limits, a repeated call bitwise, and each check shown to fail
   for the other operand rounded; the bench case through
   ``logml_value_and_grad(fast_gradients=True)`` (chol_inv(fast=True)'s
   L bitwise, M apart only in the outermost M21; every output within the
   JAX package's recorded fast-mode deviation against float64; fast and
   exact ms/eval in turns); then benchmarks/sampler_scale.py's MAP init
   at its --ess case, n = 4096 (``optimize``, L-BFGS on the fused route,
   60 steps), and ``infer.sample_hmc`` from that MAP with jitter 0.02
   (recovery, split R-hat, accept rates, launch counts, ms per leapfrog
   gradient, min ESS and ESS/s), ``gradients="hybrid"`` on the same data,
   and one chain at N = 16,384;
6. the workflows (``phase_workflows``): ``optimize`` on sampler_scale.py's
   data at N = 16,384 by L-BFGS on the fused route (launch counts, logML
   evaluations per step, ms per step; the trace's tail within 1e-4 of
   the value; the float64 gradient at the optimum within 10x the float32
   noise there), by Adam on the hybrid (80 steps, twice with one key:
   bitwise alike, the probe kernel launched, its exact log posterior
   within 3.91 nats of the L-BFGS optimum's), by Adam on the iterative route
   at examples/large_n.py's N = 32,768 (15 steps: gram_matvec launched,
   finite, improving), and, as a measurement only, L-BFGS on the hybrid
   log density; then from phase 5's MAP at n = 4096 ``sample_nuts``
   (recovery, split R-hat, depth, ms per gradient beside HMC's, ESS/s),
   ``sample_ehmc`` (recovery, the U-turn lengths), ``sample_mh`` (the
   value route: the Gram kernel, no gradient kernel; recovery, accept
   rates) and ``sample_mh_within_gibbs`` (a known plane added to y,
   recovered), and one NUTS chain at N = 16,384; each part's seconds;
7. the sparse and multi-output models (``phase_models``), each at full
   width in float32 against the same port code in float64 on the card, with
   the float32 plain route (no CUDA kernel) as a witness where float32 is
   the limit (an output that the witness misses by more than WITNESS_CAP
   is printed as not held), each kernel held directly against float64 at
   the path's own shapes (Kuu, Kuf, the ICM's and the grid axes' Grams,
   ``gram_matvec`` at T R = 136 columns, ``cross_matvec`` at the fit's
   shape), and the launches of the Gram kernel, ``gram_matvec`` and
   ``cross_matvec`` per step or evaluation: (a) SGPR on
   benchmarks/svgp_scale.py's data (N = 262,144, M = 1024), the bound and
   its gradient with their peak memory, and fit; (b) ``svgp.train`` there
   (500 steps, batch 2048): ms per step, points/s, the ELBO, the trained
   noise, one minibatch gradient against float64, held-out RMSE and NLPD
   beside an exact ``gp.fit`` from a subsample; (c) ``svgp_mo.train``
   (T = 4, Q = 2, M = 512, 200 steps, 10% masked) and its fit; (d) the
   ICM of benchmarks/multioutput_scale.py at N = 4096, T = 4, kron and
   dense, timed there, their gradients held on the same data with a B of
   distinct eigenvalues; an LMC and a mask, fit; (e) the matrix-free ICM
   at N = 16,384, T = 8 (ms/eval, CG iterations), held against the same
   estimator in float64 on the same probes with a B of distinct
   eigenvalues, at N = 4096 against the dense float64 logML, and
   ``fit_iterative``;
   (f) benchmarks/grid_scale.py's 4096 x 64 lattice, the logML and its
   gradient, and fit;
8. classification and the state-space models (``phase_statespace``), in
   float32 on the card against the same code in float64: (a) softmax-
   Laplace ``classify`` on examples/mnist_classify.py's blob digits at
   MNIST's shape (C = 10, D = 784, N = 8192 train, M = 2048 test) with
   the example's shared kernel and a per-class list: the Gram kernel at
   (8192, 784) and the 8192 x 2048 cross block against float64 and timed,
   ``fit`` (Newton count, ms per iteration and per fit, peak memory),
   ``latent_predict`` and ``predict`` (n_mc = 2000, held-out accuracy);
   (b) examples/temperature_dlm.py's DLM (d_state 13, 8 sensors, T =
   1008, 10% NaN): the Kalman filter, smoother, forecast and conjugate
   filter, FFBS, and Gibbs sweeps; (c) examples/dlm_gp.py's DLM-GP (8
   sensors, T = 200) and a 16 x 16 network (T = 720): the replicated GP
   likelihood, the filter with V = Kxx, ``simulate`` and joint Gibbs
   sweeps with their Gram launches; (d) the kron ICM's and the grid's
   float32 gradients, which eigh's VJP made NaN, held against float64;
9. the user-facing layer and the eight examples (``phase_examples``):
   (a) the native CSV library (it must load; its bytes against the
   Python writer's on a (10,000 x 6) float64 chain, read back bitwise,
   ``write_chains_csv`` from the card, both writers' times for 10^6
   values); (b) MH chains on simulated_gp.py's data, 2k draws against k
   draws, a checkpoint and k more, bitwise; (c) every example command on
   the card through its ``main`` with ``--no-plots`` at gpx's data sizes
   (large_n at 16,384, 32,768 and 16,384), cut in depth (EX_*): each
   command's ms, launches and outputs (on the card, finite), large_n
   dense's launches against phase 3's and its value and gradient against
   float64 at phase 3's limits, large_n iterative's value at phase 4's,
   the fits of simulated_gp, temperature_kriging and the ICM forecast at
   the optimum, the DLM forecast and held-out Student-t intervals at
   fixed variances against float64 (a float32 output that misses on both
   float32 routes prints "not held"), accept rates in range, and
   ``posterior-predictive`` reading the chain ``parameters`` wrote; (d)
   ``utils.profiling.profile_gp_stages`` at the bench case (its table,
   the chol_inv stage's fused launches) and a ``device_trace`` of two
   logML evaluations (a warm-up, then one) naming the port's kernels;
10. multi-device (``phase_parallel``, gpx_torch.parallel): (a) a mesh of 1
   over NCCL in this process, ``distributed_logml_value_and_grad`` at the
   bench case against float64 at phase 3's limits (the float32
   torch.linalg route the second limit), its ms/eval in turns with phase
   3's fused route, ``distributed_predict`` at N = 16,383 (the merged
   data), M = 16,384 against float64 at phase 3b's limits; cross_matvec's
   device time at the mesh path's per-rank shape (8192 x 32,768, R = 9)
   beside its bound and ``torch.matmul`` on the prebuilt block; (b) four
   ranks sharing the card over gloo (collectives staged through pinned
   host memory): the same logML and gradient on ``make_mesh(data=4)``
   against float64 and against (a), the iterative logML with ``mesh=`` at
   examples/large_n.py's case (its 8 coincident pairs merged: the mesh
   matvec puts White on the diagonal only, as gpx's) against the single
   card on phase 4's probes, each rank's Gram and cross_matvec launches,
   peak memory and ms/eval; on a 2 x 2
   mesh ``sample_mh_2d`` at N = 16,384 and ``svgp.train(mesh=)`` against
   the single card on the same global minibatches; then ``dryrun_multichip(4)``;
11. a ``kernels`` JSON line, the card line, and the ``ok`` line last.

    python3 chip_smoke.py --no-iterative

runs phases 1-3 only and ends after their summary, with no ``kernels``
line and no ``ok`` line: for comparing two trees on one card, where
phase 4 runs none of the factor's or the gradient's kernels.

    python3 chip_smoke.py --bench-only

runs phase 1 and phase 3's SE + White cases (exact and hybrid) only. They
use nothing that earlier trees of the port lack, so a copy of this script
beside an earlier tree's ``gpx_torch`` times both trees alike.

    python3 chip_smoke.py --matvec-times

runs phase 1 and the matvec kernels' times (R = 1, 8, 9, 256; every
family; N = 131,072; the cross product), the iterative logML's and
fit_iterative's ms/eval only, in one ``matvec_times`` JSON line and with
no ``kernels`` or ``ok`` line. It uses nothing that earlier trees of the
port lack, so a copy of this script beside an earlier tree's
``gpx_torch`` times both trees alike.

    python3 chip_smoke.py --kernel-times

runs phase 1 and the probe kernel's and the Gram's times at N = 16,384
(the probe at s = 1, 8, 64, 128 and with ARD; the Gram for every family
at D = 1 and 2 beside the card's fill floor), the hybrid's probe stage on
the bench case's real blocks, and the exact and hybrid ms/eval, in one
``kernel_times`` JSON line and with no ``kernels`` or ``ok`` line. Like
``--matvec-times`` it runs beside an earlier tree's ``gpx_torch``.

    python3 chip_smoke.py --sampler-only

runs phase 1 and phases 5 and 6 only, with no ``kernels`` or ``ok``
line.

    python3 chip_smoke.py --models-only

runs phase 1 and phase 7 only, with no ``kernels`` or ``ok`` line.

    python3 chip_smoke.py --classify-dlm-only

runs phase 1 and phase 8 only, with no ``kernels`` or ``ok`` line.

    python3 chip_smoke.py --examples-only

runs phase 1 and phase 9 only, with no ``kernels`` or ``ok`` line.

    python3 chip_smoke.py --parallel-only

runs phase 1 and phase 10 only, with no ``kernels`` or ``ok`` line.

Exits non-zero without a result when no CUDA card is present. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at 700 W): FP32 outside the
# tensor cores, dense TF32 on them, and HBM3 bandwidth; exponentials on the
# special-function units, 16 per clock per SM x 132 SMs x 1.98 GHz (boost
# clock)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9
EPS32 = 1.1920928955078125e-07

N_BENCH = 16384
# trmm / syrk_lower outputs against float64, in f32 ulps of each entry's
# sum of |terms|. The tensor core's f32 accumulation truncates: each of the
# 24 MMAs of a 64-deep slab (3 per 8 k) loses at most one ulp of the
# slab's running sum, which is at most the slab's sum of |terms|, and the
# slabs fold exactly. 3xTF32's dropped terms (2^-22 of each product, signs
# at random) and the last rounding add well under one ulp.
PRODUCT_ULPS = 24.0


def bound_ms(*, flops: float = 0.0, nbytes: float = 0.0, exps: float = 0.0,
             tf32_flops: float = 0.0):
    """The least time for the work, in ms, and what bounds it: ``flops``
    on the CUDA cores in FP32, ``tf32_flops`` on the tensor cores,
    ``exps`` on the special-function units, ``nbytes`` of device memory."""
    t_ops = max(flops / PEAK_FP32_FLOPS, tf32_flops / PEAK_TF32_FLOPS,
                exps / PEAK_SFU)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``launches`` calls captured in a CUDA
    graph, replayed ``reps`` times, by CUDA events. For a kernel that runs
    for less time than its Python launch path takes, where ``time_ms``
    would measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(torch, graph.replay, reps=reps) / launches


def _median_ms(torch, fn, reps: int = 5):
    """The median device time of ``reps`` calls of ``fn``, each timed alone
    by CUDA events, and the times rounded to 0.01 ms."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms), [round(t, 2) for t in ms]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _record(name, source, replaces, err, ms, plain_ms, bound, lib_ms):
    """One kernel's entry of the ``kernels`` line (launches set later)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms}


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _hold_ulps(torch, label, got, want, scale, ulps) -> float:
    """A float32 output against its plain version in float64 on the same
    inputs: every entry within ``ulps`` f32 ulps of its sum of |terms|
    (``scale``; entries where it is 0 must match exactly). Returns the
    largest absolute error."""
    err = (got.double() - want).abs()
    worst = float((err / scale.clamp_min(1e-300)).max()) / EPS32
    print(f"{label}: max abs err {float(err.max()):.3e}, worst {worst:.3f} "
          f"f32 ulps of its sum of |terms| (limit {ulps:g}), output scale "
          f"{float(want.abs().max()):.3e}", flush=True)
    check(bool((err <= ulps * EPS32 * scale).all()), f"{label} disagrees")
    return float(err.max())


def _odd_view(torch, rows, cols, ld, off, gen):
    """A (rows, cols) float32 view with leading dimension ``ld`` at element
    ``off`` of its storage (4-byte aligned only for odd ``off``), filled
    with N(0, 1)."""
    buf = torch.randn(off + rows * ld, generator=gen, device="cuda")
    return buf[off:].view(rows, ld)[:, :cols]


def _gram_bitwise(torch, label, got, again) -> None:
    """A symmetric Gram is bitwise equal to its transpose (broadcast
    differences: r2(i, j) and r2(j, i) are the same float sums), and a
    repeated call is bitwise equal."""
    sym = torch.equal(got, got.T)
    rep = torch.equal(got, again())
    print(f"{label}: K bitwise K^T {sym}, a repeated call bitwise {rep}",
          flush=True)
    check(sym, f"{label}: K is not bitwise symmetric")
    check(rep, f"{label}: a repeated call differs")


def _gram_edges(torch, gt, kern, gen) -> None:
    """The Gram kernel's edge paths against its plain version (1e-5 of
    max|K|): a ragged n (4100: 16-byte rows, but neither the 32-row nor the
    128-column tile divides it) and an odd one (4133: 4-byte stores
    throughout), bitwise symmetric; a cross block with an odd m (1000 x
    2001); D = 12 with its last quarter duplicating its first, where a
    White Gram must be exactly its variance at the duplicate pairs and on
    the diagonal (+ the nugget there) and exactly zero elsewhere, and SE +
    White within its float64 limits (_hold_gram)."""
    from gpx_torch.ops import cuda_gram

    x = torch.rand((4133, 2), generator=gen, device="cuda") * 20.0 - 10.0
    for n in (4100, 4133):
        xs = x[:n].contiguous()
        got = cuda_gram.gram_cuda(kern, xs, nugget=1e-3)
        want = cuda_gram.gram_reference(kern, xs, None, 1e-3)
        err = float((got - want).abs().max())
        print(f"gram n={n} d={x.shape[1]}: max abs err {err:.3e}", flush=True)
        check(err <= 1e-5 * float(want.abs().max()), f"gram n={n} disagrees")
        _gram_bitwise(torch, f"gram n={n}", got,
                      lambda: cuda_gram.gram_cuda(kern, xs, nugget=1e-3))
    x1, x2 = x[:1000], x[1000:3001]
    got = cuda_gram.gram_cuda(kern, x1, x2)
    want = cuda_gram.gram_reference(kern, x1, x2)
    err = float((got - want).abs().max())
    print(f"gram cross (1000, 2001) d={x.shape[1]}: max abs err {err:.3e}",
          flush=True)
    check(err <= 1e-5 * float(want.abs().max()), "cross gram m=2001 disagrees")
    check(torch.equal(got, cuda_gram.gram_cuda(kern, x1, x2)),
          "cross gram: a repeated call differs")

    n, q = 4096, 1024
    x12 = torch.randn((n, 12), generator=gen, device="cuda")
    x12[n - q:] = x12[:q]
    white = gt.white(0.5)
    got = cuda_gram.gram_cuda(white, x12, nugget=1e-3)
    idx = torch.arange(q, device="cuda")
    want = torch.zeros((n, n), device="cuda")
    want[idx, idx + n - q] = want[idx + n - q, idx] = 0.5
    want.diagonal().fill_(float(torch.tensor(0.5) + torch.tensor(1e-3)))
    exact = torch.equal(got, want)
    print(f"gram white d=12 n={n}, {q} duplicate pairs: exactly 0.5 at the "
          f"duplicates, 0.5 + nugget on the diagonal, 0 elsewhere: {exact}",
          flush=True)
    check(exact, "gram d=12: White does not fire exactly at the duplicates")
    _hold_gram(torch, gt, "se+white duplicates", kern, x12)
    _gram_bitwise(torch, "gram se+white d=12", cuda_gram.gram_cuda(
        kern, x12, nugget=1e-3), lambda: cuda_gram.gram_cuda(kern, x12, nugget=1e-3))


def _hold_trmm(torch, b, l, mode, neg=False, out=None, fast=False) -> float:
    """trmm against its plain version in float64 (_hold_ulps); with
    ``fast`` the 2-pass leg against the plain version that rounds the same
    operand to TF32."""
    from gpx_torch.ops import cuda_trmm

    got = cuda_trmm.trmm(b, l, mode=mode, neg=neg, fast=fast, out=out)
    check(out is None or got.data_ptr() == out.data_ptr(), "trmm: out ignored")
    b64, l64 = b.double(), l.double()
    want = cuda_trmm.trmm_reference(b64, l64, mode=mode, neg=neg, fast=fast)
    scale = cuda_trmm.trmm_reference(b64.abs(), l64.abs(), mode=mode)
    return _hold_ulps(torch, f"trmm {mode} b {tuple(b.shape)} ld {b.stride(0)} "
                      f"neg={neg}" + (" fast" if fast else ""), got, want,
                      scale, PRODUCT_ULPS)


def _hold_syrk(torch, a, b, out=None) -> float:
    """syrk_lower's lower triangle against its plain version in float64
    (_hold_ulps); the scale is |A0| + |B| |B|^T."""
    from gpx_torch.ops import cuda_trmm

    got = cuda_trmm.syrk_lower(a, b, out=out)
    a64, b64 = a.double(), b.double()
    want = cuda_trmm.syrk_lower_reference(a64, b64)
    scale = torch.tril(a64.abs() + b64.abs() @ b64.abs().T)
    return _hold_ulps(torch, f"syrk_lower b {tuple(b.shape)} ld {b.stride(0)}",
                      torch.tril(got), want, scale, PRODUCT_ULPS)


def _syrk_writes(torch, a, b) -> None:
    """syrk_lower writes i >= j only: an ``out`` of NaN keeps NaN above the
    diagonal; ``out=a`` (aliased) gives the unaliased result bitwise and
    leaves a's upper triangle as it was; a repeated call is bitwise equal."""
    from gpx_torch.ops import cuda_trmm

    n = a.shape[0]
    want = cuda_trmm.syrk_lower(a, b)
    check(torch.equal(want, cuda_trmm.syrk_lower(a, b)),
          "syrk_lower: a repeated call differs")
    upper = torch.ones((n, n), dtype=torch.bool, device="cuda").triu_(1)
    got = torch.full((n, n), float("nan"), device="cuda")
    cuda_trmm.syrk_lower(a, b, out=got)
    check(bool(torch.isnan(got[upper]).all()), "syrk_lower wrote above the diagonal")
    check(torch.equal(got[~upper], want[~upper]), "syrk_lower: out= differs")
    got = a.clone()
    cuda_trmm.syrk_lower(got, b, out=got)
    check(torch.equal(got[~upper], want[~upper]) and
          torch.equal(got[upper], a[upper]), "syrk_lower: out=a differs")
    print(f"syrk_lower n={n}: NaN above the diagonal kept, out=a bitwise the "
          f"unaliased result, repeated calls bitwise", flush=True)


def phase_setup():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = out.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    from gpx_torch._device import full_fp32
    from gpx_torch.ops import _build

    full_fp32()
    secs = _build.build_all(verbose=True)
    print(f"build: {secs:.1f} s ({len(_build.SOURCES)} sources, nvcc in "
          f"parallel)", flush=True)
    # every kernel instance free of spills (ptxas -v: "N bytes spill
    # stores, M bytes spill loads" per function)
    spills = [ln.strip() for log in _build.LOGS.values()
              for ln in log.splitlines() if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"ptxas: {sum(log.count('spill stores') for log in _build.LOGS.values())}"
          f" functions, spills: {spills}", flush=True)
    check(not spills, "a kernel instance spills registers")
    return card


def phase_kernels(torch, gt):
    """Each kernel against its plain version; returns the kernels' records."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad, cuda_trmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kern = gt.se(3.0, 5.5) + gt.white(0.5)
    records = {}

    def record(name, source, replaces, err, ms, plain_ms, bound, lib_ms):
        records[name] = _record(name, source, replaces, err, ms, plain_ms,
                                bound, lib_ms)
        print(f"  {name}: err {err:.3e}  kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  bound {bound[0]:.3f} ms ({bound[1]})  "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 3)} ms",
              flush=True)

    # -- 1. Gram: N = 16384, D = 1 (timed) and N = 4096, D = 2 ---------------
    # tolerance 1e-5 of max|K|: the same f32 r2 in both, expf against torch's
    # exp (a few ulps), and r2 / sigma^2 <= 13.3 scales an ulp of r2 by that
    for n, d in ((N_BENCH, 1), (4096, 2)):
        x = (torch.rand((n, d), generator=gen, device=dev) * 20.0 - 10.0)
        got = cuda_gram.gram_cuda(kern, x, nugget=1e-3)
        want = cuda_gram.gram_reference(kern, x, None, 1e-3)
        err = float((got - want).abs().max())
        print(f"gram n={n} d={d}: max abs err {err:.3e}", flush=True)
        check(err <= 1e-5 * float(want.abs().max()), "gram disagrees")
        del want
        _gram_bitwise(torch, f"gram n={n} d={d}", got,
                      lambda: cuda_gram.gram_cuda(kern, x, nugget=1e-3))
        if d == 1:
            ms = time_ms(torch, lambda: cuda_gram.gram_cuda(kern, x, nugget=1e-3))
            plain = time_ms(torch, lambda: cuda_gram.gram_reference(kern, x, None, 1e-3))
            fill = time_ms(torch, lambda: torch.empty((n, n), device=dev).fill_(1.0))
            bound = bound_ms(nbytes=4.0 * n * n + 4.0 * n * d)
            print(f"gram n={n} d=1: kernel {ms:.3f} ms, bound {bound[0]:.3f} ms "
                  f"({bound[1]}), the card's fill floor (torch.empty((n, n))"
                  f".fill_(1.0)) {fill:.3f} ms", flush=True)
            record("gram", "gpx_torch/csrc/gram.cu",
                   "gpx/ops/pallas_gram.py:89", err, ms, plain, bound, None)
        del got
    # a cross-covariance block (x2 given: no nugget, no forced diagonal)
    got = cuda_gram.gram_cuda(kern, x[:1000], x[1000:3000])
    want = cuda_gram.gram_reference(kern, x[:1000], x[1000:3000])
    err = float((got - want).abs().max())
    print(f"gram cross (1000, 2000) d=2: max abs err {err:.3e}", flush=True)
    check(err <= 1e-5 * float(want.abs().max()), "cross gram disagrees")
    _gram_edges(torch, gt, kern, gen)

    # -- 2./3. trmm (three modes, neg) and syrk_lower at 8192^2 and 5120-row
    # panels, ragged shapes on both tile sizes, views with an odd leading
    # dimension at an unaligned base; each output within PRODUCT_ULPS f32
    # ulps of its sum of |terms| against float64 (_hold_trmm, _hold_syrk)
    n = 8192
    l = torch.randn((n, n), generator=gen, device=dev).tril_() / math.sqrt(n)
    l.diagonal().add_(2.0)
    b = torch.randn((n, n), generator=gen, device=dev)
    trmm_err = 0.0
    for m_rows in (n, 5120):
        for mode, neg in (("right_lower", True), ("left_lower", False),
                          ("right_lower_t", False)):
            bb = b[:, :m_rows] if mode == "left_lower" else b[:m_rows]
            trmm_err = max(trmm_err, _hold_trmm(torch, bb, l, mode, neg))
    # ragged (no dimension a multiple of 128) and odd-ld views at unaligned
    # bases (the 4-byte copy path), each on 64-wide tiles (kn = 997) and on
    # 128-wide ones (kn = 4999: 1,600 tiles, past the 12-wave switch)
    for kn, mr in ((997, 500), (4999, 4997)):
        lr = l[:kn, :kn].contiguous()
        lv = _odd_view(torch, kn, kn, kn + 4, 1, gen)
        lv.copy_(lr)
        for mode in cuda_trmm.MODES:
            shape = (kn, mr) if mode == "left_lower" else (mr, kn)
            _hold_trmm(torch, b[:shape[0], :shape[1]].contiguous(), lr, mode)
            bv = _odd_view(torch, *shape, shape[1] + 3, 3, gen)
            _hold_trmm(torch, bv, lv, mode,
                       out=_odd_view(torch, *shape, shape[1] + 5, 1, gen))
    got = cuda_trmm.trmm(b, l, mode="right_lower")
    check(torch.equal(got, cuda_trmm.trmm(b, l, mode="right_lower")),
          "trmm: a repeated call differs")
    ms = time_ms(torch, lambda: cuda_trmm.trmm(b, l, mode="right_lower"))
    plain = time_ms(torch, lambda: cuda_trmm.trmm_reference(b, l, mode="right_lower"))
    lib = time_ms(torch, lambda: torch.matmul(b, l))
    print(f"trmm right_lower 8192^2: kernel {ms:.3f} ms, torch.matmul {lib:.3f} "
          f"ms; bounds 3xTF32 {bound_ms(tf32_flops=3.0 * n ** 3)[0]:.3f} ms, "
          f"FP32 {bound_ms(flops=float(n) ** 3)[0]:.3f} ms", flush=True)
    record("trmm", "gpx_torch/csrc/trmm.cu", "gpx/ops/pallas_trmm.py:127",
           trmm_err, ms, plain, bound_ms(tf32_flops=3.0 * n ** 3,
                                         nbytes=4.0 * (n * n * 2.5)), lib)

    a = b @ b.T / n
    a.diagonal().add_(1.0)
    syrk_err = max(_hold_syrk(torch, a, b[:, :k]) for k in (n, 5120))
    # ragged and unaligned as for trmm: 64-wide tiles at n = 333, 128-wide
    # at n = 7100 (1,596 lower-triangle tiles)
    for nr, kr in ((333, 129), (7100, 1001)):
        _hold_syrk(torch, a[:nr, :nr].contiguous(), b[:nr, :kr].contiguous())
        _hold_syrk(torch, _odd_view(torch, nr, nr, nr + 4, 3, gen),
                   _odd_view(torch, nr, kr, kr + 2, 1, gen),
                   out=_odd_view(torch, nr, nr, nr + 2, 1, gen))
    _syrk_writes(torch, a, b)
    ms = time_ms(torch, lambda: cuda_trmm.syrk_lower(a, b))
    plain = time_ms(torch, lambda: cuda_trmm.syrk_lower_reference(a, b))
    lib = time_ms(torch, lambda: torch.addmm(a, b, b.T, alpha=-1.0))
    print(f"syrk_lower 8192^2, k = 8192: kernel {ms:.3f} ms, torch.addmm "
          f"{lib:.3f} ms", flush=True)
    record("syrk_lower", "gpx_torch/csrc/trmm.cu", "gpx/ops/pallas_trmm.py:239",
           syrk_err, ms, plain, bound_ms(tf32_flops=3.0 * n ** 3,
                                         nbytes=4.0 * (n * n + n * n)), lib)
    del l, b, a, got

    # -- 4. the leaf at its size, at an offset, and chol_inv at N = 16384 ----
    # leaf tolerance 1e-4 of max|.|: a 128-step f32 factorization against
    # cuSOLVER's, both backward-stable; the Gram leaf has cond ~ 1e3
    x = torch.rand((N_BENCH, 1), generator=gen, device=dev) * 20.0 - 10.0
    kmat = cuda_gram.gram_cuda(kern, x, nugget=1e-3)
    t = cuda_chol.LEAF
    leaf = kmat[:t, :t].contiguous()
    gl, gm = cuda_chol.chol_inv_tile(leaf)
    wl, wm = cuda_chol.chol_inv_tile_reference(leaf)
    err = max(float((gl - wl).abs().max()), float((gm - wm).abs().max()))
    print(f"chol_inv_tile t={t}: max abs err {err:.3e} (L rel "
          f"{rel_max(gl, wl):.2e}, M rel {rel_max(gm, wm):.2e})", flush=True)
    check(rel_max(gl, wl) <= 1e-4 and rel_max(gm, wm) <= 1e-4,
          "chol_inv_tile disagrees")
    # printed only: the kernel and the plain f32 version against float64 on
    # the same f32 tile (the check above compares two f32 factors)
    dl, dm = cuda_chol.chol_inv_tile_reference(leaf.double())
    print(f"chol_inv_tile t={t} against float64: kernel L rel "
          f"{rel_max(gl, dl):.2e}, M rel {rel_max(gm, dm):.2e}; plain f32 L "
          f"rel {rel_max(wl, dl):.2e}, M rel {rel_max(wm, dm):.2e}", flush=True)
    # a leaf whose size is not a multiple of the 32-wide panel (the kernel
    # pads it with the identity): the same limits, exact zeros above both
    # diagonals
    tr = 100
    leaf_r = kmat[:tr, :tr].contiguous()
    gl, gm = cuda_chol.chol_inv_tile(leaf_r)
    wl, wm = cuda_chol.chol_inv_tile_reference(leaf_r)
    zero = not gl.triu(1).any() and not gm.triu(1).any()
    print(f"chol_inv_tile t={tr}: L rel {rel_max(gl, wl):.2e}, M rel "
          f"{rel_max(gm, wm):.2e}; exact zeros above the diagonal {zero}",
          flush=True)
    check(rel_max(gl, wl) <= 1e-4 and rel_max(gm, wm) <= 1e-4 and zero,
          f"chol_inv_tile t={tr} disagrees")
    # the kernel by graph replay (its launch through Python takes longer than
    # the kernel); the plain and library versions synchronise, by time_ms
    gl, gm = torch.empty_like(leaf), torch.empty_like(leaf)
    ms = graph_ms(torch, lambda: cuda_chol.chol_inv_tile(leaf, l_out=gl, m_out=gm))
    launch_ms = time_ms(torch, lambda: cuda_chol.chol_inv_tile(leaf), reps=20)
    plain = time_ms(torch, lambda: cuda_chol.chol_inv_tile_reference(leaf), reps=20)
    lib = time_ms(torch, lambda: torch.linalg.cholesky(leaf), reps=20)
    # the factor and its inverse, t^3 / 3 FLOPs each; a serial leaf has one
    # SM, so its bound on that SM's share of the FP32 peak is printed too
    leaf_bound = bound_ms(flops=2.0 * t ** 3 / 3.0, nbytes=4.0 * 2.5 * t * t)
    print(f"chol_inv_tile t={t}: kernel {ms:.4f} ms (graph replay; "
          f"{launch_ms:.4f} ms a call through Python); bound "
          f"{leaf_bound[0]:.6f} ms ({leaf_bound[1]}), on one SM "
          f"{1e3 * 2.0 * t ** 3 / 3.0 / (PEAK_FP32_FLOPS / 132):.4f} ms",
          flush=True)
    record("chol_inv_tile", "gpx_torch/csrc/chol_inv_tile.cu",
           "gpx/ops/pallas_chol.py:160", err, ms, plain, leaf_bound, lib)

    # the leaf read in place inside the 16384^2 Gram: the same limits
    # against its plain version, and bitwise the leaf on a contiguous copy
    off = N_BENCH // 2 + t
    blk = kmat[off:off + t, off:off + t]
    gl, gm = cuda_chol.chol_inv_tile_off(kmat, off, t)
    wl, wm = cuda_chol.chol_inv_tile_reference(blk)
    cl, cm = cuda_chol.chol_inv_tile(blk.contiguous())
    err = max(float((gl - wl).abs().max()), float((gm - wm).abs().max()))
    print(f"chol_inv_tile_off off={off} t={t}: max abs err {err:.3e} (L rel "
          f"{rel_max(gl, wl):.2e}, M rel {rel_max(gm, wm):.2e}); bitwise the "
          f"contiguous leaf: {torch.equal(gl, cl) and torch.equal(gm, cm)}",
          flush=True)
    check(rel_max(gl, wl) <= 1e-4 and rel_max(gm, wm) <= 1e-4,
          "chol_inv_tile_off disagrees")
    check(torch.equal(gl, cl) and torch.equal(gm, cm),
          "chol_inv_tile_off differs from the leaf on a copy of its block")
    ms = graph_ms(torch, lambda: cuda_chol.chol_inv_tile_off(
        kmat, off, t, l_out=gl, m_out=gm))
    plain = time_ms(torch, lambda: cuda_chol.chol_inv_tile_reference(blk), reps=20)
    lib = time_ms(torch, lambda: torch.linalg.cholesky(blk), reps=20)
    record("chol_inv_tile_off", "gpx_torch/csrc/chol_inv_tile.cu",
           "gpx/ops/pallas_chol.py:184", err, ms, plain, leaf_bound, lib)

    # chol_inv at N = 16384: its residuals (_chol_residuals), launches,
    # time, the spine factorization, the products by level, other bases
    factor_kernels = (cuda_chol.chol_inv_tile, cuda_chol.chol_inv_tile_off,
                      cuda_trmm.trmm, cuda_trmm.syrk_lower)
    for c in factor_kernels:
        c.launches = 0
    lf, mf = cuda_chol.chol_inv(kmat)
    launches = {c.__name__: c.launches for c in factor_kernels}
    fact, inv = _chol_residuals(torch, kmat, lf, mf)
    print(f"chol_inv n={N_BENCH}: ||LL^T-K||/||K|| {fact:.3e}  "
          f"||ML-I||/||I|| {inv:.3e}  launches {launches}", flush=True)
    check(fact <= 1e-5 and inv <= 1e-3, "chol_inv residuals too large")
    chol_ms = time_ms(torch, lambda: cuda_chol.chol_inv(kmat), reps=3)
    lib_chol = time_ms(torch, lambda: torch.linalg.cholesky(kmat), reps=3)
    leaf_share = launches["chol_inv_tile"] * records["chol_inv_tile"]["ms"] / chol_ms
    print(f"chol_inv n={N_BENCH}: {chol_ms:.2f} ms (leaves ~{100 * leaf_share:.0f}%"
          f" by {launches['chol_inv_tile']} x the lone-leaf time); "
          f"torch.linalg.cholesky (L only) {lib_chol:.2f} ms", flush=True)
    spine = _check_spine(torch, kmat, lf, mf, inv, gen)
    spine["chol_inv_ms"] = chol_ms
    spine["chol_inv_trmm_launches"] = launches["trmm"]
    levels = _chol_levels(torch, kmat, lf, mf, chol_ms)
    del lf
    _check_bases(torch, kern, x[:9000])

    # -- 5. logml_kernel_grads at N = 4096, at n = 4160 (= 64 mod 128: the
    # kernel's last 128-wide tile row is half outside n) and at the main
    # path's N = 16384, each against the plain version in float64 on the
    # same f32 inputs (_hold); a repeated call bitwise; timed at N = 16384
    nchk = 4096
    xs = x[:nchk].contiguous()
    _, ms_inv = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, xs, nugget=1e-3))
    alpha = torch.randn(nchk, generator=gen, device=dev) * 0.1
    err = _hold_grads(torch, gt, kern, xs, alpha, ms_inv)
    n_rag = 4160
    x_rag = x[:n_rag].contiguous()
    _, m_rag = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, x_rag, nugget=1e-3))
    a_rag = torch.randn(n_rag, generator=gen, device=dev) * 0.1
    err = max(err, _hold_grads(torch, gt, kern, x_rag, a_rag, m_rag))
    alpha16 = torch.randn(N_BENCH, generator=gen, device=dev) * 0.1
    m16 = mf
    err = max(err, _hold_grads(torch, gt, kern, x, alpha16, m16))
    first = _outputs(gt, cuda_logml_grad.logml_kernel_grads(kern, x, alpha16, m16))
    again = _outputs(gt, cuda_logml_grad.logml_kernel_grads(kern, x, alpha16, m16))
    print(f"logml_kernel_grads n={N_BENCH}: a repeated call bitwise "
          f"{first == again}", flush=True)
    check(first == again, "logml_kernel_grads: a repeated call differs")
    ms = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads(kern, x, alpha16, m16), reps=3)
    plain = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads_reference(
        kern, x, alpha16, m16), reps=3)
    # N^3 / 3 useful FLOPs: N^3 tensor-core FLOPs in 3xTF32
    grad_bound = bound_ms(tf32_flops=float(N_BENCH) ** 3,
                          nbytes=4.0 * N_BENCH * N_BENCH / 2)
    print(f"logml_kernel_grads n={N_BENCH}: kernel {ms:.3f} ms; bounds 3xTF32 "
          f"{grad_bound[0]:.3f} ms, FP32 "
          f"{bound_ms(flops=N_BENCH ** 3 / 3.0)[0]:.3f} ms", flush=True)
    record("logml_kernel_grads", "gpx_torch/csrc/logml_grad.cu",
           "gpx/ops/pallas_logml_grad.py:136", err, ms, plain, grad_bound, None)

    # -- 6. logml_probe_grads: against its plain version in float64 on the
    # same f32 inputs (_hold) at the main path's N = 16384 with s = 64 (the
    # plain estimate) and s = 128 (the augmented block's width), at n = 4096
    # with ragged s = 96 and 41 (s = 96 also against the plain TF32
    # version) and s = 1, at n = 4160 (= 64 mod 128: the last 128-wide tile
    # row half outside n); the bench case's two real blocks from
    # _hybrid_deflation (z_aug carries Q's columns: not +-1); a repeated
    # call bitwise; with identity probes against logml_kernel_grads at
    # n = 2048; timed at N = 16384, s = 64 and 128
    probe_ms, err = {}, 0.0
    for xp, m_inv, al, s in ((x, m16, alpha16, 64), (x, m16, alpha16, 128),
                             (xs, ms_inv, alpha, 96), (xs, ms_inv, alpha, 41),
                             (xs, ms_inv, alpha, 1), (x_rag, m_rag, a_rag, 64)):
        z = _rademacher(torch, (xp.shape[0], s), gen)
        u = m_inv.T @ (m_inv @ z)  # K^-1 z through the factor
        err = max(err, _hold_probe(torch, gt, kern, xp, al, u, z, tf32=s == 96))
        if xp.shape[0] == N_BENCH:
            probe_ms[s] = (
                time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads(
                    kern, xp, al, u, z), reps=5),
                time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads_reference(
                    kern, xp, al, u, z), reps=3),
                _probe_bound(N_BENCH, s))
            print(f"logml_probe_grads n={N_BENCH} s={s}: kernel "
                  f"{probe_ms[s][0]:.3f} ms  plain {probe_ms[s][1]:.3f} ms  "
                  f"bound {probe_ms[s][2][0]:.3f} ms ({probe_ms[s][2][1]}; "
                  f"3xTF32, the SFU's exps, bytes); the SIMT kernel's FP32 formula "
                  f"{_probe_bound_fp32(N_BENCH, s)[0]:.3f} ms", flush=True)
            if s == 64:
                first = _outputs(gt, cuda_logml_grad.logml_probe_grads(
                    kern, xp, al, u, z))
                again = _outputs(gt, cuda_logml_grad.logml_probe_grads(
                    kern, xp, al, u, z))
                print(f"logml_probe_grads n={N_BENCH} s=64: a repeated call "
                      f"bitwise {first == again}", flush=True)
                check(first == again, "logml_probe_grads: a repeated call differs")
    del ms_inv, m16, mf, m_rag
    err = max(err, _probe_hybrid_blocks(torch, gt))
    _probe_identity(torch, gt, kern, x[:2048].contiguous(), gen)
    ms, plain, bound = probe_ms[64]
    record("logml_probe_grads", "gpx_torch/csrc/logml_probe_grad.cu",
           "gpx/ops/pallas_logml_grad.py:334", err, ms, plain, bound, None)
    del kmat
    torch.cuda.empty_cache()
    return records, {"chol_inv_ms": chol_ms, "cholesky_lib_ms": lib_chol,
                     "chol_inv_launches": launches, "leaf_share": leaf_share,
                     "chol_inv_levels": levels, "spine": spine,
                     "probe_ms": {s: v[0] for s, v in probe_ms.items()}}


# -- phase 2b: the other kernel families on the term table -----------------

# Gram entries against float64, in f32 ulps of each entry's scale |K| + 2 r2
# |dK/dr2| (|dK/dr2| the sum of its terms' magnitudes): the f32 r2 carries
# ~1.5 ulps and the family's argument (s = c d / l, d / period, z) a few
# more, which the function's own slope scales, and the evaluation (expf,
# log1pf, sinpif, the Matern recurrence's p steps) a few ulps of |K|
FAMILY_ULPS = 16.0
# special-function-unit operations per Gram entry (one sqrtf for Matern and
# Periodic; expf, and log1pf for RQ; sinpif / cospif are FMA polynomials)
SFU_PER_ENTRY = {"se+white": 1, "matern12+white": 2, "matern32+white": 2,
                 "matern52+white": 2, "matern72+white": 2, "rq+white": 2,
                 "periodic+white": 2, "se*periodic+white": 3,
                 "(se+matern32)*periodic+white": 4}
ELL3 = [0.7, 2.3, 1.4]
F3 = "(se+matern32)*periodic+white"


def _f3(gt, dtype=None):
    """F3, a Product of a Sum: (SE(2, 3) + Matern(1, 3/2, 2)) * Periodic(1,
    2.5, 1.5) + White(0.1), on the card. The term table expands it to SE
    Per + M3/2 Per + White: 5 rows in 3 products, Periodic's three
    hyperparameters in two of them."""
    kw = {"device": "cuda", "dtype": dtype}
    return ((gt.se(2.0, 3.0, **kw) + gt.matern(1.0, 1.5, 2.0, **kw))
            * gt.periodic(1.0, 2.5, 1.5, **kw) + gt.white(0.1, **kw))


def _past_table(gt, dtype=None):
    """A Product of Sums past the term table: 8 products of 3 factors, 24
    rows against the table's 8."""
    kw = {"device": "cuda", "dtype": dtype}
    return ((gt.se(2.0, 3.0, **kw) + gt.matern(1.0, 1.5, 2.0, **kw))
            * (gt.periodic(1.0, 2.5, 1.5, **kw)
               + gt.rational_quadratic(1.0, 0.7, 2.0, **kw))
            * (gt.se(1.0, 4.0, **kw) + gt.white(0.1, **kw)))


def _families(gt, dtype=None):
    """The kernels phase 2b holds: each family plus White, one product and
    F3, a Product of a Sum (name -> kernel on the card); SE + White, the
    bench's, first."""
    kw = {"device": "cuda", "dtype": dtype}
    return {
        "se+white": gt.se(3.0, 5.5, **kw) + gt.white(0.5, **kw),
        "matern12+white": gt.matern(1.0, 0.5, 2.0, **kw) + gt.white(0.25, **kw),
        "matern32+white": gt.matern(1.0, 1.5, 2.0, **kw) + gt.white(0.25, **kw),
        "matern52+white": gt.matern(1.0, 2.5, 2.0, **kw) + gt.white(0.25, **kw),
        "matern72+white": gt.matern(1.0, 3.5, 2.0, **kw) + gt.white(0.25, **kw),
        "rq+white": gt.rational_quadratic(1.0, 0.7, 2.0, **kw)
        + gt.white(0.25, **kw),
        "periodic+white": gt.periodic(1.0, 3.1, 1.4, **kw) + gt.white(0.25, **kw),
        "se*periodic+white": gt.se(2.0, 3.0, **kw) * gt.periodic(1.0, 2.5, 4.0, **kw)
        + gt.white(0.25, **kw),
        F3: _f3(gt, dtype),
    }


def _hold_gram(torch, gt, label, kern, x, nugget=1e-3, x2=None,
               ulps=FAMILY_ULPS) -> float:
    """The Gram kernel against its plain version in float64 on the same f32
    x (and x2 for a cross Gram), within ``ulps`` (FAMILY_ULPS) of each
    entry's scale; returns the largest absolute error."""
    from gpx_torch.ops import cuda_gram
    from gpx_torch.ops.distance import sq_distances
    from gpx_torch.ops.terms import term_dr2

    got = cuda_gram.gram_cuda(kern, x, x2, nugget=nugget)
    k64, x64 = _f64_kernel(gt, kern), x.double()
    x2_64 = None if x2 is None else x2.double()
    want = cuda_gram.gram_reference(k64, x64, x2_64, nugget)
    r2 = sq_distances(x64, x2_64)
    # the smallest normal f32 as a floor: f32 entries below it underflow
    scale = (want.abs() + 2.0 * r2 * term_dr2(k64, r2, absolute=True)
             + 2.0 ** -126)
    del r2
    shape = (f"n={x.shape[0]}" if x2 is None
             else f"{x.shape[0]} x {x2.shape[0]}")
    return _hold_ulps(torch, f"gram {label} {shape} d={x.shape[1]}", got,
                      want, scale, ulps)


def phase_families(torch, gt):
    """Phase 2b: the Gram and both gradient kernels on every family of the
    term table against float64 (_hold_gram at n = 4096, D = 1 and 3;
    logml_kernel_grads at n = 4096 and 4160 and the ARD leg at D = 3;
    logml_probe_grads with ARD), and each family's Gram and gradient time at
    N = 16,384 beside SE + White's; the ARD leg's cost at D = 3 and 16."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand((N_BENCH, 1), generator=gen, device=dev) * 20.0 - 10.0
    x3 = torch.rand((4096, 3), generator=gen, device=dev) * 20.0 - 10.0
    u3 = x3 / torch.tensor(ELL3, device=dev)
    _, m16 = cuda_chol.chol_inv(cuda_gram.gram_cuda(
        _families(gt)["se+white"], x, nugget=1e-3))
    alpha16 = torch.randn(N_BENCH, generator=gen, device=dev) * 0.1
    z16 = _rademacher(torch, (N_BENCH, 64), gen)
    out = {}
    for name, kern in _families(gt).items():
        if name != "se+white":
            _hold_gram(torch, gt, name, kern, x[:4096])
            _hold_gram(torch, gt, name, kern, u3)
            for n in (4096, 4160):
                xs = x[:n].contiguous()
                _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, xs, nugget=1e-3))
                alpha = torch.randn(n, generator=gen, device=dev) * 0.1
                _hold_grads(torch, gt, kern, xs, alpha, m, label=f"{name} ",
                            witness=True)
            del m
        # the ARD leg at D = 3 (Periodic of a 3-D distance is not positive
        # definite: its Gram does not factor)
        if name != "se+white" and "periodic" not in name:
            _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, u3, nugget=1e-3))
            alpha = torch.randn(4096, generator=gen, device=dev) * 0.1
            _hold_grads(torch, gt, kern, u3, alpha, m, ard=True, label=f"{name} ",
                        witness=True)
            if name == "matern52+white":
                z = _rademacher(torch, (4096, 64), gen)
                u = m.T @ (m @ z)
                _hold_probe(torch, gt, kern, u3, alpha, u, z, ard=True,
                            label=f"{name} ", witness=True)
            del m
        gram = time_ms(torch, lambda: cuda_gram.gram_cuda(kern, x, nugget=1e-3))
        grad = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads(
            kern, x, alpha16, m16), reps=3)
        probe = time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads(
            kern, x, alpha16, z16, z16), reps=5)
        gram_bound = bound_ms(nbytes=4.0 * N_BENCH * N_BENCH,
                              exps=float(SFU_PER_ENTRY[name]) * N_BENCH ** 2)
        out[name] = {"gram_ms": gram, "gram_bound_ms": gram_bound[0],
                     "gram_bound_by": gram_bound[1], "grad_ms": grad,
                     "probe_s64_ms": probe}
        print(f"family {name} n={N_BENCH}: gram {gram:.3f} ms (bound "
              f"{gram_bound[0]:.3f} ms, {gram_bound[1]}); logml_kernel_grads "
              f"{grad:.3f} ms; logml_probe_grads s=64 {probe:.3f} ms", flush=True)
    _f3_ard(torch, gt, x, u3, gen)
    # the ARD leg's cost: D more block sums per 64^2 tile
    kern = _families(gt)["matern52+white"]
    for d in (3, 16):
        xd = torch.rand((N_BENCH, d), generator=gen, device=dev)
        plain = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads(
            kern, xd, alpha16, m16), reps=3)
        ard = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads(
            kern, xd, alpha16, m16, ard=True), reps=3)
        z = _rademacher(torch, (N_BENCH, 64), gen)
        probe = time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads(
            kern, xd, alpha16, z, z), reps=5)
        probe_ard = time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads(
            kern, xd, alpha16, z, z, ard=True), reps=5)
        out[f"ard_d{d}"] = {"ms": ard, "without_ard_ms": plain,
                            "probe_ms": probe_ard, "probe_without_ard_ms": probe}
        print(f"logml_kernel_grads matern52+white n={N_BENCH} d={d}: ard "
              f"{ard:.3f} ms, without ard {plain:.3f} ms; logml_probe_grads "
              f"s=64: ard {probe_ard:.3f} ms, without ard {probe:.3f} ms",
              flush=True)
    del m16
    torch.cuda.empty_cache()
    return out


def _f3_ard(torch, gt, x, u3, gen) -> None:
    """F3's probe kernel at s = 64 (n = 4096, D = 1, its own factor) and
    Ard(F3)'s ARD leg in both gradient kernels at D = 3, each under _hold
    with the float32 plain version as a second limit. Periodic of a 3-D
    distance is not positive definite, so the ARD checks take L^-1 from
    Matern 5/2 + White's Gram on the same scaled coordinates: the kernels
    contract any W, and the check holds them to their plain version on
    the same inputs. Periodic's gradients, from two products of the
    expansion, are among the outputs held."""
    from gpx_torch.ops import cuda_chol, cuda_gram

    f3 = _f3(gt)
    xs = x[:4096].contiguous()
    _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(f3, xs, nugget=1e-3))
    alpha = torch.randn(4096, generator=gen, device="cuda") * 0.1
    z = _rademacher(torch, (4096, 64), gen)
    _hold_probe(torch, gt, f3, xs, alpha, m.T @ (m @ z), z, label=f"{F3} ",
                witness=True)
    _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(
        _families(gt)["matern52+white"], u3, nugget=1e-3))
    _hold_grads(torch, gt, f3, u3, alpha, m, ard=True, label=f"ard({F3}) ",
                witness=True)
    _hold_probe(torch, gt, f3, u3, alpha, m.T @ (m @ z), z, ard=True,
                label=f"ard({F3}) ", witness=True)


def _chol_residuals(torch, k, l, m):
    """||L L^T - K|| / ||K|| and ||M L - I|| / ||I|| (Frobenius), formed in
    float64: an f32 product would add its own rounding of the same size.
    chol_inv's limits are 1e-5 (a few f32 ulps for the factor's backward
    error) and 1e-3 (eps * cond(L) for the inverse, cond(K) ~ 5e4)."""
    l64, k64 = l.double(), k.double()
    fact = float(torch.linalg.matrix_norm(l64 @ l64.T - k64)
                 / torch.linalg.matrix_norm(k64))
    del k64
    res = m.double() @ l64
    res.diagonal().sub_(1.0)
    return fact, float(torch.linalg.matrix_norm(res) / math.sqrt(k.shape[0]))


def _chol_levels(torch, kmat, lf, mf, chol_ms):
    """Stand-alone times of chol_inv's products at N = 16384, level by
    level: at split h the recursion makes N / (2 h) calls each of trmm
    right_lower_t, syrk_lower, trmm right_lower (neg) and trmm left_lower
    on (h, h) blocks (here the leading blocks of K and its factor). Returns
    {h: ms of the level}; the rest of chol_inv is the leaves, the L21
    copies and the gaps between launches."""
    from gpx_torch.ops import cuda_chol, cuda_trmm

    n, levels = kmat.shape[0], {}
    h = n // 2
    while h >= cuda_chol.LEAF:
        s1, s2 = slice(0, h), slice(h, 2 * h)
        ws = torch.empty((h, h), device="cuda")

        def products():
            cuda_trmm.trmm(kmat[s2, s1], mf[s1, s1], mode="right_lower_t", out=ws)
            cuda_trmm.syrk_lower(kmat[s2, s2], lf[s2, s1], out=ws)
            t1 = cuda_trmm.trmm(lf[s2, s1], mf[s1, s1], mode="right_lower", neg=True)
            cuda_trmm.trmm(t1, mf[s2, s2], mode="left_lower", out=ws)

        levels[h] = n // (2 * h) * time_ms(torch, products, reps=3 if h > 1024 else 10)
        h //= 2
    total = sum(levels.values())
    print(f"chol_inv n={n} products by split h (ms, stand-alone x calls): "
          f"{ {h: round(t, 3) for h, t in levels.items()} }; sum {total:.2f} of "
          f"{chol_ms:.2f} ms, the rest (leaves, copies, gaps) "
          f"{chol_ms - total:.2f} ms", flush=True)
    return levels


def _check_bases(torch, kern, x):
    """chol_inv at base = 64 and 128 on the n = 9000 Gram padded to 9088 as
    the fused route pads it (gp._pad_spd): exact zeros above the diagonal
    of L and M, and the residuals within chol_inv's limits."""
    from gpx_torch.models import gp
    from gpx_torch.ops import cuda_chol, cuda_gram

    k = gp._pad_spd(cuda_gram.gram_cuda(kern, x, nugget=1e-3), 9088 - x.shape[0])
    for base in (64, 128):
        l, m = cuda_chol.chol_inv(k, base=base)
        fact, inv = _chol_residuals(torch, k, l, m)
        zero = not l.triu(1).any() and not m.triu(1).any()
        print(f"chol_inv n=9000 padded to {k.shape[0]}, base={base}: exact "
              f"zeros above the diagonal {zero}; ||LL^T-K||/||K|| {fact:.3e}  "
              f"||ML-I||/||I|| {inv:.3e}", flush=True)
        check(zero, f"chol_inv base={base}: nonzero above the diagonal")
        check(fact <= 1e-5 and inv <= 1e-3,
              f"chol_inv base={base}: residuals too large")


def _rademacher(torch, shape, gen):
    return (torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1).float()


def _spine_skipped(n: int, base: int):
    """The M21 blocks that chol_inv(spine=True) skips: the trailing spine."""
    from gpx_torch.ops.cuda_chol import _split

    out, off, t = [], 0, n
    while t > base:
        h = _split(t)
        out.append((slice(off + h, off + t), slice(off, off + h)))
        off, t = off + h, t - h
    return out


def _check_spine(torch, kmat, lf, mf, inv, gen):
    """chol_inv(spine=True) at N = 16384: L bitwise that of spine=False,
    the skipped blocks zero and every other M block bitwise equal; the
    spine solves' backward errors; its time and trmm launches."""
    from gpx_torch.ops import cuda_chol, cuda_trmm

    cuda_trmm.trmm.launches = 0
    ls, msp = cuda_chol.chol_inv(kmat, spine=True)
    trmm_launches = cuda_trmm.trmm.launches
    check(torch.equal(ls, lf), "spine: L differs from spine=False's")
    skipped = _spine_skipped(kmat.shape[0], cuda_chol.LEAF)
    differ = msp != mf
    for rows, cols in skipped:
        check(not msp[rows, cols].any(), "spine: a skipped block is not zero")
        differ[rows, cols] = False
    check(not differ.any(), "spine: an M block outside the spine differs")
    del differ
    # the normwise backward error ||L u - b|| / (||L|| ||u|| + ||b||)
    # (Frobenius, formed in float64) of each spine solve for a 64-column b;
    # a backward-stable f32 solve keeps it within a few f32 ulps: allow 4.
    # torch.linalg.solve_triangular on the same L is printed beside it
    eps = torch.finfo(torch.float32).eps
    b = torch.randn((kmat.shape[0], 64), generator=gen, device="cuda")
    l64, b64 = ls.double(), b.double()
    ln, bn = float(torch.linalg.matrix_norm(l64)), float(torch.linalg.matrix_norm(b64))

    def backward_error(lmat, u):
        u64 = u.double()
        r = float(torch.linalg.matrix_norm(lmat @ u64 - b64))
        return r / (ln * float(torch.linalg.matrix_norm(u64)) + bn)

    res = {
        "lower": backward_error(l64, cuda_chol.spine_solve_lower(ls, msp, b)),
        "lower_t": backward_error(l64.T, cuda_chol.spine_solve_lower_t(ls, msp, b)),
        "trsm_lower": backward_error(l64, torch.linalg.solve_triangular(
            ls, b, upper=False)),
        "trsm_lower_t": backward_error(l64.T, torch.linalg.solve_triangular(
            ls.T, b, upper=True)),
    }
    del l64
    print(f"spine n={kmat.shape[0]}: L bitwise, {len(skipped)} skipped blocks "
          f"zero, the rest of M bitwise; backward errors in f32 ulps "
          f"{ {k: round(v / eps, 4) for k, v in res.items()} } (limit 4; the "
          f"factor's ||ML-I||/||I|| is {inv:.3e})", flush=True)
    check(res["lower"] <= 4 * eps and res["lower_t"] <= 4 * eps,
          "spine solves: backward error above 4 f32 ulps")
    ms = time_ms(torch, lambda: cuda_chol.chol_inv(kmat, spine=True), reps=3)
    print(f"chol_inv spine=True: {ms:.2f} ms, {trmm_launches} trmm launches",
          flush=True)
    return {"ms": ms, "trmm_launches": trmm_launches, "residuals": res}


def _hold(label, got, want, scales, names, witness=None) -> float:
    """Each output p of a gradient kernel against its plain version in
    float64 on the same f32 inputs; returns the largest absolute error.

    Each output is a sum of terms whose magnitudes add up to scale_p
    (_term_scales), and must meet two limits:
    - 4 f32 ulps of scale_p: the kernel's rounding (f32 K^-1 tile dots,
      then the tile sums) adds with random signs over the n^2 entries;
      with a ``witness`` (the plain version's own outputs in float32 on
      the same inputs), twice its error where that is larger: a family's
      f32 argument can be ill-conditioned (Periodic's d / period up to 6.5
      here puts ~20 ulps into sin), and no f32 kernel can do better;
    - 1e-2 of the output's own value, so that a dropped, mis-signed or
      mis-scaled derivative term fails even where a cancellation makes
      scale_p large (h at n = 4096: value 1.7, scale 2.7e4).
    """
    eps = 1.1920928955078125e-07  # float32
    err = 0.0
    witness = [None] * len(got) if witness is None else witness
    for g, w, s, nm, f in zip(got, want, scales, names, witness):
        ulps = 4.0 * eps * s
        if f is not None:
            ulps = max(ulps, 2.0 * abs(f - w))
        e, limit = abs(g - w), min(ulps, 1e-2 * abs(w))
        print(f"{label} {nm}: kernel {g:.6e} reference {w:.6e} err {e:.3e} "
              f"limit {limit:.3e} scale {s:.3e}"
              + ("" if f is None else f" plain-f32 err {abs(f - w):.3e}"),
              flush=True)
        check(e <= limit, f"{label} {nm} disagrees")
        err = max(err, e)
    return err


def _outputs(gt, out):
    """The flat outputs of a gradient kernel: the hyperparameters, the two
    traces, and with ARD the sums sdot."""
    d_kernel, traces, *sdot = out
    return [float(t) for t in (*gt.params.leaves(d_kernel), *traces,
                               *(sdot[0] if sdot else ()))]


def _names(gt, kern, d=0):
    return [*gt.params.names(kern), "tkw", "trw",
            *(f"sdot{e}" for e in range(d))]


def _f64_kernel(gt, kern):
    """The same kernel with its hyperparameters in float64."""
    return gt.params.unflatten(kern, [t.double() for t in gt.params.leaves(kern)])


def _hold_grads(torch, gt, kern, x, alpha, l_inv, ard=False, label="",
                witness=False, fast=False) -> float:
    """logml_kernel_grads against its plain version (_hold); with ``ard``,
    ``x`` holds the scaled coordinates and the sums sdot are held too;
    ``witness``: _hold's float32 plain version as a second limit; ``fast``:
    the 2-pass leg against the plain version that rounds the same operand
    to TF32."""
    from gpx_torch.ops import cuda_logml_grad

    got = _outputs(gt, cuda_logml_grad.logml_kernel_grads(
        kern, x, alpha, l_inv, ard=ard, fast=fast))
    args = (_f64_kernel(gt, kern), x.double(), alpha.double())
    l64 = l_inv.double()
    want = _outputs(gt, cuda_logml_grad.logml_kernel_grads_reference(
        *args, l64, ard=ard, fast=fast))
    f32 = (_outputs(gt, cuda_logml_grad.logml_kernel_grads_reference(
        kern, x, alpha, l_inv, ard=ard, fast=fast)) if witness else None)
    scales = _term_scales(torch, *args, l64.T @ l64, ard=ard)
    return _hold(f"logml_kernel_grads {label}n={x.shape[0]}"
                 + (f" ard d={x.shape[1]}" if ard else "")
                 + (" fast" if fast else ""), got, want, scales,
                 _names(gt, kern, x.shape[1] if ard else 0), f32)


def _hold_probe(torch, gt, kern, x, alpha, u, z, ard=False, label="",
                witness=False, tf32=False) -> float:
    """logml_probe_grads against its plain version (_hold); ``tf32``: also
    against the plain version of its 3xTF32 product (probe_what_tf32x3,
    contracted in float64) within the same limits."""
    from gpx_torch.ops import cuda_logml_grad

    got = _outputs(gt, cuda_logml_grad.logml_probe_grads(kern, x, alpha, u, z,
                                                         ard=ard))
    args = (_f64_kernel(gt, kern), x.double(), alpha.double())
    u64, z64 = u.double(), z.double()
    want = _outputs(gt, cuda_logml_grad.logml_probe_grads_reference(
        *args, u64, z64, ard=ard))
    f32 = (_outputs(gt, cuda_logml_grad.logml_probe_grads_reference(
        kern, x, alpha, u, z, ard=ard)) if witness else None)
    what = (u64 @ z64.T + z64 @ u64.T) * (0.5 / z.shape[1])
    scales = _term_scales(torch, *args, what, ard=ard)
    label = (f"logml_probe_grads {label}n={x.shape[0]} s={z.shape[1]}"
             + (f" ard d={x.shape[1]}" if ard else ""))
    names = _names(gt, kern, x.shape[1] if ard else 0)
    err = _hold(label, got, want, scales, names, f32)
    if tf32:
        split = _outputs(gt, cuda_logml_grad.logml_probe_grads_tf32x3(
            *args, u, z, ard=ard))
        _hold(label + " vs the plain 3xTF32 version", got, split, scales, names)
    return err


def _probe_hybrid_blocks(torch, gt) -> float:
    """The probe kernel on the two blocks one hybrid eval gives it at the
    bench case (_hybrid_probe_inputs: s = 64 Rademacher, and the augmented
    s = 128 block whose z carries Q's columns) against its plain version
    in float64 within _hold's limits, the float32 plain version's error
    printed beside. The estimate's noise puts h's sum of |terms| ~1e8
    times its value there, so h's 1e-2 relative limit is the one that
    binds: it holds the kernel's own float32 arithmetic (its gradient
    sums are in double for that). Returns the largest absolute error."""
    from gpx_torch.models import gp

    params, x, y = _bench_case_cuda(torch, gt)
    alpha, (u, z), (u_aug, z_aug) = _hybrid_probe_inputs(
        torch, gt, gp, params.kernel, x, y)
    off = float(((z_aug.abs() - 1.0).abs() > 0).float().mean())
    print(f"hybrid augmented block: s = {z_aug.shape[1]}, {100 * off:.1f}% of "
          f"z's entries not +-1", flush=True)
    check(off > 0.25, "the augmented block's z is +-1")
    err = _hold_probe(torch, gt, params.kernel, x, alpha, u, z,
                      label="hybrid block ", witness=True)
    return max(err, _hold_probe(torch, gt, params.kernel, x, alpha, u_aug,
                                z_aug, label="hybrid augmented block ",
                                witness=True))


def _probe_identity(torch, gt, kern, x, gen) -> None:
    """With z = sqrt(n) I and u = K^-1 z the probe estimate is exact: the
    probe kernel must meet logml_kernel_grads on the same L^-1 within
    _hold's limits."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad

    n = x.shape[0]
    _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, x, nugget=1e-3))
    alpha = torch.randn(n, generator=gen, device="cuda") * 0.1
    m64 = m.double()
    kinv = m64.T @ m64
    z = math.sqrt(n) * torch.eye(n, device="cuda")
    u = (kinv * math.sqrt(n)).float()
    got = _outputs(gt, cuda_logml_grad.logml_probe_grads(kern, x, alpha, u, z))
    want = _outputs(gt, cuda_logml_grad.logml_kernel_grads(kern, x, alpha, m))
    scales = _term_scales(torch, _f64_kernel(gt, kern), x.double(),
                          alpha.double(), kinv)
    _hold(f"logml_probe_grads n={n} s={n} identity probes vs logml_kernel_grads",
          got, want, scales, _names(gt, kern))


def _term_scales(torch, kernel, x, alpha, kinv, ard=False):
    """sum |W_ij dk_ij/dtheta_p| per hyperparameter, with W = 0.5 (alpha
    alpha^T - kinv), the sums of |terms| of the two traces, and with ARD
    sum |W_ij| |K'_ij| (x_ie - x_je)^2 per dimension (|K'| the sum of its
    terms' magnitudes), in float64."""
    from gpx_torch.ops.distance import sq_distances
    from gpx_torch.ops.terms import term_derivatives, term_dr2

    w = 0.5 * (torch.outer(alpha, alpha) - kinv)
    r2 = sq_distances(x)
    out = [float(torch.sum((w * dk).abs())) for dk in term_derivatives(kernel, r2)]
    out.append(float(torch.sum((kinv * kernel.evaluate_r2(r2)).abs())))
    out.append(float(torch.sum(torch.diagonal(kinv).abs())))
    if ard:
        wk = w.abs() * term_dr2(kernel, r2, absolute=True)
        out += [float(torch.sum(wk * (x[:, e, None] - x[None, :, e]) ** 2))
                for e in range(x.shape[1])]
    return out


def phase_bench(torch, gt, records):
    """The bench case end to end, against float64; returns the summary."""
    from gpx_torch.models import gp

    params, x_np, y_np = _bench_case(gt)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    value, grads = gp.logml_value_and_grad(params, x_np, y_np)
    torch.cuda.synchronize()
    for name, c in counters.items():
        if name == "logml_probe_grads":
            check(c.launches == 0, "the exact path launched the probe kernel")
            continue
        records[name]["launches"] = c.launches
        check(c.launches > 0, f"{name} was not launched on the main path")
    print("main path launches: "
          + json.dumps({k: c.launches for k, c in counters.items()}), flush=True)

    v_rel, rel, h_abs = _against_f64(torch, gt, gp, x, y, value, grads,
                                     "bench")
    _value_terms(torch, gt, gp, params.kernel, x, y)
    # the noise floor on the fused route: the 3-pass gradient (bitwise the
    # call above) against the 2-pass one
    g3, floor, flagged = gp.logml_gradient_noise_floor(params, x, y)
    check(all(torch.equal(a, b) for a, b in zip(gt.params.leaves(g3),
                                                gt.params.leaves(grads)))
          and all(bool(torch.isfinite(f).all())
                  for f in gt.params.leaves(floor)),
          "noise floor: not the exact gradient, or not finite")
    print("bench gradient noise floor (h, sigma, white): "
          f"{[float(f) for f in gt.params.leaves(floor.kernel)]}, flagged "
          f"{[bool(f) for f in gt.params.leaves(flagged.kernel)]}", flush=True)
    # off the tile grid: n = 9000 pads to 9088 (uneven Schur splits)
    n_off = 9000
    counters["logml_kernel_grads"].launches = 0
    value, grads = gp.logml_value_and_grad(params, x[:n_off], y[:n_off])
    check(counters["logml_kernel_grads"].launches == 1, "n=9000 is not fused")
    _against_f64(torch, gt, gp, x[:n_off], y[:n_off], value, grads, "n=9000")
    # autodiff on the card: the Gram kernel's backward is the plain VJP
    value, grads = gp.logml_value_and_grad(params, x[:1024], y[:1024],
                                           method="autodiff")
    v64, g64 = _f64(torch, gt, gp, x[:1024], y[:1024])
    ad_rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in
              zip((value, *gt.params.leaves(grads)), (v64, *gt.params.leaves(g64)))]
    print(f"autodiff n=1024 f32 against f64: rel (value, h, sigma, white) "
          f"{ad_rel}", flush=True)
    # f32 Cholesky of a cond ~ 1e4 Gram without the logdet correction
    check(ad_rel[0] <= 1e-3 and ad_rel[3] <= 1e-3, "autodiff disagrees")

    eval_ms, ms = _median_ms(torch, lambda: gp.logml_value_and_grad(params, x, y))
    print(f"bench ms/eval (median of 5, CUDA events): {eval_ms:.2f} {ms}",
          flush=True)

    # fused against non-fused route by n: these set gp.FUSED_MIN_N
    crossover = {}
    keep = gp.FUSED_MIN_N
    for n in (1024, 2048, 4096, 5120, 6144, 8192, N_BENCH):
        xs, ys = x[:n].contiguous(), y[:n].contiguous()
        row = {}
        for route, threshold in (("fused", 0), ("nonfused", n + 1)):
            gp.FUSED_MIN_N = threshold
            row[route] = time_ms(torch, lambda: gp.logml_value_and_grad(params, xs, ys),
                                 reps=5)
        gp.FUSED_MIN_N = keep
        crossover[n] = row
        print(f"route n={n}: fused {row['fused']:.3f} ms  non-fused "
              f"{row['nonfused']:.3f} ms", flush=True)
    return {"ms_per_eval": eval_ms, "value_rel": v_rel, "grad_rel": rel,
            "h_abs": h_abs, "routes": crossover}


def _leaf_kinds(gt, kern):
    """"white" or "other" per scalar hyperparameter, in leaves order."""
    if isinstance(kern, (gt.Sum, gt.Product)):
        return [k for t in kern.kernels for k in _leaf_kinds(gt, t)]
    if isinstance(kern, gt.Ard):
        return _leaf_kinds(gt, kern.base) + ["other"] * kern.ell.numel()
    kind = "white" if isinstance(kern, gt.White) else "other"
    return [kind] * sum(t.numel() for t in gt.params.leaves(kern))


def _flat_result(gt, value, grads):
    return [float(value)] + [float(v) for t in gt.params.leaves(grads.kernel)
                             for v in t.reshape(-1)]


def _f64_result(torch, gt, gp, params, x, y):
    """The oracle: the non-fused route (torch.linalg) in float64 on the card."""
    p64 = gt.Parameters(mean=gt.zero(), kernel=_f64_kernel(gt, params.kernel))
    return _flat_result(gt, *gp.logml_value_and_grad(p64, x.double(), y.double()))


def _exact_family(torch, gt, gp, label, params, x, y):
    """A family's exact path at N = 16,384 through gp.logml_value_and_grad:
    the fused route by its launch counts (1 Gram, 128 leaves, 1 gradient),
    each output against float64 (the non-fused route on the card), beside
    the float32 torch.linalg route's error (the route such a kernel took
    before it had device functions), and both routes' ms/eval.

    Each output must meet the bench's f32 envelope (value 1e-4 relative,
    White 1e-5 relative, other gradients 1e-2 relative or 0.5 absolute) or
    be no worse than twice the float32 torch.linalg route's own error."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    value, grads = gp.logml_value_and_grad(params, x, y)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"{label} launches: {json.dumps(launches)}", flush=True)
    check(launches["gram"] == 1 and launches["chol_inv_tile_off"] == 128
          and launches["logml_kernel_grads"] == 1
          and launches["logml_probe_grads"] == 0,
          f"{label} did not take the fused route")
    got = _flat_result(gt, value, grads)
    want = _f64_result(torch, gt, gp, params, x, y)
    keep = gp.FUSED_MIN_N
    gp.FUSED_MIN_N = x.shape[0] + 1
    try:
        check(not gp._fused_gate(params.kernel, x), "the route did not switch")
        lin = _flat_result(gt, *gp.logml_value_and_grad(params, x, y))
        lin_ms = time_ms(torch, lambda: gp.logml_value_and_grad(params, x, y),
                         reps=3)
    finally:
        gp.FUSED_MIN_N = keep
    names = ["value"] + gt.params.names(params.kernel)
    kinds = ["value"] + _leaf_kinds(gt, params.kernel)
    worst = {}
    for nm, kind, g, w, li in zip(names, kinds, got, want, lin):
        err, lin_err = abs(g - w), abs(li - w)
        rel = err / abs(w) if w else math.inf
        env = {"value": rel <= 1e-4, "white": rel <= 1e-5}.get(
            kind, rel <= 1e-2 or err <= 0.5)
        print(f"{label} {nm}: fused f32 {g:.8e} f64 {w:.8e} err {err:.3e} rel "
              f"{rel:.3e} (envelope {'met' if env else 'missed'}); torch.linalg "
              f"f32 {li:.8e} err {lin_err:.3e} (2x: {2.0 * lin_err:.3e})",
              flush=True)
        check(math.isfinite(g), f"{label} {nm}: not finite")
        check(env or err <= 2.0 * lin_err, f"{label} {nm}: outside the f32 "
              f"envelope and worse than twice the torch.linalg route's error")
        worst[nm] = {"err": err, "rel": rel, "linalg_err": lin_err}
    eval_ms, ms = _median_ms(torch, lambda: gp.logml_value_and_grad(params, x, y))
    print(f"{label} ms/eval (median of 5, CUDA events): fused {eval_ms:.2f} "
          f"{ms}; torch.linalg f32 {lin_ms:.2f}", flush=True)
    return {"ms_per_eval": eval_ms, "linalg_ms_per_eval": lin_ms,
            "launches": launches, "errors": worst}, want


def phase_families_e2e(torch, gt):
    """F1, F2 and F3 at the bench's N = 16,384 (numpy seed 0, x ~ U(-10,
    10), y ~ N(0, 1), float32): F1 SE(2, 3) * Matern(1, 5/2, 4) + White(0.1)
    on D = 1, F2 Ard(Matern(2, 5/2, 1) + White(0.25), [0.7, 2.3, 1.4]) on D
    = 3 (the JAX package's test kernels), F3 (_f3, a Product of a Sum) on D
    = 1, exact (_exact_family); F2 and F3 also through method="hybrid" for
    three probe seeds against the exact float64, their errors recorded; a
    Product of Sums past the term table (_past_table) on the torch.linalg
    route, its hybrid raising."""
    from gpx_torch.models import gp

    out = {}
    for label, d in (("F1", 1), ("F2", 3), ("F3", 1)):
        rng = np.random.default_rng(0)
        x_np = rng.uniform(-10.0, 10.0, size=(N_BENCH, d)).astype(np.float32)
        y_np = rng.normal(size=N_BENCH).astype(np.float32)
        kern = {"F1": lambda: gt.se(2.0, 3.0) * gt.matern(1.0, 2.5, 4.0)
                + gt.white(0.1),
                "F2": lambda: gt.ard(gt.matern(2.0, 2.5, 1.0) + gt.white(0.25),
                                     ELL3),
                "F3": lambda: _f3(gt)}[label]()
        params = gt.Parameters(mean=gt.zero(), kernel=kern)
        x = torch.as_tensor(x_np, device="cuda")
        y = torch.as_tensor(y_np, device="cuda")
        out[label], want = _exact_family(torch, gt, gp, label, params, x, y)
        torch.cuda.empty_cache()
        if label != "F1":
            out[f"{label}_hybrid"] = _family_hybrid(torch, gt, gp, label, params,
                                                    x, y, want)
        if label == "F3":  # F2's Ard has no stand-alone Gram stage
            out["F3_hybrid"]["stages_ms"] = _hybrid_stages(torch, gt, gp, kern,
                                                           x, y)
        if label == "F3":
            out["past_table"] = _past_table_route(torch, gt, gp, x, y)
        del x, y
        torch.cuda.empty_cache()
    out["not_spd"] = _not_spd(torch, gt, gp)
    return out


def _family_hybrid(torch, gt, gp, label, params, x, y, want):
    """A family through method="hybrid" (probes=64, the default deflation)
    for three probe seeds: the probe kernel twice and the exact gradient
    kernel never (launch counts), every output finite, each output's error
    against the exact float64 ``want`` recorded; ms/eval."""
    counters = _counters()
    hyb, names = {}, ["value"] + gt.params.names(params.kernel)
    for seed in (0, 1, 2):
        for c in counters.values():
            c.launches = 0
        key = torch.Generator(device="cuda").manual_seed(seed)
        res = gp.logml_value_and_grad(params, x, y, method="hybrid",
                                      probes=64, probe_key=key)
        torch.cuda.synchronize()
        check(counters["logml_probe_grads"].launches == 2
              and counters["logml_kernel_grads"].launches == 0,
              f"{label} hybrid: not the probe kernel twice")
        got = _flat_result(gt, *res)
        errs = [abs(g - w) for g, w in zip(got, want)]
        rels = [e / abs(w) if w else math.inf for e, w in zip(errs, want)]
        print(f"{label} hybrid seed {seed}: " + "; ".join(
            f"{nm} {g:.6e} (f64 {w:.6e}, err {e:.3e}, rel {r:.3e})"
            for nm, g, w, e, r in zip(names, got, want, errs, rels)),
            flush=True)
        check(all(math.isfinite(g) for g in got), f"{label} hybrid: not finite")
        for nm, e, r in zip(names, errs, rels):
            w_ = hyb.setdefault(nm, {"err": 0.0, "rel": 0.0})
            w_["err"], w_["rel"] = max(w_["err"], e), max(w_["rel"], r)
    eval_ms, ms = _median_ms(torch, lambda: gp.logml_value_and_grad(
        params, x, y, method="hybrid", probes=64))
    print(f"{label} hybrid ms/eval (median of 5, CUDA events): {eval_ms:.2f} "
          f"{ms}; worst of three seeds: {json.dumps(hyb)}", flush=True)
    return {"ms_per_eval": eval_ms, "worst": hyb}


def _past_table_route(torch, gt, gp, x, y):
    """_past_table at n = 4096 (>= FUSED_MIN_N, so the kernel alone
    decides): the exact path on the torch.linalg route (no Gram, leaf or
    gradient kernel launched), finite; the hybrid raises
    NotImplementedError naming the expansion's size."""
    n = 4096
    params = gt.Parameters(mean=gt.zero(), kernel=_past_table(gt))
    check(not params.kernel.cuda_supported, "the table took 24 rows")
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    value, grads = gp.logml_value_and_grad(params, x[:n], y[:n])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    got = _flat_result(gt, value, grads)
    print(f"past the table n={n}: launches {json.dumps(launches)}; value "
          f"{got[0]:.8e}", flush=True)
    check(not any(launches.values()), "past the table: a kernel launched")
    check(all(math.isfinite(g) for g in got), "past the table: not finite")
    try:
        gp.logml_value_and_grad(params, x[:n], y[:n], method="hybrid")
    except NotImplementedError as e:
        print(f"past the table hybrid raises: {e}", flush=True)
        check("24 factors" in str(e), "the message does not say why")
    else:
        check(False, "past the table: the hybrid did not raise")
    return {"launches": launches, "value": got[0]}


def _not_spd(torch, gt, gp):
    """ROADMAP's reproducer (sorted U(-10, 10), SE(1, 200), nugget -1e-3) in
    float32 on the card: at n = 300 (the torch.linalg route, analytic and
    autodiff) and n = 4096 (the fused route: the leaf's reciprocal root of
    a negative pivot) the value and every gradient must be NaN, not a
    finite number; log_marginal_likelihood(safe=True) in float64 gives
    -inf when every nugget fails (printed in float32)."""
    out = {}
    for n in (300, 4096):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.sort(rng.uniform(-10.0, 10.0, size=n))
                            .astype(np.float32), device="cuda")
        y = torch.as_tensor(rng.normal(size=n).astype(np.float32), device="cuda")
        params = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 200.0))
        fused = gp._fused_gate(params.kernel, x[:, None])
        check(fused == (n >= gp.FUSED_MIN_N), "not-SPD case: unexpected route")
        for method in ("analytic", "autodiff") if n == 300 else ("analytic",):
            got = _flat_result(gt, *gp.logml_value_and_grad(
                params, x, y, nugget=-1e-3, method=method))
            route = "fused" if fused and method == "analytic" else "torch.linalg"
            print(f"not SPD n={n} {method} ({route}): value and gradients {got}",
                  flush=True)
            check(all(math.isnan(g) for g in got),
                  f"not SPD n={n} {method}: not NaN")
            out[f"n{n}_{method}"] = got
    p64 = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 200.0, dtype=torch.float64))
    rng = np.random.default_rng(0)
    x3 = torch.as_tensor(np.sort(rng.uniform(-10.0, 10.0, size=300))
                         .astype(np.float32), device="cuda")
    y3 = torch.as_tensor(rng.normal(size=300).astype(np.float32), device="cuda")
    safe64 = float(gp.log_marginal_likelihood(p64, x3.double(), y3.double(),
                                              nugget=-1e-3, safe=True))
    safe32 = float(gp.log_marginal_likelihood(params, x3, y3, nugget=-1e-3,
                                              safe=True))
    print(f"not SPD n=300 log_marginal_likelihood(safe=True): float64 {safe64}, "
          f"float32 {safe32}", flush=True)
    check(safe64 == -math.inf, "safe=True did not give -inf")
    out["safe_f64"], out["safe_f32"] = safe64, safe32
    return out


def _value_terms(torch, gt, gp, kernel, x, y):
    """Where the bench value's error sits: each term of the fused value
    (the quadratic form r^T alpha, sum log diag(L^-1), and the logdet
    correction's tr(W_hat K) + nugget tr(W_hat), as gp._fused_logml_core
    forms them; no mean, no padding at N = 16384) against float64. Printed
    only: the limits are _against_f64's, on the value itself."""
    from gpx_torch.ops import cuda_chol, cuda_logml_grad

    nug = gp.LOGML_NUGGET
    k = gp.gram(kernel, x, nugget=nug)
    _, m = cuda_chol.chol_inv(k)
    alpha0 = m.T @ (m @ y)
    alpha = alpha0 + m.T @ (m @ (y - k @ alpha0))
    _, (tkw, trw) = cuda_logml_grad.logml_kernel_grads(kernel, x, alpha, m)
    got = (float(y @ alpha), float(torch.log(torch.diagonal(m)).sum()),
           float(tkw + nug * trw))
    k64 = k.double()
    l64 = torch.linalg.cholesky(k64)
    y64 = y.double()
    # the exact correction is tr(K^-1 K) = n
    want = (float(y64 @ torch.cholesky_solve(y64[:, None], l64)[:, 0]),
            -float(torch.log(torch.diagonal(l64)).sum()), float(x.shape[0]))
    print("bench value terms, f32 - f64 (r^T alpha, sum log diag M, "
          "tr(W_hat K) + nugget tr(W_hat)): "
          f"{[f'{a - b:.3e}' for a, b in zip(got, want)]}; value error "
          f"{-0.5 * (got[0] - want[0]) + (got[1] - want[1]) - 0.5 * (got[2] - want[2]):.3e}",
          flush=True)


def _counters():
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad, cuda_trmm

    return {"gram": cuda_gram.gram_cuda, "trmm": cuda_trmm.trmm,
            "syrk_lower": cuda_trmm.syrk_lower,
            "chol_inv_tile": cuda_chol.chol_inv_tile,
            "chol_inv_tile_off": cuda_chol.chol_inv_tile_off,
            "logml_kernel_grads": cuda_logml_grad.logml_kernel_grads,
            "logml_probe_grads": cuda_logml_grad.logml_probe_grads}


def phase_hybrid(torch, gt, records):
    """The bench case through method="hybrid" (probes=64, the default
    deflate of 64) against the float64 oracle for three probe seeds, and
    at n = 9000; its launch counts, ms/eval and stage times."""
    from gpx_torch.models import gp

    params, x_np, y_np = _bench_case(gt)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    value, grads = gp.logml_value_and_grad(params, x_np, y_np, method="hybrid",
                                           probes=64)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print("hybrid path launches: " + json.dumps(launches), flush=True)
    check(launches["logml_probe_grads"] == 2,
          "hybrid: logml_probe_grads did not launch twice")
    check(launches["logml_kernel_grads"] == 0,
          "hybrid: the exact gradient kernel launched")
    for name, n_launch in launches.items():
        if name != "logml_kernel_grads":
            check(n_launch > 0, f"{name} was not launched on the hybrid path")
    records["logml_probe_grads"]["launches"] = launches["logml_probe_grads"]

    oracle = _f64(torch, gt, gp, x, y)
    worst = _hold_hybrid(gt, value, grads, oracle, "hybrid seed 0 (default)")
    for seed in (1, 2):
        key = torch.Generator(device="cuda").manual_seed(seed)
        value, grads = gp.logml_value_and_grad(params, x, y, method="hybrid",
                                               probes=64, probe_key=key)
        worst = [max(a, b) for a, b in zip(worst, _hold_hybrid(
            gt, value, grads, oracle, f"hybrid seed {seed}"))]
    del oracle
    n_off = 9000
    value, grads = gp.logml_value_and_grad(params, x[:n_off], y[:n_off],
                                           method="hybrid", probes=64)
    _hold_hybrid(gt, value, grads, _f64(torch, gt, gp, x[:n_off], y[:n_off]),
                 "hybrid n=9000")

    eval_ms, ms = _median_ms(torch, lambda: gp.logml_value_and_grad(
        params, x, y, method="hybrid", probes=64))
    print(f"hybrid ms/eval (median of 5, CUDA events): {eval_ms:.2f} {ms}",
          flush=True)
    return {"ms_per_eval": eval_ms, "launches": launches,
            "worst (value abs, h abs, sigma rel, white rel)": worst,
            "stages_ms": _hybrid_stages(torch, gt, gp, params.kernel, x, y)}


def _hold_hybrid(gt, value, grads, oracle, label):
    """The hybrid's limits against float64: value abs <= 0.25, White
    gradient rel <= 2e-4, sigma rel <= 1e-2, h abs <= 0.5. The value and
    White limits are the JAX package's TPU record of its deflated hybrid,
    worst of 3 probe keys at N = 16k (PERF_TPU.md: value 0.06 abs, White
    4.9e-5 rel), taken x4 because the probe draws differ; sigma and h are
    the exact path's envelope."""
    v64, g64 = oracle
    got = [float(t) for t in gt.params.leaves(grads)]
    want = [float(t) for t in gt.params.leaves(g64)]
    v_abs = abs(float(value) - float(v64))
    h_abs = abs(got[0] - want[0])
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"{label}: value {float(value):.8e} f64 {float(v64):.8e} abs "
          f"{v_abs:.3e}; grads (h, sigma, white) {got} f64 {want} h abs "
          f"{h_abs:.3e} rel {rel}", flush=True)
    check(all(math.isfinite(g) for g in got), f"{label}: non-finite gradient")
    check(v_abs <= 0.25, f"{label}: value outside 0.25 abs")
    check(rel[2] <= 2e-4, f"{label}: white gradient outside 2e-4 relative")
    check(rel[1] <= 1e-2, f"{label}: sigma gradient outside 1e-2 relative")
    check(h_abs <= 0.5, f"{label}: h gradient outside 0.5 abs")
    return [v_abs, h_abs, rel[1], rel[2]]


def _hybrid_stages(torch, gt, gp, kernel, x, y):
    """Stand-alone times of the hybrid eval's stages at the bench case."""
    from gpx_torch.kernels import split_noise
    from gpx_torch.models.gp_iterative import pivoted_cholesky
    from gpx_torch.ops import cuda_chol, cuda_gram

    k = cuda_gram.gram_cuda(kernel, x, nugget=gp.LOGML_NUGGET)
    l, m = cuda_chol.chol_inv(k, spine=True)

    def solve(b):
        return cuda_chol.spine_solve_lower_t(l, m, cuda_chol.spine_solve_lower(l, m, b))

    gen = torch.Generator(device="cuda").manual_seed(0)
    b = _rademacher(torch, (x.shape[0], 128), gen)
    smooth, _ = split_noise(kernel)
    stages = {
        "gram": time_ms(torch, lambda: cuda_gram.gram_cuda(
            kernel, x, nugget=gp.LOGML_NUGGET), reps=3),
        "chol_inv_spine": time_ms(torch, lambda: cuda_chol.chol_inv(k, spine=True),
                                  reps=3),
        "solve_vector_x2": 2 * time_ms(torch, lambda: solve(y), reps=3),
        "solve_128_columns": time_ms(torch, lambda: solve(b), reps=3),
        "pivoted_cholesky_64": time_ms(torch, lambda: pivoted_cholesky(
            smooth, x, 64), reps=3),
        "qr_64": time_ms(torch, lambda: torch.linalg.qr(b[:, :64]), reps=3),
    }
    print("hybrid stages (ms, stand-alone): " + json.dumps(stages), flush=True)
    return stages


def _f64(torch, gt, gp, x, y):
    """The oracle: the non-fused route (torch.linalg) in float64 on the card."""
    p64 = gt.Parameters(mean=gt.zero(),
                        kernel=gt.se(3.0, 5.5, dtype=torch.float64)
                        + gt.white(0.5, dtype=torch.float64))
    return gp.logml_value_and_grad(p64, x.double(), y.double())


def _against_f64(torch, gt, gp, x, y, value, grads, label):
    """Hold an f32 result to the JAX package's recorded f32 envelope at the
    bench case (PERF_TPU.md, "f32 accuracy envelope at N=16k") against
    float64 on the same inputs."""
    v64, g64 = _f64(torch, gt, gp, x, y)
    got = [float(t) for t in gt.params.leaves(grads)]
    want = [float(t) for t in gt.params.leaves(g64)]
    v_rel = abs(float(value) - float(v64)) / abs(float(v64))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"{label} value {float(value):.8e} f64 {float(v64):.8e} rel {v_rel:.3e}")
    print(f"{label} grads (h, sigma, white) {got} f64 {want} rel {rel}",
          flush=True)
    check(all(math.isfinite(g) for g in got), f"{label}: non-finite gradient")
    check(v_rel <= 1e-4, f"{label}: value outside 1e-4 relative")
    check(rel[2] <= 1e-5, f"{label}: white gradient outside 1e-5 relative")
    check(rel[1] <= 1e-2, f"{label}: sigma gradient outside 1e-2 relative")
    check(abs(got[0] - want[0]) <= 0.5, f"{label}: h gradient outside 0.5 abs")
    return v_rel, rel, abs(got[0] - want[0])


# -- phase 3b: prediction ----------------------------------------------------

N_COV = 1024  # full_cov's and posterior_draw's test points
# the JAX package's TPU accuracy records of fit at N = M = 16k (PERF_TPU.md:
# the mean within 2.6e-4 of its scale, the fused route's variance within
# 6.4e-5), used as limits, of the largest |value| against float64
MEAN_LIMIT, VAR_LIMIT = 2.6e-4, 6.4e-5


def _fit64(gt, gp, params, x, y, xs, **kw):
    """The oracle: gp.fit in float64 (the plain route) on the coordinates
    the Gram kernel sees, x - c and xs - c with c the float32 mean of x
    (gram_cuda centres so). Distances are translation-invariant, and the
    float32 centring can merge a test point with a training point a float32
    ulp away (as at xs = 0.17274007 and x = 0.17274006 here): White then
    fires there on every float32 route, and on this oracle too."""
    c = x.mean(dim=0, keepdim=True)
    p64 = gt.Parameters(mean=gt.zero(), kernel=_f64_kernel(gt, params.kernel))
    return gp.fit(p64, (x - c).double(), y.double(), (xs - c).double(), **kw)


def _err_of_scale(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _hold_predict(label, what, err, lin_err, limit) -> None:
    """``err`` (of scale) within the JAX package's record ``limit``, or,
    where the float32 torch.linalg route misses it too, within twice that
    route's own error (as _hold takes the float32 plain version)."""
    ok = err <= limit or (lin_err > limit and err <= 2.0 * lin_err)
    print(f"{label} {what}: err {err:.3e} of scale (record {limit:g}); "
          f"torch.linalg f32 {lin_err:.3e} (2x: {2.0 * lin_err:.3e})",
          flush=True)
    check(ok, f"{label} {what}: outside the record and worse than twice the "
          f"torch.linalg route's error")


def _fit_launches(torch, gp, params, x, y, xs):
    """One fit with every counter set to 0 just before and read just after:
    the fused route is 2 Gram launches (K and the cross block), chol_inv's
    leaves, syrk_lower once and trmm three times per split (leaves - 1
    splits), and one more trmm, the variance's left_lower."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    post = gp.fit(params, x, y, xs)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    splits = launches["chol_inv_tile_off"] - 1
    check(launches["gram"] == 2 and splits == -(-x.shape[0] // 128) - 1
          and launches["syrk_lower"] == splits
          and launches["trmm"] == 3 * splits + 1
          and launches["logml_kernel_grads"] == 0
          and launches["logml_probe_grads"] == 0, "fit: not the fused route")
    return post, launches


def _predict_case(torch, gt, gp, label, params, x, y, xs):
    """fit at N = M = 16,384 on the fused route (launch counts), its mean
    and variance against the float64 plain route on the card from the
    float32 coordinates the kernels see (_fit64), beside the float32
    torch.linalg route; ms per fit on both routes, and the fused route's
    stages."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_trmm
    from gpx_torch.ops.chol import cholesky, forward_solve

    post, launches = _fit_launches(torch, gp, params, x, y, xs)
    print(f"fit {label} n={x.shape[0]} m={xs.shape[0]} launches: "
          f"{json.dumps(launches)}", flush=True)
    want = _fit64(gt, gp, params, x, y, xs)
    torch.cuda.empty_cache()
    keep = gp.FUSED_MIN_N
    gp.FUSED_MIN_N = x.shape[0] + 1
    try:
        lin = gp.fit(params, x, y, xs)
        lin_ms = _median_ms(torch, lambda: gp.fit(params, x, y, xs), reps=3)
    finally:
        gp.FUSED_MIN_N = keep
    errs = {"mean": _err_of_scale(post.mean, want.mean),
            "variance": _err_of_scale(post.variance, want.variance),
            "linalg_mean": _err_of_scale(lin.mean, want.mean),
            "linalg_variance": _err_of_scale(lin.variance, want.variance)}
    check(bool(torch.isfinite(post.mean).all() & torch.isfinite(post.variance).all()),
          f"fit {label}: not finite")
    _hold_predict(f"fit {label}", "mean", errs["mean"], errs["linalg_mean"],
                  MEAN_LIMIT)
    _hold_predict(f"fit {label}", "variance", errs["variance"],
                  errs["linalg_variance"], VAR_LIMIT)
    del want, lin
    torch.cuda.empty_cache()
    fit_ms = _median_ms(torch, lambda: gp.fit(params, x, y, xs))

    # the fused route's stages, stand-alone
    kern = params.kernel
    kxx = cuda_gram.gram_cuda(kern, x, nugget=gp.PREDICT_NUGGET)
    kxs = cuda_gram.gram_cuda(kern, x, xs)
    # padded as _fused_fit_core pads them
    pad = (-x.shape[0]) % 128
    kxx_p = gp._pad_spd(kxx, pad)
    kxs_p = torch.nn.functional.pad(kxs, (0, 0, 0, pad))
    _, l_inv = cuda_chol.chol_inv(kxx_p)
    r = torch.nn.functional.pad(y - params.mean(x), (0, pad))

    def refine():
        a = l_inv.T @ (l_inv @ r)
        for _ in range(2):
            a = a + l_inv.T @ (l_inv @ (r - kxx_p @ a))
        return a

    stages = {
        "gram_K": time_ms(torch, lambda: cuda_gram.gram_cuda(
            kern, x, nugget=gp.PREDICT_NUGGET), reps=3),
        "gram_cross": time_ms(torch, lambda: cuda_gram.gram_cuda(kern, x, xs),
                              reps=3),
        "chol_inv": time_ms(torch, lambda: cuda_chol.chol_inv(kxx_p), reps=3),
        "alpha_2_refinements": time_ms(torch, refine, reps=3),
        "trmm_left_lower": time_ms(torch, lambda: cuda_trmm.trmm(
            kxs_p, l_inv, mode="left_lower"), reps=3),
    }
    bound = bound_ms(tf32_flops=3.0 * kxs_p.shape[0] ** 2 * kxs_p.shape[1])
    del l_inv, kxx_p, kxs_p
    torch.cuda.empty_cache()
    # the torch.linalg route's one solve for the whole (N, M) block: its
    # memory beyond its own output
    lmat = cholesky(kxx)
    del kxx
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = forward_solve(lmat, kxs)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - a.numel() * 4
    del a, lmat, kxs
    torch.cuda.empty_cache()
    print(f"fit {label} n={x.shape[0]} m={xs.shape[0]}: fused {fit_ms[0]:.2f} ms per fit "
          f"{fit_ms[1]}; torch.linalg f32 {lin_ms[0]:.2f} {lin_ms[1]} (median, "
          f"CUDA events); stages (ms, stand-alone): {json.dumps(stages)}; "
          f"trmm left_lower {stages['trmm_left_lower']:.3f} ms against its "
          f"3xTF32 bound {bound[0]:.3f} ms; forward_solve of the whole block: "
          f"{extra / 2**20:.1f} MiB beyond its output", flush=True)
    return {"ms_per_fit": fit_ms, "linalg_ms_per_fit": lin_ms,
            "launches": launches, "errors": errs, "stages_ms": stages,
            "trmm_left_lower_bound_ms": bound[0],
            "forward_solve_extra_mib": extra / 2**20}


def _hold_draw(torch, label, got, mean, l, z) -> None:
    """A draw against ``mean + z L^T`` recomputed from the same generator
    seed, within 1e-5 of its scale (the same float32 operations)."""
    want = mean + z @ l.T
    err = float((got - want).abs().max() / want.abs().max())
    print(f"{label}: shape {tuple(got.shape)}, against mean + z L^T: {err:.3e} "
          f"of scale", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= 1e-5, f"{label} disagrees")


def _predict_cov(torch, gt, gp, label, params, x, y, xs):
    """full_cov at M = 1024 against float64 (the mean within the record;
    the covariance within the variance record or twice the float32
    torch.linalg marginal variance's error there), and posterior_draw held
    as mean + z L^T."""
    from gpx_torch.ops.chol import add_jitter, cholesky

    mean, cov = gp.fit(params, x, y, xs, full_cov=True)
    mean64, cov64 = _fit64(gt, gp, params, x, y, xs, full_cov=True)
    keep = gp.FUSED_MIN_N
    gp.FUSED_MIN_N = x.shape[0] + 1
    try:
        lin = gp.fit(params, x, y, xs)
    finally:
        gp.FUSED_MIN_N = keep
    lin_var = _err_of_scale(lin.variance, torch.diagonal(cov64))
    errs = {"mean": _err_of_scale(mean, mean64), "cov": _err_of_scale(cov, cov64),
            "linalg_variance": lin_var}
    _hold_predict(f"full_cov {label} m={N_COV}", "mean", errs["mean"],
                  _err_of_scale(lin.mean, mean64), MEAN_LIMIT)
    _hold_predict(f"full_cov {label} m={N_COV}", "cov", errs["cov"], lin_var,
                  VAR_LIMIT)
    got = gp.posterior_draw(torch.Generator(device="cuda").manual_seed(5),
                            params, x, y, xs, shape=(4,))
    z = torch.randn((4, N_COV), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    _hold_draw(torch, f"posterior_draw {label} m={N_COV}", got, mean,
               cholesky(add_jitter(cov, 1e-8)), z)
    return errs


def _predict_as_drawn(torch, gt, gp, params, x, y, xs):
    """fit on the bench data as drawn, whose float32 x holds one coincident
    pair. White fires on it, so K has two equal rows but for the nugget
    (1e-6, 4 f32 ulps of K's diagonal 3.5): the pair's Schur pivot is ~2e-6,
    inside the float32 factor's rounding of the n-term Schur sums. Whether
    a float32 factor meets a negative pivot there (NaN, as on a Gram that
    is not positive definite) is the rounding's draw, on either route:
    both outcomes are printed, with each finite result's error against
    float64, and a finite fused result is held to _hold_predict's limits.
    The accuracy is held on the merged data (phase_predict)."""
    post = gp.fit(params, x, y, xs)
    want = _fit64(gt, gp, params, x, y, xs)
    keep = gp.FUSED_MIN_N
    gp.FUSED_MIN_N = N_BENCH + 1
    try:
        lin = gp.fit(params, x, y, xs)
    finally:
        gp.FUSED_MIN_N = keep
    check(bool(torch.isfinite(want.mean).all()), "the float64 fit is not finite")
    out = {}
    for route, res in (("fused", post), ("linalg", lin)):
        fin = bool(torch.isfinite(res.mean).all())
        out[route] = {"finite": fin}
        if fin:
            out[route].update(mean=_err_of_scale(res.mean, want.mean),
                              variance=_err_of_scale(res.variance, want.variance))
    print(f"fit se+white as drawn (1 coincident pair) against float64, errors "
          f"of scale: {json.dumps(out)}", flush=True)
    if out["fused"]["finite"]:
        for what, limit in (("mean", MEAN_LIMIT), ("variance", VAR_LIMIT)):
            _hold_predict("fit se+white as drawn", what, out["fused"][what],
                          out["linalg"].get(what, math.inf), limit)
    return out


def phase_predict(torch, gt):
    """BASELINE config 5 at full width: the bench data and the test grid xs
    = linspace(-10, 10, 16384). First fit on the data as drawn
    (_predict_as_drawn: its one coincident pair). Then on the same data
    with the pair merged (the second point dropped: N = 16,383, which the
    fused route pads to 16,384), fit for SE(3.0, 5.5) + White(0.5) and F3
    (_predict_case), and full_cov and posterior_draw at M = 1024
    (_predict_cov); gp.draw at N = 16,384 on the data as drawn (its nugget,
    1e-3, is above the pair's rounding), held as mean + z L^T with the
    factor's backward error formed in float64."""
    from gpx_torch.models import gp
    from gpx_torch.ops.chol import cholesky

    t0 = time.perf_counter()
    params, x_np, y_np = _bench_case(gt)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    xs = torch.linspace(-10.0, 10.0, N_BENCH, device="cuda")[:, None]
    xc = torch.linspace(-10.0, 10.0, N_COV, device="cuda")[:, None]
    out = {"as_drawn": _predict_as_drawn(torch, gt, gp, params, x, y, xs)}
    first = np.sort(np.unique(x_np[:, 0], return_index=True)[1])
    out["n_merged"] = int(first.size)
    idx = torch.as_tensor(first, device="cuda")
    xu, yu = x[idx].contiguous(), y[idx].contiguous()
    for label, kern in (("se+white", params.kernel), ("F3", _f3(gt))):
        p = gt.Parameters(mean=gt.zero(), kernel=kern)
        out[label] = _predict_case(torch, gt, gp, label, p, xu, yu, xs)
        out[label]["full_cov"] = _predict_cov(torch, gt, gp, label, p, xu, yu, xc)
        torch.cuda.empty_cache()
    del xu, yu
    got = gp.draw(torch.Generator(device="cuda").manual_seed(6), params, x)
    k = params.kernel.gram(x, nugget=gp.DRAW_NUGGET)
    lmat = cholesky(k)
    z = torch.randn((N_BENCH,), generator=torch.Generator(
        device="cuda").manual_seed(6), device="cuda")
    _hold_draw(torch, f"draw n={N_BENCH}", got, params.mean(x), lmat, z)
    l64 = lmat.double()
    back = float(torch.linalg.matrix_norm(l64 @ l64.T - k.double())
                 / torch.linalg.matrix_norm(k.double()))
    print(f"draw n={N_BENCH}: its factor's backward error ||L L^T - K|| / ||K|| "
          f"{back:.3e} (limit 1e-5), formed in float64", flush=True)
    check(back <= 1e-5, "draw: the factor's backward error")
    out["draw_factor_backward_error"] = back
    del k, lmat, l64
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase_predict: {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 4: the matrix-free path -------------------------------------------

N_IT = 32768          # examples/large_n.py's iterative case
N_SCALE = 131072      # dense K would be 64 GiB in float32
N_TEST = 1024         # fit_iterative's test points
N_RAGGED, N_DUP, N_CROSS = 4000, 2001, (1000, 3001)
CHECK_ROWS = 4096     # rows of the plain version held at N_SCALE
# examples/large_n.py's run_iterative settings
ITER = dict(n_probes=8, lanczos_iters=32, cg_tol=1e-4, precond_rank=64)


def _iter_case(n):
    """examples/large_n.py's data: numpy seed 0, x sorted U(-10, 10) of
    shape (n, 1), y = sin x + 0.7 N(0, 1), both float32."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-10.0, 10.0, size=(n, 1)), axis=0).astype(np.float32)
    y = (np.sin(x[:, 0]) + rng.normal(size=n) * 0.7).astype(np.float32)
    return x, y


def _iter_kernel(gt, dtype=None):
    return gt.se(2.0, 3.0, device="cuda", dtype=dtype) + gt.white(
        0.5, device="cuda", dtype=dtype)


def _iter_matern(gt, dtype=None):
    return gt.matern(2.0, 1.5, 3.0, device="cuda", dtype=dtype) + gt.white(
        0.5, device="cuda", dtype=dtype)


def _iter_counters():
    from gpx_torch.ops import cuda_gram, cuda_matvec

    return {"gram_matvec": cuda_matvec.gram_matvec_cuda,
            "cross_matvec": cuda_matvec.cross_matvec_cuda,
            "gram": cuda_gram.gram_cuda}


def _count(torch, fn):
    """``fn()`` with every matvec and Gram launch counter, and the calls of
    the torch route of the matvec, set to 0 just before and read just
    after."""
    from gpx_torch.ops import cuda_matvec

    counters = _iter_counters()
    for c in counters.values():
        c.launches = 0
    cuda_matvec._gram_matvec_torch.calls = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    counts["torch_route_calls"] = cuda_matvec._gram_matvec_torch.calls
    return out, counts


# Leaf terms of each family kernel (_families), for the matvec's FP32 bound
TERMS = {"se*periodic+white": 3, F3: 5}


def _matvec_bound(n1, n2, d, r, name="se+white"):
    """The least time of one matvec on the units that do its work: the
    product, 4 x 2 N1 N2 R on the tensor cores (four TF32 products of
    hi/lo splits); the exponentials (and square roots, logarithms) on
    the special-function units; the distance and term algebra on the CUDA
    cores in FP32 (a difference and a multiply-add per dimension, a scale
    and a multiply-add per leaf term: 3 D + 2 T per entry); the bytes (x1,
    x2, V read once, the output written once)."""
    entries = float(n1) * n2
    return bound_ms(tf32_flops=8.0 * entries * r,
                    exps=float(SFU_PER_ENTRY[name]) * entries,
                    flops=(3.0 * d + 2.0 * TERMS.get(name, 2)) * entries,
                    nbytes=4.0 * ((n1 + n2) * d + (n2 + n1) * r))


def _matvec_bound_fp32(n1, n2, r, name="se+white"):
    """The bound of a product on the CUDA cores: 2 N1 N2 R FP32 FMA flops,
    as the FP32 kernel that the tensor-core one replaced was held."""
    return bound_ms(flops=2.0 * n1 * n2 * r,
                    exps=float(SFU_PER_ENTRY[name]) * n1 * n2,
                    nbytes=4.0 * (n1 + 2 * r * n2))


def _hold_gram_matvec(torch, label, kern, k64, x, v, nug, rows=None) -> float:
    """gram_matvec's kernel on the centred x (as the wrapper hands it)
    against float64 and against its plain TF32 version, within 4 f32 ulps
    of each output's sum of |terms|; with ``rows``, the first rows only
    (the cross form plus the nugget). A repeated call gives the same bits.
    Returns the largest absolute error."""
    from gpx_torch.ops import cuda_matvec as cm

    xc = x - x.mean(dim=0, keepdim=True)
    got = cm.gram_matvec_cuda(kern, xc, v, nugget=nug)
    check(torch.equal(got, cm.gram_matvec_cuda(kern, xc, v, nugget=nug)),
          f"{label}: a repeated call differs")
    x64, v64 = xc.double(), v.double()
    if rows is None:
        want = cm._gram_matvec_torch(k64, x64, v64, nug)
        scale = cm._gram_matvec_torch(k64, x64, v64.abs(), nug)
    else:  # the first rows: the cross form plus the nugget
        want = cm._cross_matvec_torch(k64, x64[:rows], x64, v64) + nug * v64[:rows]
        scale = (cm._cross_matvec_torch(k64, x64[:rows], x64, v64.abs())
                 + nug * v64[:rows].abs())
        got = got[:rows]
    err = _hold_ulps(torch, label, got, want, scale, 4.0)
    del want
    wit = cm._gram_matvec_tf32x3_torch(kern, xc, v, nug, rows=rows)
    _hold_ulps(torch, f"{label} against the plain TF32 version", got,
               wit.double(), scale, 4.0)
    return err


def _hold_cross_matvec(torch, label, kern, k64, x1, x2, v) -> float:
    """cross_matvec's kernel on the sets centred at x2's mean (as the
    wrapper hands them), held as :func:`_hold_gram_matvec` holds
    gram_matvec."""
    from gpx_torch.ops import cuda_matvec as cm

    c = x2.mean(dim=0, keepdim=True)
    x1c, x2c = x1 - c, x2 - c
    got = cm.cross_matvec_cuda(kern, x1c, x2c, v)
    check(torch.equal(got, cm.cross_matvec_cuda(kern, x1c, x2c, v)),
          f"{label}: a repeated call differs")
    want = cm._cross_matvec_torch(k64, x1c.double(), x2c.double(), v.double())
    scale = cm._cross_matvec_torch(k64, x1c.double(), x2c.double(),
                                   v.double().abs())
    err = _hold_ulps(torch, label, got, want, scale, 4.0)
    wit = cm._cross_matvec_tf32x3_torch(kern, x1c, x2c, v)
    _hold_ulps(torch, f"{label} against the plain TF32 version", got,
               wit.double(), scale, 4.0)
    return err


def _matvec_checks(torch, gt, records):
    """Both kernels against their plain versions at the path's shapes
    (R = 1, 8, 9 and fit_iterative's 256), the ragged, D = 12 and D = 20
    shapes, and a 4096-row slice at N = 131,072; their records (kernel, plain,
    library ms and bounds at N = 32,768).

    Every output within 4 f32 ulps of its sum of |terms| sum_j |K_ij|
    |V_jr| (_hold_ulps) against float64: each entry k(r2) carries a few
    ulps (the f32 difference, ex2, the argument's rounding) with random
    signs; the four TF32 products of hi/lo splits miss up to 2 x 2^-22 of
    each term (both lo parts rounded), signs at random, which a row that
    one term dominates shows most (D = 20, where the diagonal is ~100
    times a typical entry); each k step's truncating MMAs go into a fresh
    fragment, added to the accumulator rounded, and every 64 k an exact
    TwoSum folds it. A second witness: the plain TF32 version (the
    kernel's arithmetic in torch, _gram_matvec_tf32x3_torch) within the
    same 4 ulps. A repeated call gives the same bits (no atomics)."""
    from gpx_torch.ops import cuda_gram
    from gpx_torch.ops import cuda_matvec as cm

    gen = torch.Generator(device="cuda").manual_seed(1)
    kern, k64 = _iter_kernel(gt), _iter_kernel(gt, torch.float64)
    nug = 1e-3
    errs = {"gram_matvec": 0.0, "cross_matvec": 0.0}

    def gram_case(label, x, v, rows=None, kern=kern, k64=k64):
        errs["gram_matvec"] = max(errs["gram_matvec"], _hold_gram_matvec(
            torch, label, kern, k64, x, v, nug, rows))

    def cross_case(label, x1, x2, v, kern=kern, k64=k64):
        errs["cross_matvec"] = max(errs["cross_matvec"], _hold_cross_matvec(
            torch, label, kern, k64, x1, x2, v))

    x = torch.as_tensor(_iter_case(N_IT)[0], device="cuda")
    for r in (1, 8, 9, 256):
        v = torch.randn((N_IT, r), generator=gen, device="cuda")
        gram_case(f"gram_matvec n={N_IT} d=1 r={r}", x, v)
    del v
    xr = torch.rand((N_RAGGED, 2), generator=gen, device="cuda") * 20.0 - 10.0
    gram_case(f"gram_matvec n={N_RAGGED} d=2 r=3 (ragged)", xr,
              torch.randn((N_RAGGED, 3), generator=gen, device="cuda"))
    # D = 12: broadcast differences keep duplicated points at r2 == 0
    xd = torch.randn((N_DUP, 12), generator=gen, device="cuda")
    nd = N_DUP // 4
    xd[N_DUP - nd:] = xd[:nd]
    gram_case(f"gram_matvec n={N_DUP} d=12 r=2 ({nd} duplicated points)", xd,
              torch.randn((N_DUP, 2), generator=gen, device="cuda"))
    # D = 20: coordinates through L1 (the kernel stages D <= 16 in shared
    # memory); R = 40: three 16-column chunks, the last ragged
    xw = torch.randn((N_DUP, 20), generator=gen, device="cuda")
    xw[N_DUP - nd:] = xw[:nd]
    gram_case(f"gram_matvec n={N_DUP} d=20 r=40 ({nd} duplicated points)", xw,
              torch.randn((N_DUP, 40), generator=gen, device="cuda"))
    xs = torch.linspace(-10.0, 10.0, N_TEST, device="cuda")[:, None]
    cross_case(f"cross_matvec ({N_TEST}, {N_IT}) d=1 r=1", xs, x,
               torch.randn((N_IT, 1), generator=gen, device="cuda"))
    n1, n2 = N_CROSS
    x2 = torch.rand((n2, 2), generator=gen, device="cuda") * 20.0 - 10.0
    x1 = torch.cat([x2[:100], torch.rand((n1 - 100, 2), generator=gen,
                                         device="cuda") * 20.0 - 10.0])
    cross_case(f"cross_matvec ({n1}, {n2}) d=2 r=3 (ragged, 100 duplicates "
               f"across the sets)", x1, x2,
               torch.randn((n2, 3), generator=gen, device="cuda"))
    xbig = torch.as_tensor(_iter_case(N_SCALE)[0], device="cuda")
    vbig = torch.randn((N_SCALE, 9), generator=gen, device="cuda")
    gram_case(f"gram_matvec n={N_SCALE} d=1 r=9 (first {CHECK_ROWS} rows)",
              xbig, vbig, rows=CHECK_ROWS)
    # Matern 3/2 + White: the path's width, the ragged and D = 12 shapes,
    # and a cross product with duplicates across the sets
    mk, mk64 = _iter_matern(gt), _iter_matern(gt, torch.float64)
    gram_case(f"gram_matvec matern32+white n={N_IT} d=1 r=9", x,
              torch.randn((N_IT, 9), generator=gen, device="cuda"), kern=mk,
              k64=mk64)
    gram_case(f"gram_matvec matern32+white n={N_RAGGED} d=2 r=3 (ragged)", xr,
              torch.randn((N_RAGGED, 3), generator=gen, device="cuda"), kern=mk,
              k64=mk64)
    gram_case(f"gram_matvec matern32+white n={N_DUP} d=12 r=2 ({nd} duplicated "
              f"points)", xd, torch.randn((N_DUP, 2), generator=gen, device="cuda"),
              kern=mk, k64=mk64)
    cross_case(f"cross_matvec matern32+white ({n1}, {n2}) d=2 r=3 (100 "
               f"duplicates across the sets)", x1, x2,
               torch.randn((n2, 3), generator=gen, device="cuda"), kern=mk,
               k64=mk64)
    # a product (its factors multiplied in registers) at the path's width
    pk = _families(gt)["se*periodic+white"]
    gram_case(f"gram_matvec se*periodic+white n={N_RAGGED} d=1 r=9 (ragged)",
              xr[:, :1], torch.randn((N_RAGGED, 9), generator=gen, device="cuda"),
              kern=pk, k64=_f64_kernel(gt, pk))
    # F3, a Product of a Sum (a leaf in two products of the expansion), at
    # the path's width, and a Product of Sums past the table raising
    fk = _f3(gt)
    gram_case(f"gram_matvec {F3} n={N_IT} d=1 r=9", x,
              torch.randn((N_IT, 9), generator=gen, device="cuda"), kern=fk,
              k64=_f64_kernel(gt, fk))
    cross_case(f"cross_matvec {F3} ({N_TEST}, {N_IT}) d=1 r=9", xs, x,
               torch.randn((N_IT, 9), generator=gen, device="cuda"), kern=fk,
               k64=_f64_kernel(gt, fk))
    from gpx_torch.ops.matvec import gram_matvec
    try:
        gram_matvec(_past_table(gt), x[:1024],
                    torch.ones((1024, 1), device="cuda"))
    except NotImplementedError as e:
        print(f"gram_matvec past the table raises: {e}", flush=True)
    else:
        check(False, "gram_matvec past the table did not raise")
    torch.cuda.empty_cache()

    # times at the path's shapes: CG's width r = 9 (alpha + 8 probes);
    # the library call is one torch.matmul on a prebuilt K, which leaves
    # out the Gram build: no single PyTorch call forms K V without K
    t = _matvec_times(torch, gt, gen)
    xc = x - x.mean(dim=0, keepdim=True)
    v = torch.randn((N_IT, 9), generator=gen, device="cuda")
    plain = time_ms(torch, lambda: cm._gram_matvec_torch(kern, xc, v, nug), reps=3)
    kmat = cuda_gram.gram_cuda(kern, xc, nugget=nug)
    lib = time_ms(torch, lambda: torch.matmul(kmat, v), reps=20)
    del kmat
    bound = _matvec_bound(N_IT, N_IT, 1, 9)
    old = _matvec_bound_fp32(N_IT, N_IT, 9)
    for name, ms in t["gram_matvec_family_ms"].items():
        fb = _matvec_bound(N_IT, N_IT, 1, 9, name)
        ms.update(bound_ms=fb[0], bound_by=fb[1],
                  bound_fp32_ms=_matvec_bound_fp32(N_IT, N_IT, 9, name)[0])
        print(f"gram_matvec {name} n={N_IT} r=9: {ms['ms']:.3f} ms (bound "
              f"{fb[0]:.3f} ms, {fb[1]}; FP32-FMA bound {ms['bound_fp32_ms']:.3f})",
              flush=True)
    t["gram_matvec_bound_ms"] = {
        r: [_matvec_bound(N_IT, N_IT, 1, r)[0], _matvec_bound_fp32(N_IT, N_IT, r)[0]]
        for r in (1, 8, 9, 256)}
    times = t["gram_matvec_ms"]
    print(f"gram_matvec n={N_IT} d=1: kernel r=1 {times[1]:.3f} ms, r=8 "
          f"{times[8]:.3f} ms, r=9 {times[9]:.3f} ms, r=256 {times[256]:.3f} ms "
          f"(bounds, tensor-core and FP32-FMA: {json.dumps(t['gram_matvec_bound_ms'])}); "
          f"plain (r=9, float32) {plain:.3f} ms; torch.matmul on a prebuilt K "
          f"(r=9, Gram build excluded) {lib:.3f} ms; bound (r=9) {bound[0]:.3f} "
          f"ms ({bound[1]}; FP32-FMA {old[0]:.3f}); n={N_SCALE} r=9 "
          f"{t['gram_matvec_ms_n131072_r9']:.3f} ms", flush=True)
    records["gram_matvec"] = _record(
        "gram_matvec", "gpx_torch/csrc/matvec.cu", "gpx/ops/pallas_matvec.py:73",
        errs["gram_matvec"], times[9], plain, bound, lib)

    xsc, xc2 = xs - x.mean(dim=0, keepdim=True), xc
    alpha = torch.randn((N_IT, 1), generator=gen, device="cuda")
    ms = t["cross_matvec_ms"]
    plain = time_ms(torch, lambda: cm._cross_matvec_torch(kern, xsc, xc2, alpha), reps=5)
    kx = cuda_gram.gram_cuda(kern, xsc, xc2)
    lib = time_ms(torch, lambda: torch.matmul(kx, alpha), reps=20)
    bound = _matvec_bound(N_TEST, N_IT, 1, 1)
    old = _matvec_bound_fp32(N_TEST, N_IT, 1)
    print(f"cross_matvec {F3} ({N_TEST}, {N_IT}) r=1: "
          f"{t['cross_matvec_f3_ms']:.3f} ms", flush=True)
    print(f"cross_matvec ({N_TEST}, {N_IT}) r=1: kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, torch.matmul on a prebuilt K {lib:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}; FP32-FMA {old[0]:.4f})", flush=True)
    records["cross_matvec"] = _record(
        "cross_matvec", "gpx_torch/csrc/matvec.cu", "gpx/ops/pallas_matvec.py:175",
        errs["cross_matvec"], ms, plain, bound, lib)
    return t


def _matvec_times(torch, gt, gen):
    """The matvec kernels' times at the path's shapes (CUDA events):
    gram_matvec at N = 32,768 for R = 1, 8, 9 and 256 and at N = 131,072
    for R = 9, cross_matvec (1024 x 32,768, R = 1), every family at R = 9.
    Uses only what earlier trees of the port have (``--matvec-times``)."""
    from gpx_torch.ops import cuda_matvec as cm

    kern, nug = _iter_kernel(gt), 1e-3
    x = torch.as_tensor(_iter_case(N_IT)[0], device="cuda")
    xc = x - x.mean(dim=0, keepdim=True)
    times = {}
    for r in (1, 8, 9, 256):
        v = torch.randn((N_IT, r), generator=gen, device="cuda")
        times[r] = time_ms(torch, lambda: cm.gram_matvec_cuda(kern, xc, v, nugget=nug),
                           reps=20 if r < 256 else 3)
    v = torch.randn((N_IT, 9), generator=gen, device="cuda")
    family_ms = {name: {"ms": time_ms(torch, lambda: cm.gram_matvec_cuda(
        fk, xc, v, nugget=nug), reps=10)} for name, fk in _families(gt).items()}
    xbig = torch.as_tensor(_iter_case(N_SCALE)[0], device="cuda")
    xbc = xbig - xbig.mean(dim=0, keepdim=True)
    vbig = torch.randn((N_SCALE, 9), generator=gen, device="cuda")
    big_ms = time_ms(torch, lambda: cm.gram_matvec_cuda(kern, xbc, vbig, nugget=nug),
                     reps=3)
    xs = torch.linspace(-10.0, 10.0, N_TEST, device="cuda")[:, None]
    xsc = xs - x.mean(dim=0, keepdim=True)
    alpha = torch.randn((N_IT, 1), generator=gen, device="cuda")
    cross = time_ms(torch, lambda: cm.cross_matvec_cuda(kern, xsc, xc, alpha),
                    reps=20)
    out = {"gram_matvec_ms": times, "gram_matvec_ms_n131072_r9": big_ms,
           "gram_matvec_family_ms": family_ms, "cross_matvec_ms": cross}
    if F3 in family_ms:
        fk = _families(gt)[F3]
        out["cross_matvec_f3_ms"] = time_ms(
            torch, lambda: cm.cross_matvec_cuda(fk, xsc, xc, alpha), reps=20)
    return out


def phase_matvec_times(torch, gt):
    """``--matvec-times``: the kernels' times (_matvec_times), then the
    iterative logML and fit_iterative ms/eval at N = 32,768 (median of 5,
    CUDA events), in one JSON line."""
    from gpx_torch.models import gp_iterative as gi

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = _matvec_times(torch, gt, gen)
    x_np, y_np = _iter_case(N_IT)
    params = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt))
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    xs = torch.linspace(-10.0, 10.0, N_TEST, device="cuda")[:, None]
    key = torch.Generator(device="cuda").manual_seed(0)
    out["logml_ms_per_eval"] = _median_ms(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x, y, key, **ITER))
    out["fit_ms_per_eval"] = _median_ms(torch, lambda: gi.fit_iterative(
        params, x, y, xs, cg_tol=ITER["cg_tol"], precond_rank=ITER["precond_rank"],
        variance="exact", variance_block=256))
    print("matvec_times: " + json.dumps(out), flush=True)
    return out


def _bench_case(gt):
    """The bench case: numpy seed 0, x ~ U(-10, 10) of shape (16384, 1),
    y ~ N(0, 1), float32 numpy arrays; SE(3.0, 5.5) + White(0.5)."""
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-10.0, 10.0, size=(N_BENCH, 1)).astype(np.float32)
    y_np = rng.normal(size=N_BENCH).astype(np.float32)
    params = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5) + gt.white(0.5))
    return params, x_np, y_np


def _bench_case_cuda(torch, gt):
    """The bench case with x and y on the card."""
    params, x_np, y_np = _bench_case(gt)
    return (params, torch.as_tensor(x_np, device="cuda"),
            torch.as_tensor(y_np, device="cuda"))


def _hybrid_probe_inputs(torch, gt, gp, kernel, x, y):
    """The two probe blocks of one hybrid eval at the bench case, as
    ``_logml_value_and_grad_hybrid`` forms them (seed-0 Rademacher probes,
    s = 64, deflated to rank 64): ``(alpha, (u_plain, z), (u_aug, z_aug))``;
    z_aug carries Q's columns, so it is not +-1."""
    from gpx_torch.ops import cuda_chol, cuda_gram

    k = cuda_gram.gram_cuda(kernel, x, nugget=gp.LOGML_NUGGET)
    l, m = cuda_chol.chol_inv(k, spine=True)

    def solve(b):
        return cuda_chol.spine_solve_lower_t(l, m, cuda_chol.spine_solve_lower(l, m, b))

    alpha = solve(y)
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = _rademacher(torch, (x.shape[0], 64), gen)
    u_plain, aug = gp._hybrid_deflation(kernel, x, z, solve, x.shape[0], None)
    return alpha, (u_plain, z), aug


def _probe_bound(n, s):
    """The probe kernel's bound: the larger of 3 x 2 n^2 s TF32 FLOPs (one
    2s-deep product over the lower triangle, three passes), one exp per
    lower entry on the SFU, and the bytes (U, Z, x, alpha read once)."""
    return bound_ms(tf32_flops=6.0 * n * n * s, exps=0.5 * n * n,
                    nbytes=4.0 * (2 * n * s + 2 * n))


def _probe_bound_fp32(n, s):
    """The earlier SIMT kernel's bound: 2 n^2 s FP32 FLOPs on the CUDA
    cores."""
    return bound_ms(flops=2.0 * n * n * s, nbytes=4.0 * (2 * n * s + 2 * n))


def _gram_l1_only(torch):
    """``gpx_gram`` of ``csrc/gram.cu`` built with every D on its L1 path
    (-DGPX_GRAM_L1_D=64) into ``build/gram_l1/``, as ``_build.function``
    gives an entry point; None where the source has no such knob."""
    import ctypes
    from pathlib import Path

    from gpx_torch.ops import _build, cuda_gram

    src = _build.CSRC / "gram.cu"
    if "GPX_GRAM_L1_D" not in src.read_text():
        return None
    out = Path(_build.BUILD_ROOT).parent / "gram_l1"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libgram.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DGPX_GRAM_L1_D=64",
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).gpx_gram
    fn.argtypes = cuda_gram._ARGS
    fn.restype = ctypes.c_int
    return fn


def phase_kernel_times(torch, gt):
    """``--kernel-times``: the probe kernel at N = 16,384 (SE + White at
    s = 1, 8, 64, 128; Matern 5/2 + White with ARD at D = 3, s = 64), the
    Gram at N = 16,384 for every family at D = 1 and 2 beside the card's
    fill floor, and SE + White at D = 9-12 and 20 on its staged and its L1
    coordinate path in turns (_gram_l1_only), logml_kernel_grads' times
    and outputs in hex (SE + White, and ARD at D = 3; timed before the
    Gram's writes), the hybrid's probe
    stage (its two calls on the bench case's real blocks), and the exact
    and hybrid ms/eval (median of 5), in one JSON line. Kernel times by
    CUDA events. Uses only what earlier trees of the port have, so a copy
    of this script beside an earlier tree's ``gpx_torch`` times both trees
    alike."""
    from gpx_torch.models import gp
    from gpx_torch.ops import _build, cuda_chol, cuda_gram
    from gpx_torch.ops import cuda_logml_grad as clg

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"probe_ms": {}, "probe_bound_ms": {}, "gram_ms": {}}
    kern = gt.se(3.0, 5.5) + gt.white(0.5)
    x = torch.rand((N_BENCH, 1), generator=gen, device="cuda") * 20.0 - 10.0
    alpha = torch.randn(N_BENCH, generator=gen, device="cuda") * 0.1
    for s in (1, 8, 64, 128):
        z = _rademacher(torch, (N_BENCH, s), gen)
        u = torch.randn((N_BENCH, s), generator=gen, device="cuda") * 0.1
        out["probe_ms"][f"s{s}"] = time_ms(
            torch, lambda: clg.logml_probe_grads(kern, x, alpha, u, z), reps=10)
        out["probe_bound_ms"][f"s{s}"] = [_probe_bound(N_BENCH, s)[0],
                                          _probe_bound_fp32(N_BENCH, s)[0]]
    mk = _families(gt)["matern52+white"]
    x3 = torch.rand((N_BENCH, 3), generator=gen, device="cuda") * 20.0 - 10.0
    u3 = x3 / torch.tensor(ELL3, device="cuda")
    z = _rademacher(torch, (N_BENCH, 64), gen)
    u = torch.randn((N_BENCH, 64), generator=gen, device="cuda") * 0.1
    out["probe_ms"]["matern52+white ard d3 s64"] = time_ms(
        torch, lambda: clg.logml_probe_grads(mk, u3, alpha, u, z, ard=True),
        reps=10)
    # logml_kernel_grads, whose epilogue the probe kernel shares: its times
    # at N = 16,384 and its outputs in hex, so two trees' runs compare bit
    # for bit
    _, mg = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, x, nugget=1e-3))
    cases = {"se+white": (kern, x, False), "matern52+white ard d3": (mk, u3, True)}
    out["grad_ms"], out["grad_outputs_hex"] = {}, {}
    for name, (gk, gx, ard) in cases.items():
        out["grad_ms"][name] = time_ms(torch, lambda: clg.logml_kernel_grads(
            gk, gx, alpha, mg, ard=ard), reps=5)
        out["grad_outputs_hex"][name] = [v.hex() for v in _outputs(
            gt, clg.logml_kernel_grads(gk, gx, alpha, mg, ard=ard))]
    for d in (1, 2):
        xd = torch.rand((N_BENCH, d), generator=gen, device="cuda") * 20.0 - 10.0
        for name, fk in _families(gt).items():
            out["gram_ms"][f"{name} d{d}"] = time_ms(
                torch, lambda: cuda_gram.gram_cuda(fk, xd, nugget=1e-3), reps=10)
    out["fill_ms"] = time_ms(torch, lambda: torch.empty(
        (N_BENCH, N_BENCH), device="cuda").fill_(1.0), reps=10)
    out["gram_bound_ms"] = bound_ms(nbytes=4.0 * N_BENCH * N_BENCH)[0]
    l1 = _gram_l1_only(torch)
    if l1 is not None:  # the Gram's two coordinate paths, in turns
        tree = _build.function("gram", "gpx_gram", cuda_gram._ARGS)
        out["gram_paths_ms"] = {}
        for d in (9, 10, 11, 12, 20):
            xd = torch.rand((N_BENCH, d), generator=gen, device="cuda") * 4.0 - 2.0
            for name, fn in (("staged", tree), ("l1", l1), ("l1", l1),
                             ("staged", tree)):
                _build._fns[("gram", "gpx_gram")] = fn
                out["gram_paths_ms"].setdefault(f"se+white d{d} {name}", []).append(
                    time_ms(torch, lambda: cuda_gram.gram_cuda(kern, xd, nugget=1e-3),
                            reps=10))
        _build._fns[("gram", "gpx_gram")] = tree
    del x, x3, u3, u, z, mg
    torch.cuda.empty_cache()

    params, xb, yb = _bench_case_cuda(torch, gt)
    alpha_b, (u_p, z_p), (u_a, z_a) = _hybrid_probe_inputs(
        torch, gt, gp, params.kernel, xb, yb)
    bk = params.kernel
    out["hybrid_probe_stage_ms"] = {
        "s64": time_ms(torch, lambda: clg.logml_probe_grads(bk, xb, alpha_b, u_p, z_p),
                       reps=10),
        "s128_aug": time_ms(torch, lambda: clg.logml_probe_grads(
            bk, xb, alpha_b, u_a, z_a), reps=10)}
    out["hybrid_probe_stage_ms"]["both"] = sum(out["hybrid_probe_stage_ms"].values())
    del alpha_b, u_p, z_p, u_a, z_a
    torch.cuda.empty_cache()
    out["hybrid_ms_per_eval"] = _median_ms(torch, lambda: gp.logml_value_and_grad(
        params, xb, yb, method="hybrid", probes=64))
    out["exact_ms_per_eval"] = _median_ms(torch, lambda: gp.logml_value_and_grad(
        params, xb, yb))
    print("kernel_times: " + json.dumps(out), flush=True)
    return out


def _dense_gram64(torch, kernel, x, nugget, block=4096):
    """K(x, x) + nugget I in float64, built in row blocks (the duplicate
    of a point in its own row has r2 == 0 exactly, so White fires)."""
    from gpx_torch.ops.cuda_gram import gram_reference

    n = x.shape[0]
    k = torch.empty((n, n), dtype=torch.float64, device=x.device)
    for i in range(0, n, block):
        k[i:i + block] = gram_reference(kernel, x[i:i + block], x)
    k.diagonal().add_(nugget)
    return k


def _dense_logml64(torch, gt, x, y, nugget, k64=None):
    """The dense float64 logML, its kernel gradient (sum_ij W_ij dK_ij /
    dtheta with W = (alpha alpha^T - K^-1) / 2, by autograd of the Gram's
    row blocks) and alpha = K^-1 y; K takes 8 GiB at N = 32,768. The
    kernel is the example's SE + White unless ``k64`` is given."""
    from gpx_torch.ops.cuda_gram import gram_reference

    k64 = _iter_kernel(gt, torch.float64) if k64 is None else k64
    x64, y64 = x.double(), y.double()
    n = x.shape[0]
    lmat = torch.linalg.cholesky(_dense_gram64(torch, k64, x64, nugget))
    alpha = torch.cholesky_solve(y64[:, None], lmat)[:, 0]
    value = (-0.5 * float(y64 @ alpha) - float(torch.log(lmat.diagonal()).sum())
             - 0.5 * n * math.log(2.0 * math.pi))
    w = torch.cholesky_inverse(lmat)
    del lmat
    w.mul_(-0.5).addr_(alpha, alpha, alpha=0.5)
    leaves = [t.detach().requires_grad_() for t in gt.params.leaves(k64)]
    kern = gt.params.unflatten(k64, leaves)
    grads = [0.0] * len(leaves)
    with torch.enable_grad():
        for i in range(0, n, 4096):
            kb = gram_reference(kern, x64[i:i + 4096], x64)
            g = torch.autograd.grad(torch.sum(w[i:i + 4096] * kb), leaves)
            grads = [a + float(b) for a, b in zip(grads, g)]
    del w
    return value, grads, alpha


def _iter_noise(torch, gi, seed, n, s):
    """The base noise logml_value_and_grad_iterative draws from a
    generator seeded ``seed``: the Rademacher probe base, then the Normal
    SLQ base (with a preconditioner), float32, in that order."""
    key = torch.Generator(device="cuda").manual_seed(seed)
    return (gi._rademacher(key, (n, s), torch.float32, "cuda"),
            gi._normal(key, (n, s), torch.float32, "cuda"))


def _flat(gt, res):
    return [float(res.value)] + [float(t) for t in gt.params.leaves(res.grads.kernel)]


def _hold_logml(label, got, f64, dense, names=("value", "h", "sigma", "white"),
                kinds=("value", "h", "sigma", "white"), witness=None):
    """One seed's float32 result against the dense float64 logML and
    against the same estimator in float64 on the same noise.

    Dense limits, the JAX package's own tests of this path
    (test_iterative.py): value within 5e-3 |value| + 0.5, every kernel
    gradient within 0.3 |g| + 0.5. They bound the estimator's error at 8
    probes as much as the port's: where the float32 result misses one and
    the float64 run of the same estimator misses it too, the miss is the
    estimator's variance, and the limit becomes twice the float64 run's
    error.

    Against the same estimator in float64 (the port's float32 rounding
    alone): the float32 envelope the JAX package recorded at N = 16k
    (PERF_TPU.md: value 7.9e-5 relative; gradients 6.5e-6 White, 5.5e-3
    sigma relative, 0.25 absolute on h, a near-cancellation), rounded up
    as phase 3 holds the exact path: value 1e-4 relative; h 0.5 absolute;
    sigma 1e-2 and White 1e-3 relative (the probe solves stop at an
    absolute cg_tol, 1e-4 against the probes' norm of ~180), each relative
    to the larger of the float64 estimate and the dense value. ``names``
    label the outputs and ``kinds`` give each its limit: the value, the
    amplitude ("h"), the lengthscale ("sigma") and White, in that order for
    the SE and Matern runs (Matern's sigma and l hold as SE's h and sigma);
    "other" (F3's leaves) takes the exact path's envelope, 1e-2 relative
    or 0.5 absolute, whichever is larger. ``witness``: the same estimator
    in float32 with the matvec's plain TF32 version, on the same noise;
    where it is
    further from the float64 run than the limit, the limit becomes twice
    its distance (float32's own rounding of the estimator, as _hold takes
    the float32 plain version)."""
    worst = {}
    for i, (nm, kind) in enumerate(zip(names, kinds)):
        g, w, d = got[i], f64[i], dense[i]
        limit = (5e-3 * abs(d) + 0.5) if i == 0 else (0.3 * abs(d) + 0.5)
        e32, e64 = abs(g - d), abs(w - d)
        why = "JAX tests' limit"
        if e32 > limit and e64 > limit:
            limit, why = 2.0 * e64, "2 x the float64 estimator's error (variance at 8 probes)"
        same = abs(g - w)
        mag = max(abs(w), abs(d))  # a noisy estimate may sit near zero
        same_limit = {"value": 1e-4 * mag, "h": 0.5, "sigma": 1e-2 * mag,
                      "white": 1e-3 * mag,
                      "other": max(1e-2 * mag, 0.5)}[kind]
        wit = "" if witness is None else (
            f"; float32 plain-TF32 witness {abs(witness[i] - w):.3e}")
        if witness is not None:
            same_limit = max(same_limit, 2.0 * abs(witness[i] - w))
        print(f"{label} {nm}: f32 {g:.8e} f64-estimator {w:.8e} dense-f64 {d:.8e}"
              f" | f32-dense {e32:.3e} (limit {limit:.3e}, {why}); f64-dense "
              f"{e64:.3e}; f32-f64 same noise {same:.3e} (limit {same_limit:.3e})"
              f"{wit}", flush=True)
        check(math.isfinite(g), f"{label} {nm}: not finite")
        check(e32 <= limit, f"{label} {nm}: outside the dense limit")
        check(same <= same_limit, f"{label} {nm}: float32 differs from the "
              f"same estimator in float64")
        worst[nm] = {"dense": e32, "f64_estimator": same}
    return worst


def phase_iterative(torch, gt, records):
    """The matrix-free path at examples/large_n.py's case: kernel checks,
    the logML against float64 (three seeds), fit_iterative against a dense
    float64 posterior, the N = 131,072 run, launch counts, stage times and
    ms/eval."""
    from gpx_torch.models import gp, gp_iterative as gi
    from gpx_torch.ops import cuda_matvec as cm
    from gpx_torch.ops.matvec import cross_matvec, gram_matvec

    out = {"kernels": _matvec_checks(torch, gt, records)}
    torch.cuda.empty_cache()
    x_np, y_np = _iter_case(N_IT)
    params = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt))
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    nug = gp.LOGML_NUGGET

    # -- one eval of the logML through the public entry point, counted; on
    # the card from numpy arrays, which go to the card by default ---------
    res, counts = _count(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x_np, y_np, torch.Generator(device="cuda").manual_seed(0), **ITER))
    print(f"iterative logML n={N_IT} launches: {json.dumps(counts)}; CG "
          f"{res.cg_iters} iterations, converged {res.cg_converged}", flush=True)
    check(counts["gram_matvec"] > 0, "gram_matvec was not launched in the logML")
    check(counts["torch_route_calls"] == 2, "the logML called the torch route of "
          "the matvec other than twice (the gradient contraction)")
    records["gram_matvec"]["launches"] = counts["gram_matvec"]
    out["logml_launches"] = counts

    # -- the logML against float64, three seeds -------------------------
    dense_v, dense_g, alpha64 = _dense_logml64(torch, gt, x, y, nug)
    dense = [dense_v] + dense_g
    quad64 = float(y.double() @ alpha64)
    a_norm = float(torch.linalg.vector_norm(alpha64))
    del alpha64
    torch.cuda.empty_cache()
    p64 = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt, torch.float64))
    worst = {}
    for seed in (0, 1, 2):
        key = torch.Generator(device="cuda").manual_seed(seed)
        r32 = gi.logml_value_and_grad_iterative(params, x, y, key, **ITER)
        check(r32.cg_converged, f"seed {seed}: CG did not converge")
        pn, sn = _iter_noise(torch, gi, seed, N_IT, ITER["n_probes"])
        core = dict(lanczos_iters=ITER["lanczos_iters"], cg_tol=ITER["cg_tol"],
                    precond_rank=ITER["precond_rank"])
        if seed == 0:  # the replayed noise is the public function's
            again = gi._logml_value_and_grad_iterative(
                params, x, y, probe_noise=pn, slq_noise=sn, **core)
            check(_flat(gt, again) == _flat(gt, r32), "replayed noise differs")
        r64 = gi._logml_value_and_grad_iterative(
            p64, x.double(), y.double(), probe_noise=pn.double(),
            slq_noise=sn.double(), **core)
        print(f"seed {seed}: CG iterations f32 {r32.cg_iters} f64 {r64.cg_iters}",
              flush=True)
        for nm, e in _hold_logml(f"logml n={N_IT} seed {seed}", _flat(gt, r32),
                                 _flat(gt, r64), dense).items():
            w = worst.setdefault(nm, {"dense": 0.0, "f64_estimator": 0.0})
            for k in w:
                w[k] = max(w[k], e[k])
    out["logml_worst"] = worst

    # alpha's backward error is held to one f32 ulp (see _scale_run).
    # The quadratic term: CG stops when every column's recursive residual
    # is within cg_tol, and alpha's error in y^T alpha is r^T alpha64 with r
    # = y - K alpha the true residual: cg_tol ||alpha64|| were the true
    # residual at the tolerance. Allow twice that. In float32 the true
    # residual stays at the float32 floor (printed, ~2e-2 here, far above
    # cg_tol), but its rounding noise is uncorrelated with alpha64, so the
    # product stays near the tolerance's share
    pn, _ = _iter_noise(torch, gi, 0, N_IT, ITER["n_probes"])
    a32, iters, conv, cg_ms = _cg_stage(torch, gi, params, x, y, pn)
    quad32 = float(y.double() @ a32.double())
    res_true = _true_residual(torch, gt, x, y, a32, nug)
    q_limit = 2.0 * ITER["cg_tol"] * a_norm
    print(f"quadratic term n={N_IT}: f32 {quad32:.8e} f64 {quad64:.8e} err "
          f"{abs(quad32 - quad64):.3e} (limit 2 cg_tol ||alpha|| = {q_limit:.3e});"
          f" true residual of alpha {res_true[0]:.3e} ({res_true[1]:.3e} of "
          f"||y||; backward error {res_true[2] / EPS32:.3f} f32 ulps), formed "
          f"in float64", flush=True)
    check(abs(quad32 - quad64) <= q_limit, "quadratic term outside its limit")
    check(res_true[2] <= EPS32, "alpha: backward error above one f32 ulp")
    out["quad_err"] = abs(quad32 - quad64)
    out["alpha_true_residual_n32768"] = res_true
    torch.cuda.empty_cache()

    # -- fit_iterative against a dense float64 posterior -----------------
    xs = torch.linspace(-10.0, 10.0, N_TEST, device="cuda")[:, None]
    fit_opts = dict(cg_tol=ITER["cg_tol"], precond_rank=ITER["precond_rank"],
                    variance="exact", variance_block=256)
    post, counts = _count(torch, lambda: gi.fit_iterative(params, x, y, xs,
                                                          **fit_opts))
    print(f"fit_iterative n={N_IT} -> {N_TEST} launches: {json.dumps(counts)}; "
          f"CG {post.cg_iters} iterations, converged {post.cg_converged}",
          flush=True)
    for name in ("gram_matvec", "cross_matvec", "gram"):
        check(counts[name] > 0, f"fit_iterative did not launch {name}")
    check(counts["torch_route_calls"] == 0, "fit_iterative called the torch route")
    check(post.cg_converged, "fit_iterative: CG did not converge")
    records["cross_matvec"]["launches"] = counts["cross_matvec"]
    out["fit_launches"] = counts
    out["fit_err"] = _hold_fit(torch, gt, gi, params, x, y, xs, post, fit_opts)
    torch.cuda.empty_cache()

    # -- Matern 3/2 + White: one counted eval (seed 0) against the dense
    # float64 logML and the same estimator in float64; ms/eval ----------
    out["matern32"] = _iter_matern_run(torch, gt, gi, x, y, nug)
    torch.cuda.empty_cache()
    out["f3"] = _iter_f3_run(torch, gt, gi, x, y, nug)
    torch.cuda.empty_cache()

    # -- stand-alone stages at N = 32,768, each counted ------------------
    out["stages_ms"] = _iter_stages(torch, gt, gi, cm, params, x, y, xs, pn, iters,
                                    cg_ms, gram_matvec, cross_matvec)

    # -- ms/eval ---------------------------------------------------------
    key = torch.Generator(device="cuda").manual_seed(0)
    out["logml_ms_per_eval"] = _median_ms(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x, y, key, **ITER))
    out["fit_ms_per_eval"] = _median_ms(torch, lambda: gi.fit_iterative(
        params, x, y, xs, **fit_opts))
    print(f"iterative n={N_IT}: logML ms/eval {out['logml_ms_per_eval'][0]:.2f} "
          f"{out['logml_ms_per_eval'][1]}; fit_iterative ms/eval "
          f"{out['fit_ms_per_eval'][0]:.2f} {out['fit_ms_per_eval'][1]} (median "
          f"of 5, CUDA events)", flush=True)
    del x, y, xs
    torch.cuda.empty_cache()
    out["scale"] = _scale_run(torch, gt, gi)
    return out


def _iter_matern_run(torch, gt, gi, x, y, nug):
    """logml_value_and_grad_iterative at N = 32,768 with Matern(2, 3/2, 3)
    + White(0.5) on the example's data: the CUDA matvec by its launches,
    _hold_logml for seed 0, and ms/eval."""
    params = gt.Parameters(mean=gt.zero(), kernel=_iter_matern(gt))
    res, counts = _count(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x, y, torch.Generator(device="cuda").manual_seed(0), **ITER))
    print(f"iterative logML matern32+white n={N_IT} launches: "
          f"{json.dumps(counts)}; CG {res.cg_iters} iterations, converged "
          f"{res.cg_converged}", flush=True)
    check(counts["gram_matvec"] > 0 and counts["torch_route_calls"] == 2,
          "the Matern logML did not run on the CUDA matvec")
    check(res.cg_converged, "Matern logML: CG did not converge")
    dense_v, dense_g, _ = _dense_logml64(torch, gt, x, y, nug,
                                         _iter_matern(gt, torch.float64))
    torch.cuda.empty_cache()
    pn, sn = _iter_noise(torch, gi, 0, N_IT, ITER["n_probes"])
    p64 = gt.Parameters(mean=gt.zero(), kernel=_iter_matern(gt, torch.float64))
    r64 = gi._logml_value_and_grad_iterative(
        p64, x.double(), y.double(), probe_noise=pn.double(),
        slq_noise=sn.double(), lanczos_iters=ITER["lanczos_iters"],
        cg_tol=ITER["cg_tol"], precond_rank=ITER["precond_rank"])
    worst = _hold_logml(f"logml matern32+white n={N_IT} seed 0", _flat(gt, res),
                        _flat(gt, r64), [dense_v] + dense_g,
                        names=("value", "sigma", "l", "white"))
    key = torch.Generator(device="cuda").manual_seed(0)
    eval_ms = _median_ms(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x, y, key, **ITER))
    print(f"iterative matern32+white n={N_IT}: value {float(res.value):.8e}; "
          f"logML ms/eval {eval_ms[0]:.2f} {eval_ms[1]} (median of 5, CUDA "
          f"events)", flush=True)
    return {"value": float(res.value), "launches": counts, "worst": worst,
            "ms_per_eval": eval_ms}


def _iter_f3_run(torch, gt, gi, x, y, nug):
    """One logml_value_and_grad_iterative at N = 32,768 with F3 (_f3) on
    the example's data: the CUDA matvec by its launches, _hold_logml for
    seed 0 with every leaf held as "other" but White, and the eval's ms."""
    params = gt.Parameters(mean=gt.zero(), kernel=_f3(gt))
    t0 = time.perf_counter()
    res, counts = _count(torch, lambda: gi.logml_value_and_grad_iterative(
        params, x, y, torch.Generator(device="cuda").manual_seed(0), **ITER))
    eval_s = time.perf_counter() - t0
    print(f"iterative logML {F3} n={N_IT} launches: {json.dumps(counts)}; CG "
          f"{res.cg_iters} iterations, converged {res.cg_converged}; "
          f"{1e3 * eval_s:.1f} ms (one eval, host clock)", flush=True)
    check(counts["gram_matvec"] > 0 and counts["torch_route_calls"] == 2,
          "the F3 logML did not run on the CUDA matvec")
    check(res.cg_converged, "F3 logML: CG did not converge")
    k64 = _f3(gt, torch.float64)
    dense_v, dense_g, _ = _dense_logml64(torch, gt, x, y, nug, k64)
    torch.cuda.empty_cache()
    pn, sn = _iter_noise(torch, gi, 0, N_IT, ITER["n_probes"])
    r64 = gi._logml_value_and_grad_iterative(
        gt.Parameters(mean=gt.zero(), kernel=k64), x.double(), y.double(),
        probe_noise=pn.double(), slq_noise=sn.double(),
        lanczos_iters=ITER["lanczos_iters"], cg_tol=ITER["cg_tol"],
        precond_rank=ITER["precond_rank"])
    # the witness: the same estimator and noise in float32, its matvec the
    # kernel's arithmetic in torch (the plain TF32 version), so that what
    # float32 does to CG and Lanczos shows apart from the kernel
    from gpx_torch.ops import cuda_matvec as cm
    from gpx_torch.ops import matvec as tmv
    route, plain = tmv._uses_cuda_kernel, tmv._gram_matvec_torch
    tmv._uses_cuda_kernel = lambda kernel, x_: False
    tmv._gram_matvec_torch = cm._gram_matvec_tf32x3_torch
    try:
        w32 = gi._logml_value_and_grad_iterative(
            params, x, y, probe_noise=pn, slq_noise=sn,
            lanczos_iters=ITER["lanczos_iters"], cg_tol=ITER["cg_tol"],
            precond_rank=ITER["precond_rank"])
    finally:
        tmv._uses_cuda_kernel, tmv._gram_matvec_torch = route, plain
    print(f"F3 iterative CG iterations: f32 {res.cg_iters}, f64 {r64.cg_iters}, "
          f"f32 plain TF32 version {w32.cg_iters}", flush=True)
    names = ["value"] + gt.params.names(k64)
    kinds = ["value"] + ["white" if k == "white" else "other"
                         for k in _leaf_kinds(gt, k64)]
    worst = _hold_logml(f"logml {F3} n={N_IT} seed 0", _flat(gt, res),
                        _flat(gt, r64), [dense_v] + dense_g, names=names,
                        kinds=kinds, witness=_flat(gt, w32))
    return {"value": float(res.value), "launches": counts, "worst": worst,
            "cg_iters": res.cg_iters, "ms_one_eval_host": 1e3 * eval_s}


def _hold_fit(torch, gt, gi, params, x, y, xs, post, fit_opts):
    """fit_iterative against the dense float64 posterior (PREDICT_NUGGET).

    The example's float32 x holds coincident points (8 pairs at N =
    32,768). White fires on them, so with the nugget of 1e-6 alpha = K^-1 y
    carries components of |dy| / (2 nugget) ~ 5e5 along each pair's
    difference. K(xs, .) cancels them exactly, but not their float32
    rounding (an ulp of 5e5 is 0.03, and the float32 nugget on 2.5 is 4
    ulps): that reaches the mean near each pair. So on this data each
    output is held to 2e-3 plus 4 f32 ulps of its sum of |terms| over the
    pair points, sum_{j in pairs} |K(s, x_j)| |alpha_j|; at rows away from
    the pairs that is 2e-3 against an output of scale 1. A witness shows
    that the miss near the pairs is float32's in the algorithm, not the
    kernel's: the same preconditioned solve and cross product in float32
    through the plain torch route misses those rows too, and the kernel's
    miss there is held to twice the witness's plus 2e-3. On the
    same data with the coincident points merged (alpha then has no such
    components) the mean is held to 2e-3 everywhere: alpha's true residual
    (the float32 floor, ~2e-2) through predictive weights of 2-norm ~1e-2
    gives ~1e-4. Variance on both: 1e-4 against an output of ~0.5 (noise
    plus a small posterior variance); each column is solved to cg_tol,
    ~1e-6 expected."""
    from gpx_torch.models import gp
    from gpx_torch.ops import cuda_matvec as cm
    from gpx_torch.ops.matvec import gram_matvec

    nug = gp.PREDICT_NUGGET
    kern = params.kernel
    same = x[1:, 0] == x[:-1, 0]
    pairs = int(same.sum())
    in_pair = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    in_pair[1:] |= same
    in_pair[:-1] |= same
    mean64, var64 = _dense_posterior64(torch, gt, x, y, xs, nug)
    pc = gi._preconditioner(kern, x, ITER["precond_rank"], nug)
    alpha, _, _ = gi.cg_solve(lambda v: gram_matvec(kern, x, v, nugget=nug), y,
                              tol=ITER["cg_tol"], precond=pc)
    c = x.mean(dim=0, keepdim=True)
    xc, xsc = x - c, xs - c
    pair_terms = cm._cross_matvec_torch(
        _iter_kernel(gt, torch.float64), xsc.double(), xc.double(),
        (alpha.double().abs() * in_pair)[:, None])[:, 0]
    limit = 2e-3 + 4 * EPS32 * pair_terms
    near = 4 * EPS32 * pair_terms > 2e-3          # rows the pairs dominate
    m_err = (post.mean.double() - mean64).abs()
    v_err = float((post.variance.double() - var64).abs().max())
    # the witness: the same algorithm in float32 through the plain route
    a_w, _, _ = gi.cg_solve(lambda v: cm._gram_matvec_torch(kern, xc, v, nug), y,
                            tol=ITER["cg_tol"], precond=pc)
    w_err = (cm._cross_matvec_torch(kern, xsc, xc, a_w[:, None])[:, 0].double()
             - mean64).abs()

    def worst(err, rows):
        return float(err[rows].max()) if bool(rows.any()) else 0.0

    print(f"fit_iterative n={N_IT} ({pairs} coincident pairs) against dense "
          f"float64: mean max abs err {float(m_err.max()):.3e} (scale "
          f"{float(mean64.abs().max()):.3f}; limit 2e-3 + 4 ulps of sum over "
          f"the pair points |K||alpha|, largest {float(limit.max()):.3e}, worst "
          f"use {float((m_err / limit).max()):.3f}); {int(near.sum())} rows near "
          f"the pairs: kernel {worst(m_err, near):.3e}, float32 plain-route "
          f"witness {worst(w_err, near):.3e}; {int((~near).sum())} rows away: "
          f"kernel {worst(m_err, ~near):.3e}, witness {worst(w_err, ~near):.3e} "
          f"(limit 2e-3); |alpha| max {float(alpha.abs().max()):.3e}; variance "
          f"max abs err {v_err:.3e} (limit 1e-4; range {float(var64.min()):.6f} "
          f".. {float(var64.max()):.6f})", flush=True)
    check(bool((m_err <= limit).all()), "fit_iterative mean outside its limit")
    check(worst(m_err, near) <= 2.0 * worst(w_err, near) + 2e-3,
          "fit_iterative mean misses more near the pairs than twice the "
          "float32 plain route does")
    check(v_err <= 1e-4, "fit_iterative variance outside its limit")
    out = {"pairs": pairs, "mean": float(m_err.max()), "variance": v_err,
           "mean_near_pairs": worst(m_err, near),
           "witness_near_pairs": worst(w_err, near),
           "mean_away": worst(m_err, ~near), "witness_away": worst(w_err, ~near)}
    del mean64, var64, pair_terms, limit

    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[1:] = x[1:, 0] != x[:-1, 0]
    xu, yu = x[keep], y[keep]
    post = gi.fit_iterative(params, xu, yu, xs, **fit_opts)
    check(post.cg_converged, "fit_iterative (merged points): CG did not converge")
    mean64, var64 = _dense_posterior64(torch, gt, xu, yu, xs, nug)
    mu_err = float((post.mean.double() - mean64).abs().max())
    vu_err = float((post.variance.double() - var64).abs().max())
    print(f"fit_iterative n={xu.shape[0]} (coincident points merged) against dense "
          f"float64: mean max abs err {mu_err:.3e} (limit 2e-3), variance max abs "
          f"err {vu_err:.3e} (limit 1e-4); CG {post.cg_iters} iterations", flush=True)
    check(mu_err <= 2e-3, "fit_iterative mean (merged points) outside 2e-3")
    check(vu_err <= 1e-4, "fit_iterative variance (merged points) outside 1e-4")
    out.update(merged_mean=mu_err, merged_variance=vu_err)
    return out


def _cg_stage(torch, gi, params, x, y, pn):
    """The logML's CG batch on its own (alpha and the 8 preconditioned
    probes, as the eval solves them): returns (alpha, iterations,
    converged, ms), the time by CUDA events."""
    from gpx_torch.models import gp
    from gpx_torch.ops.matvec import gram_matvec

    pc = gi._preconditioner(params.kernel, x, ITER["precond_rank"], gp.LOGML_NUGGET)
    rhs = torch.cat([y[:, None], pc.root(pn)], dim=1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sol, iters, conv = gi.cg_solve(
        lambda v: gram_matvec(params.kernel, x, v, nugget=gp.LOGML_NUGGET), rhs,
        tol=ITER["cg_tol"], max_iters=1000, precond=pc)
    end.record()
    torch.cuda.synchronize()
    return sol[:, 0], iters, conv, start.elapsed_time(end)


def _true_residual(torch, gt, x, y, alpha, nugget):
    """``(||r||, ||r|| / ||y||, eta)`` for the true residual r = y - (K +
    nugget I) alpha, formed in float64 through the plain row-blocked
    matvec, with eta = ||r|| / (|| |K + nugget I| |alpha| || + ||y||) the
    normwise backward error of alpha as a solution (K >= 0 here)."""
    from gpx_torch.ops import cuda_matvec as cm

    k64 = _iter_kernel(gt, torch.float64)
    x64 = x.double() - x.double().mean(dim=0, keepdim=True)
    a64 = alpha.double()[:, None]
    r = y.double() - cm._gram_matvec_torch(k64, x64, a64, nugget)[:, 0]
    rn = float(torch.linalg.vector_norm(r))
    yn = float(torch.linalg.vector_norm(y.double()))
    ka = float(torch.linalg.vector_norm(cm._gram_matvec_torch(k64, x64, a64.abs(),
                                                               nugget)))
    return rn, rn / yn, rn / (ka + yn)


def _dense_posterior64(torch, gt, x, y, xs, nugget):
    """The dense float64 posterior mean and variance at ``xs`` (Cholesky on
    the card)."""
    from gpx_torch.ops.cuda_gram import gram_reference

    k64 = _iter_kernel(gt, torch.float64)
    x64, xs64 = x.double(), xs.double()
    lmat = torch.linalg.cholesky(_dense_gram64(torch, k64, x64, nugget))
    alpha = torch.cholesky_solve(y.double()[:, None], lmat)[:, 0]
    kxs = gram_reference(k64, x64, xs64)                       # (n, m)
    mean = kxs.T @ alpha
    v = torch.linalg.solve_triangular(lmat, kxs, upper=False)
    var = torch.clamp_min(k64.diag(xs64) - torch.sum(v * v, dim=0), 0.0)
    return mean, var


def _iter_stages(torch, gt, gi, cm, params, x, y, xs, pn, iters, cg_ms,
                 gram_matvec, cross_matvec):
    """Stand-alone times of the logML's and the fit's stages at N = 32,768,
    and the torch route's calls in CG, PCG and Lanczos (must be 0)."""
    from gpx_torch.models import gp

    nug = gp.LOGML_NUGGET
    kern = params.kernel

    def matvec(v):
        return gram_matvec(kern, x, v, nugget=nug)

    pc = gi._preconditioner(kern, x, ITER["precond_rank"], nug)
    z = pc.root(pn)
    s = ITER["n_probes"]
    (_, cg_iters, _, _), c_cg = _count(torch, lambda: _cg_stage(torch, gi, params,
                                                                 x, y, pn))
    _, c_pcg = _count(torch, lambda: gi._pcg_tridiag(matvec, z, ITER["lanczos_iters"],
                                                     pc))
    _, c_lz = _count(torch, lambda: gi.slq_logdet(
        matvec, N_IT, torch.Generator(device="cuda").manual_seed(0), n_probes=s,
        m=ITER["lanczos_iters"]))
    for label, c in (("CG", c_cg), ("PCG", c_pcg), ("Lanczos", c_lz)):
        check(c["torch_route_calls"] == 0, f"{label} called the torch route")
        check(c["gram_matvec"] > 0, f"{label} did not launch gram_matvec")
    alpha = torch.randn(N_IT, device="cuda")
    w = torch.randn((N_IT, s), device="cuda")

    def contraction():
        kl = [t.detach().requires_grad_() for t in gt.params.leaves(kern)]
        with torch.enable_grad():
            k2 = gt.params.unflatten(kern, kl)
            quad = alpha @ cm._gram_matvec_torch(k2, x, alpha[:, None], nug)[:, 0]
            tr = torch.sum(w * cm._gram_matvec_torch(k2, x, w, nug))
            return torch.autograd.grad(0.5 * quad - 0.25 * tr, kl)

    xc = x - x.mean(dim=0, keepdim=True)
    v9 = torch.randn((N_IT, s + 1), device="cuda")
    stages = {
        "preconditioner (pivoted Cholesky 64 + QR + eigh)": time_ms(
            torch, lambda: gi._preconditioner(kern, x, ITER["precond_rank"], nug),
            reps=3),
        "cg_solve (r = 9)": cg_ms,
        "cg_iterations": iters,
        "cg ms/iteration": cg_ms / max(iters, 1),
        "gram_matvec kernel alone (r = 9)": time_ms(
            torch, lambda: cm.gram_matvec_cuda(kern, xc, v9, nugget=nug), reps=10),
        "pcg_tridiag 32 steps (r = 8)": time_ms(
            torch, lambda: gi._pcg_tridiag(matvec, z, ITER["lanczos_iters"], pc),
            reps=3),
        "gradient contraction (torch route, 2 calls)": time_ms(torch, contraction,
                                                               reps=3),
        "cross_matvec (1024 x 32768, r = 1)": time_ms(
            torch, lambda: cross_matvec(kern, xs, x, alpha), reps=10),
    }
    print(f"iterative stages n={N_IT} (ms, stand-alone): {json.dumps(stages)}; "
          f"launches CG {json.dumps(c_cg)} PCG {json.dumps(c_pcg)} Lanczos "
          f"{json.dumps(c_lz)}", flush=True)
    check(cg_iters == iters, "the CG stage is not deterministic")
    return stages


def _scale_run(torch, gt, gi):
    """One timed eval at N = 131,072; its peak memory must stay below a
    quarter of the dense float32 K (64 GiB), which shows K never forms."""
    x_np, y_np = _iter_case(N_SCALE)
    params = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt))
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    key = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    res = gi.logml_value_and_grad_iterative(params, x, y, key, **ITER)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    dense = 4.0 * N_SCALE * N_SCALE
    pn, _ = _iter_noise(torch, gi, 0, N_SCALE, ITER["n_probes"])
    alpha, iters, conv, _ = _cg_stage(torch, gi, params, x, y, pn)
    res_true = _true_residual(torch, gt, x, y, alpha, 1e-3)
    print(f"scale n={N_SCALE}: one eval {secs:.2f} s; CG {res.cg_iters} "
          f"iterations, converged {res.cg_converged}; value {float(res.value):.6e}"
          f"; grads {[round(float(t), 4) for t in gt.params.leaves(res.grads.kernel)]}; "
          f"true residual of alpha (float64) {res_true[0]:.3e} = {res_true[1]:.3e} "
          f"of ||y||, backward error {res_true[2] / EPS32:.3f} f32 ulps; peak memory {peak / 2**30:.2f} GiB (limit a quarter of the "
          f"dense K, {dense / 4 / 2**30:.0f} GiB)", flush=True)
    check(math.isfinite(float(res.value)), "scale run: value not finite")
    check(res.cg_converged, "scale run: CG did not converge")
    check(peak < dense / 4, "scale run: peak memory reaches a quarter of the dense K")
    # CG's flag reads its recursive residual, as gpx's does; the true
    # residual of a float32 alpha cannot reach the absolute cg_tol here
    # (one f32 ulp of || |K| |alpha| || is ~0.5 at N = 32,768). Hold alpha's
    # backward error instead: within one f32 ulp is a solution to float32
    # precision (0.03-0.05 ulps measured on an H100)
    check(res_true[2] <= EPS32, "scale run: alpha's backward error above one ulp")
    return {"seconds": secs, "cg_iters": res.cg_iters,
            "cg_converged": res.cg_converged, "peak_gib": peak / 2**30,
            "alpha_true_residual": res_true}


# -- phase 5: the sampler slice ---------------------------------------------

N_SAMPLER = 4096      # benchmarks/sampler_scale.py --ess: the first fused n
TRUTH = (3.0, 5.5, 0.5)  # SE h, SE sigma, White sigma (sampler_scale.py)
# The JAX package's recorded fast-mode deviation at N = 16k (PERF_TPU.md,
# "Round-3 late": value 0.22%, White 0.12%, sigma 0.76% relative, h 18.6
# absolute): a TPU accuracy record, used here as the fast path's limit
# against float64.
FAST_LIMITS = {"value_rel": 2.2e-3, "white_rel": 1.2e-3, "sigma_rel": 7.6e-3,
               "h_abs": 20.0}


def _fast_trmm(torch, records):
    """trmm(fast=True) in both M21 modes against its TF32-rounding plain
    version (_hold_trmm, PRODUCT_ULPS) at 8192^2 and on ragged and
    unaligned views on both tile sizes; a repeated call bitwise; the check
    fails for a plain version that rounds the other operand; times beside
    the 3-pass leg's."""
    from gpx_torch.ops import cuda_trmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    n = 8192
    l = torch.randn((n, n), generator=gen, device=dev).tril_() / math.sqrt(n)
    l.diagonal().add_(2.0)
    b = torch.randn((n, n), generator=gen, device=dev)
    modes = (("right_lower", True), ("left_lower", False))
    err = max(_hold_trmm(torch, b, l, mode, neg, fast=True)
              for mode, neg in modes)
    for kn, mr in ((997, 500), (4999, 4997)):
        lr = l[:kn, :kn].contiguous()
        lv = _odd_view(torch, kn, kn, kn + 4, 1, gen)
        lv.copy_(lr)
        for mode, neg in modes:
            shape = (kn, mr) if mode == "left_lower" else (mr, kn)
            err = max(err, _hold_trmm(torch, b[:shape[0], :shape[1]].contiguous(),
                                      lr, mode, neg, fast=True))
            bv = _odd_view(torch, *shape, shape[1] + 3, 3, gen)
            err = max(err, _hold_trmm(
                torch, bv, lv, mode, neg, fast=True,
                out=_odd_view(torch, *shape, shape[1] + 5, 1, gen)))
    for mode, neg in modes:
        got = cuda_trmm.trmm(b, l, mode=mode, neg=neg, fast=True)
        check(torch.equal(got, cuda_trmm.trmm(b, l, mode=mode, neg=neg,
                                              fast=True)),
              f"trmm {mode} fast: a repeated call differs")
        # the wrong operand rounded: the check must tell it from the kernel
        b64, l64 = b.double(), l.double()
        r64 = cuda_trmm.round_tf32(b64)
        wrong = (-(r64 @ l64) if mode == "right_lower" else
                 cuda_trmm.round_tf32(l64) @ b64)
        scale = cuda_trmm.trmm_reference(b64.abs(), l64.abs(), mode=mode)
        worst = float(((got.double() - wrong).abs() / scale).max()) / EPS32
        print(f"trmm {mode} fast against a plain version rounding the other "
              f"operand: {worst:.1f} f32 ulps of its sum of |terms| (the "
              f"check's limit {PRODUCT_ULPS:g})", flush=True)
        check(worst > PRODUCT_ULPS, f"trmm {mode} fast: the check cannot tell "
              f"which operand is rounded")
        del got, wrong, r64
    ms = {}
    for leg in ("fast", "exact", "exact", "fast"):
        ms.setdefault(leg, []).append(time_ms(torch, lambda: cuda_trmm.trmm(
            b, l, mode="right_lower", fast=leg == "fast")))
    plain = time_ms(torch, lambda: cuda_trmm.trmm_reference(
        b, l, mode="right_lower", fast=True))
    bound = bound_ms(tf32_flops=2.0 * n ** 3, nbytes=4.0 * (n * n * 2.5))
    print(f"trmm right_lower 8192^2 in turns: fast {ms['fast']} ms, 3-pass "
          f"{ms['exact']} ms; fast plain {plain:.3f} ms; 2-pass bound "
          f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    records["trmm"].update(fast_ms=min(ms["fast"]), fast_plain_ms=plain,
                           fast_bound_ms=bound[0], fast_max_abs_err=err,
                           fast_turns_ms={"fast": ms["fast"],
                                          "exact": ms["exact"]})
    del l, b
    torch.cuda.empty_cache()


def _fast_grads(torch, gt, records):
    """logml_kernel_grads(fast=True) against its TF32-rounding plain version
    under _hold at n = 4096, 4160 and 16,384 (SE + White) and F2's ARD leg
    at n = 4096 and 4160 (D = 3, with _hold's float32 witness as in phase
    2b); a repeated call bitwise; the check fails for a plain version that
    rounds the other operand; times beside the 3-pass leg's."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    kern = gt.se(3.0, 5.5) + gt.white(0.5)
    f2 = gt.matern(2.0, 2.5, 1.0) + gt.white(0.25)
    x = torch.rand((N_BENCH, 1), generator=gen, device=dev) * 20.0 - 10.0
    x3 = torch.rand((4160, 3), generator=gen, device=dev) * 20.0 - 10.0
    u3 = x3 / torch.tensor(ELL3, device=dev)
    err = 0.0
    for n in (4096, 4160, N_BENCH):
        xs = x[:n].contiguous()
        _, m = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, xs, nugget=1e-3))
        alpha = torch.randn(n, generator=gen, device=dev) * 0.1
        err = max(err, _hold_grads(torch, gt, kern, xs, alpha, m, fast=True))
        if n == 4096:
            us = u3[:n].contiguous()
            _, mu = cuda_chol.chol_inv(cuda_gram.gram_cuda(f2, us, nugget=1e-3))
            for nn in (4096, 4160):
                if nn == 4160:
                    us = u3.contiguous()
                    _, mu = cuda_chol.chol_inv(cuda_gram.gram_cuda(
                        f2, us, nugget=1e-3))
                au = torch.randn(nn, generator=gen, device=dev) * 0.1
                err = max(err, _hold_grads(torch, gt, f2, us, au, mu, ard=True,
                                           label="F2 ", witness=True,
                                           fast=True))
            del mu
    first = _outputs(gt, cuda_logml_grad.logml_kernel_grads(
        kern, x, alpha, m, fast=True))
    again = _outputs(gt, cuda_logml_grad.logml_kernel_grads(
        kern, x, alpha, m, fast=True))
    check(first == again, "logml_kernel_grads fast: a repeated call differs")
    # the other operand rounded (the first, li_i): its kinv is the
    # transpose of the fast one's, mirrored from the upper triangle
    args = (_f64_kernel(gt, kern), x.double(), alpha.double())
    m64 = m.double()
    p = cuda_logml_grad.round_tf32(m64).T @ m64
    wrong = _outputs(gt, cuda_logml_grad._contract_reference(
        *args, torch.tril(p) + torch.tril(p, -1).T, False))
    scales = _term_scales(torch, *args, m64.T @ m64)
    ratio = max(abs(g - w) / min(4.0 * EPS32 * s, 1e-2 * abs(w))
                for g, w, s in zip(first, wrong, scales))
    print(f"logml_kernel_grads n={N_BENCH} fast against a plain version "
          f"rounding the other operand: worst output at {ratio:.2f} of its "
          f"_hold limit", flush=True)
    check(ratio > 1.0, "logml_kernel_grads fast: the check cannot tell which "
          "operand is rounded")
    ms = {}
    for leg in ("fast", "exact", "exact", "fast"):
        ms.setdefault(leg, []).append(time_ms(
            torch, lambda: cuda_logml_grad.logml_kernel_grads(
                kern, x, alpha, m, fast=leg == "fast"), reps=3))
    plain = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads_reference(
        kern, x, alpha, m, fast=True), reps=3)
    bound = bound_ms(tf32_flops=2.0 * N_BENCH ** 3 / 3.0,
                     nbytes=4.0 * N_BENCH * N_BENCH / 2)
    print(f"logml_kernel_grads n={N_BENCH} in turns: fast {ms['fast']} ms, "
          f"3-pass {ms['exact']} ms; fast plain {plain:.3f} ms; 2-pass bound "
          f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    records["logml_kernel_grads"].update(
        fast_ms=min(ms["fast"]), fast_plain_ms=plain, fast_bound_ms=bound[0],
        fast_max_abs_err=err, fast_turns_ms={"fast": ms["fast"],
                                             "exact": ms["exact"]})
    del m
    torch.cuda.empty_cache()


def _fast_path(torch, gt, records):
    """The bench case (N = 16,384) through logml_value_and_grad(
    fast_gradients=True): chol_inv(fast=True)'s L bitwise fast=False's and
    M apart only in the outermost M21; the fast legs launched (2 trmm, 1
    gradient); every output within FAST_LIMITS against float64; the fast
    and exact ms/eval in turns; the outermost M21's two products and the
    gradient kernel, fast against 3-pass."""
    from gpx_torch.models import gp
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad, cuda_trmm

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-10.0, 10.0, size=(N_BENCH, 1))
                        .astype(np.float32), device="cuda")
    y = torch.as_tensor(rng.normal(size=N_BENCH).astype(np.float32),
                        device="cuda")
    params = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5) + gt.white(0.5))
    kmat = cuda_gram.gram_cuda(params.kernel, x, nugget=gp.LOGML_NUGGET)
    l, m = cuda_chol.chol_inv(kmat)
    lf, mf = cuda_chol.chol_inv(kmat, fast=True)
    h = cuda_chol._split(N_BENCH)
    rest = torch.ones_like(m, dtype=torch.bool)
    rest[h:, :h] = False
    m21_rel = rel_max(mf[h:, :h].double(), m[h:, :h].double())
    print(f"chol_inv fast n={N_BENCH}: L bitwise {torch.equal(l, lf)}; M "
          f"bitwise outside the outermost M21 {torch.equal(m[rest], mf[rest])}; "
          f"M21 max difference {m21_rel:.3e} of its largest entry", flush=True)
    check(torch.equal(l, lf), "chol_inv(fast=True): L differs")
    check(torch.equal(m[rest], mf[rest]),
          "chol_inv(fast=True): M differs outside the outermost M21")
    check(m21_rel > 0.0, "chol_inv(fast=True): the outermost M21 is the "
          "3-pass one")
    # the outermost M21's two products, fast against 3-pass, in turns
    l21, m11, m22 = l[h:, :h], m[:h, :h], m[h:, h:]
    out = torch.empty_like(l21)

    def m21(fast):
        t1 = cuda_trmm.trmm(l21, m11, mode="right_lower", neg=True, fast=fast)
        cuda_trmm.trmm(t1, m22, mode="left_lower", fast=fast, out=out)

    m21_ms = {}
    for leg in ("fast", "exact", "exact", "fast"):
        m21_ms.setdefault(leg, []).append(time_ms(
            torch, lambda: m21(leg == "fast"), reps=3))
    print(f"outermost M21 (two trmm, 8192^2) in turns: fast {m21_ms['fast']} "
          f"ms, 3-pass {m21_ms['exact']} ms", flush=True)
    del l, m, lf, mf, l21, m11, m22, out, kmat, rest
    torch.cuda.empty_cache()

    for c in (cuda_trmm.trmm, cuda_logml_grad.logml_kernel_grads):
        c.launches = c.fast_launches = 0
    value, grads = gp.logml_value_and_grad(params, x, y, fast_gradients=True)
    torch.cuda.synchronize()
    fast_launches = {"trmm": cuda_trmm.trmm.fast_launches,
                     "logml_kernel_grads":
                         cuda_logml_grad.logml_kernel_grads.fast_launches}
    print(f"fast path launches: {json.dumps(fast_launches)} (trmm "
          f"{cuda_trmm.trmm.launches} in all)", flush=True)
    check(fast_launches == {"trmm": 2, "logml_kernel_grads": 1},
          "the fast path did not take the 2-pass legs")
    for name, k in fast_launches.items():
        records[name]["fast_launches"] = k
    v64, g64 = _f64(torch, gt, gp, x, y)
    got = [float(t) for t in gt.params.leaves(grads)]
    want = [float(t) for t in gt.params.leaves(g64)]
    errs = {"value_rel": abs(float(value) - float(v64)) / abs(float(v64)),
            "h_abs": abs(got[0] - want[0]),
            "sigma_rel": abs(got[1] - want[1]) / abs(want[1]),
            "white_rel": abs(got[2] - want[2]) / abs(want[2])}
    print(f"fast path value {float(value):.8e} f64 {float(v64):.8e}; grads "
          f"(h, sigma, white) {got} f64 {want}; errors {json.dumps(errs)} "
          f"(limits {json.dumps(FAST_LIMITS)})", flush=True)
    check(all(math.isfinite(g) for g in [float(value), *got]),
          "fast path: not finite")
    for k, e in errs.items():
        check(e <= FAST_LIMITS[k], f"fast path: {k} {e:.3e} outside "
              f"{FAST_LIMITS[k]:g}")
    turns = {"fast": [], "exact": []}
    for leg in ("exact", "fast", "exact", "fast"):
        turns[leg].append(_median_ms(torch, lambda: gp.logml_value_and_grad(
            params, x, y, fast_gradients=leg == "fast"))[0])
    print(f"fast_mode_ms in turns (median of 5 each, CUDA events): fast "
          f"{turns['fast']}, exact {turns['exact']}", flush=True)
    return {"errors": errs, "fast_mode_ms": turns["fast"],
            "exact_ms_per_eval": turns["exact"], "m21_ms": m21_ms,
            "m21_max_rel": m21_rel}


def _sampler_data(torch, gt, n):
    """sampler_scale.py's --ess data at n: x sorted U(-10, 10) (numpy seed
    0; the JAX package's threefry draw has no torch counterpart), y drawn
    from SE(3.0, 5.5) + White(0.5) with the draw nugget 1e-3 by a float64
    Cholesky on the card, both float32."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-10.0, 10.0, size=n)).reshape(-1, 1)
    kern = gt.se(TRUTH[0], TRUTH[1], dtype=torch.float64) + gt.white(
        TRUTH[2], dtype=torch.float64)
    x64 = torch.as_tensor(x, device="cuda")
    k = kern.gram(x64, nugget=1e-3)
    z = torch.as_tensor(rng.normal(size=n), device="cuda")
    y = torch.linalg.cholesky(k) @ z
    return x64.float(), y.float()


def _log_prior(gt, torch, dtype=None):
    """sampler_scale.py's prior: Gamma(2, rate 0.5) on h, sigma and the
    White sigma."""
    from gpx_torch.distributions import Gamma

    pr = Gamma(torch.tensor(2.0, device="cuda", dtype=dtype),
               torch.tensor(0.5, device="cuda", dtype=dtype))

    def log_prior(p):
        a, b = p.kernel.kernels
        return pr.logpdf(a.h) + pr.logpdf(a.sigma) + pr.logpdf(b.sigma)

    return log_prior


def _map_template(gt):
    """sampler_scale.py's MAP template: SE(2, 2) + White(1)."""
    return gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 2.0)
                         + gt.white(1.0))


def _all_counters():
    counters = dict(_counters())
    counters.update(_iter_counters())
    return counters


def _counted(torch, fn):
    """``(fn(), wall seconds, launches)``: every kernel's launch counter
    set to 0 just before ``fn`` and read just after."""
    counters = _all_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: c.launches for k, c in counters.items()}


FUSED = ("gram", "trmm", "syrk_lower", "chol_inv_tile", "chol_inv_tile_off",
         "logml_kernel_grads")


def _hold_route(label, launches, launched, idle):
    """The route a part took, by its launch counts: every kernel of
    ``launched`` at least once, none of ``idle``."""
    print(f"{label} launches: {json.dumps(launches)}", flush=True)
    for k in launched:
        check(launches[k] > 0, f"{label}: {k} was not launched")
    for k in idle:
        check(launches[k] == 0, f"{label}: {k} was launched")


def _map_init(torch, gt, x, y, log_prior):
    """sampler_scale.py's MAP init at n: L-BFGS on the analytic route,
    60 steps from SE(2, 2) + White(1); its launches, logML evaluations
    per step and seconds."""
    from gpx_torch.models.optimize import optimize

    res, wall, launches = _counted(torch, lambda: optimize(
        _map_template(gt), x, y, log_prior=log_prior, steps=OPT_STEPS))
    _hold_route(f"MAP n={x.shape[0]}", launches, FUSED,
                ("logml_probe_grads",))
    evals = launches["logml_kernel_grads"]
    vals = res.values.double().cpu()
    check(bool(torch.isfinite(vals).all()), "MAP: non-finite trace")
    out = {"wall_s": wall, "evals": evals, "evals_per_step": evals / OPT_STEPS,
           "ms_per_step": 1e3 * wall / OPT_STEPS, "value": float(res.value),
           "grad_norm": float(res.grad_norm), "converged": res.converged,
           "params": [float(t) for t in _leaves(res.params)]}
    print(f"MAP n={x.shape[0]}: " + json.dumps(out), flush=True)
    return res, out


def _leaves(params):
    from gpx_torch.params import leaves

    return leaves(params)


def _recovery(torch, post, truth):
    """``(recovered, rows)``: each true value inside the pooled central
    98% of the draws, and the diagnostics summary."""
    from gpx_torch import diagnostics

    flat = post.flat.double().cpu()
    check(bool(torch.isfinite(flat).all()), "non-finite draws")
    rows = diagnostics.summary(flat, post.names)
    pooled = flat.reshape(-1, flat.shape[-1])
    q = torch.quantile(pooled, torch.tensor([0.01, 0.99], dtype=flat.dtype),
                       dim=0)
    return {nm: bool(q[0, j] <= truth[j] <= q[1, j])
            for j, nm in enumerate(post.names)}, rows


def _sampler(torch, gt, x, y, init, log_prior):
    """sample_hmc at sampler_scale.py's --ess recipe at n = 4096 (4 chains,
    eps=None by dual averaging with its diagonal mass window, 64 warmup,
    128 kept draws, l = 5, analytic gradients; init at the recipe's MAP,
    ``init``, with jitter 0.02): recovery, split-R-hat, accept rates, the
    fused route by launch counts, min ESS and ESS/s; then
    gradients="hybrid" on the same data (2 chains, unit mass, a fixed eps:
    the adapted chains' step along their stiffest direction, 32 draws) and
    one chain at N = 16,384 on the bench data (half that eps, 4 draws, l =
    3). The mass window is the recipe's: with unit mass, a step that the
    noise's posterior sd (~0.02 in log space) bounds crawls along h's
    (~0.5), and the chains missed the split-R-hat gate on the card."""
    from gpx_torch import diagnostics
    from gpx_torch.infer import sample_hmc

    truth = gt.Parameters(mean=gt.zero(), kernel=gt.se(TRUTH[0], TRUTH[1])
                          + gt.white(TRUTH[2]))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = sample_hmc(0, x, y, init, log_prior, 128, l=5, eps=None,
                      warmup_iters=64, adapt_mass=True, n_chains=4,
                      analytic_gradients=True, init_jitter=0.02)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print("sampler path launches (n = 4096): " + json.dumps(launches),
          flush=True)
    for name, k in launches.items():
        if name == "logml_probe_grads":
            check(k == 0, "the sampler launched the probe kernel")
        else:
            check(k > 0, f"{name} was not launched on the sampler path")
    flat = post.flat.double().cpu()
    check(bool(torch.isfinite(flat).all()), "sampler: non-finite draws")
    rows = diagnostics.summary(flat, post.names)
    print(diagnostics.format_summary(rows), flush=True)
    pooled = flat.reshape(-1, flat.shape[-1])
    q = torch.quantile(pooled, torch.tensor([0.01, 0.99], dtype=flat.dtype),
                       dim=0)
    recovered = {nm: bool(q[0, j] <= TRUTH[j] <= q[1, j])
                 for j, nm in enumerate(post.names)}
    accept = [float(a) for a in post.accept_rate]
    grads = launches["logml_kernel_grads"]
    min_ess = min(r["ess"] for r in rows.values())
    max_rhat = max(r["rhat"] for r in rows.values())
    out = {"wall_s": wall, "leapfrog_gradients": grads,
           "ms_per_gradient": 1e3 * wall / grads, "min_ess": min_ess,
           "ess_per_s": min_ess / wall, "max_rhat": max_rhat,
           "accept": accept, "eps": post.extras["eps"].tolist(),
           "mass": post.extras["mass"].tolist(), "recovered": recovered}
    print("sampler n=4096: " + json.dumps(out), flush=True)
    check(all(recovered.values()), "sampler: a true hyperparameter outside "
          "the pooled central 98% interval")
    check(max_rhat < 1.1, f"sampler: split-R-hat {max_rhat:.3f} >= 1.1")
    check(all(0.3 < a < 0.999 for a in accept),
          f"sampler: accept rates {accept} outside (0.3, 0.999)")

    # the hybrid force with exact accepts, unit mass, at the step the
    # adapted chains take along their stiffest direction
    eps = float(torch.median(post.extras["eps"] / torch.sqrt(
        post.extras["mass"].max(dim=1).values)))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    hyb = sample_hmc(1, x, y, init, log_prior, 32, l=5, eps=eps, n_chains=2,
                     gradients="hybrid", init_jitter=0.02)
    torch.cuda.synchronize()
    hyb_wall = time.perf_counter() - t0
    h_accept = [float(a) for a in hyb.accept_rate]
    h_launches = {k: c.launches for k, c in counters.items()}
    print(f"hybrid sampler n=4096 eps {eps:.4g}: accept {h_accept}, "
          f"{hyb_wall:.2f} s, launches {json.dumps(h_launches)}", flush=True)
    check(bool(torch.isfinite(hyb.flat).all()), "hybrid sampler: non-finite")
    check(all(a > 0.3 for a in h_accept), "hybrid sampler: accept <= 0.3")
    check(h_launches["logml_probe_grads"] > 0,
          "hybrid sampler: the probe kernel was not launched")
    out["hybrid"] = {"accept": h_accept, "wall_s": hyb_wall,
                     "probe_launches": h_launches["logml_probe_grads"]}

    # one chain at N = 16,384 on the bench data
    rng = np.random.default_rng(0)
    xb = torch.as_tensor(rng.uniform(-10.0, 10.0, size=(N_BENCH, 1))
                         .astype(np.float32), device="cuda")
    yb = torch.as_tensor(rng.normal(size=N_BENCH).astype(np.float32),
                         device="cuda")
    counters["logml_kernel_grads"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = sample_hmc(2, xb, yb, truth, log_prior, 4, l=3, eps=eps / 2.0,
                     n_chains=1, analytic_gradients=True, init_jitter=0.0)
    torch.cuda.synchronize()
    big_wall = time.perf_counter() - t0
    big_grads = counters["logml_kernel_grads"].launches
    print(f"sampler N={N_BENCH}: {big_grads} leapfrog gradients in "
          f"{big_wall:.2f} s, {1e3 * big_wall / big_grads:.2f} ms each; "
          f"accept {float(big.accept_rate[0]):.2f}", flush=True)
    check(bool(torch.isfinite(big.flat).all()), f"sampler N={N_BENCH}: "
          "non-finite draws")
    out["n16384"] = {"ms_per_gradient": 1e3 * big_wall / big_grads,
                     "gradients": big_grads,
                     "accept": float(big.accept_rate[0])}
    out["eps_stiff"] = eps
    return out


def phase_sampler(torch, gt, records):
    """Phase 5: the fast legs against their plain versions (a), the fast
    path at the bench case (b), the MAP init at n = 4096 and HMC over the
    hyperparameters from it (c). Returns the summary and the sampler case
    (x, y, the MAP, the prior) for phase 6."""
    t0 = time.perf_counter()
    _fast_trmm(torch, records)
    _fast_grads(torch, gt, records)
    out = {"fast_path": _fast_path(torch, gt, records)}
    x, y = _sampler_data(torch, gt, N_SAMPLER)
    log_prior = _log_prior(gt, torch)
    map_res, out["map"] = _map_init(torch, gt, x, y, log_prior)
    out["sampler"] = _sampler(torch, gt, x, y, map_res.params, log_prior)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase_sampler: {out['seconds']:.1f} s", flush=True)
    return out, (x, y, map_res.params, log_prior)


# -- phase 6: the workflows: type-II optimization and the other samplers ------

OPT_STEPS = 60    # sampler_scale.py's L-BFGS MAP
HYB_STEPS = 80    # its hybrid-adam MAP
IT_STEPS = 15     # Adam on the iterative route, examples/large_n.py's case
LBFGS_HYB_STEPS = 30
# The float64 gradient at the float32 L-BFGS optimum against the float32
# noise there, both as norms over the unconstrained components: the noise
# is max(the float32 gradient's measured error |g32 - g64|,
# logml_gradient_noise_floor's estimate) per component. Within 10x (the
# function's own flag for "in its noise") the point is stationary as far
# as float32 can tell; a norm, since an optimizer stops where its search
# direction, a blend of the components, drowns in the noise. The fused leg
# of that function (3- against 2-pass contraction, scaled) sees only the
# contraction's rounding: at this optimum on an H100 it read 2-43x below
# the measured error, so the measured error, the function's own
# definition off the fused route, is the floor where it is larger.
NOISE_MULT = 10.0
# The hybrid Adam optimum against the exact L-BFGS one: its exact log
# posterior within 3.91 nats of the optimum's, half the 95% quantile of
# chi-square with 3 degrees of freedom, i.e. inside the posterior's 95%
# region under the Laplace approximation: the warm start the hybrid is for.
# (Predicted before the first run: within 0.25 per unconstrained
# coordinate; read 0.305 in h, whose posterior is the widest.)
HYB_ENVELOPE = 3.91
PLANE = (2.0, 0.4)  # the known plane added to y for MH-within-Gibbs


def _u_of(params):
    """The unconstrained flat vector of a parameter tree, in float64."""
    from gpx_torch import params as P

    p = P.unflatten(params, [t.detach().double() for t in P.leaves(params)])
    return P.to_array(P.unconstrain(p.bijectors(), p))


def _grad_u(torch, params, loglik, log_prior, dtype):
    """The gradient of ``loglik + log_prior`` in unconstrained space at
    ``params``, every leaf in ``dtype``: the optimizer's own objective."""
    from gpx_torch import params as P

    p0 = P.unflatten(params, [t.detach().to(dtype) for t in P.leaves(params)])
    bij = p0.bijectors()
    flat0, unravel = P.unraveler(P.unconstrain(bij, p0))
    u = flat0.detach().requires_grad_()
    with torch.enable_grad():
        p = P.constrain(bij, unravel(u))
        (g,) = torch.autograd.grad(loglik(p) + log_prior(p), u)
    return g.double()


def _floor_u(torch, gt, gp, params, x, y):
    """logml_gradient_noise_floor at ``params`` (the fused route's 3- and
    2-pass gradients) taken to unconstrained space by each bijector's
    derivative."""
    from gpx_torch import params as P

    _, floor, _ = gp.logml_gradient_noise_floor(params, x, y)
    out = []
    for b, c, f in zip(P.leaves(params.bijectors()), P.leaves(params),
                       P.leaves(floor)):
        u = b.inverse(c.detach().double()).requires_grad_()
        with torch.enable_grad():
            (d,) = torch.autograd.grad(b.forward(u).sum(), u)
        out.append((f.double() * d.abs()).reshape(-1))
    return torch.cat(out)


def _opt_lbfgs(torch, gt, gp, optimize, x, y, log_prior):
    """L-BFGS on the analytic route at N = 16,384 (case 1): the trace, and
    the float64 gradient at the optimum against the float32 noise floor
    there, in unconstrained space."""
    res, wall, launches = _counted(torch, lambda: optimize(
        _map_template(gt), x, y, log_prior=log_prior, steps=OPT_STEPS))
    _hold_route("optimize lbfgs", launches, FUSED, ("logml_probe_grads",))
    vals = res.values.double().cpu()
    check(bool(torch.isfinite(vals).all()), "optimize lbfgs: non-finite "
          "trace")
    # float32 noise of the value: the f32 envelope's 1e-4 relative
    tail_noise = 1e-4 * float(vals[-1].abs())
    drops = float((vals[-10:][1:] - vals[-10:][:-1]).min())
    print(f"optimize lbfgs: last 10 values {vals[-10:].tolist()}, largest "
          f"fall {-drops:.4g} (limit {tail_noise:.4g}: 1e-4 of the value)",
          flush=True)
    check(drops >= -tail_noise, "optimize lbfgs: the trace's tail falls "
          "beyond float32 noise")
    lp64 = _log_prior(gt, torch, dtype=torch.float64)
    x64, y64 = x.double(), y.double()
    g64 = _grad_u(torch, res.params, lambda p: gp.log_marginal_likelihood(
        p, x64, y64), lp64, torch.float64).cpu()
    g32 = _grad_u(torch, res.params, gp.log_marginal_likelihood_analytic_vjp(
        x, y), log_prior, torch.float32).cpu()
    est = _floor_u(torch, gt, gp, res.params, x, y).cpu()
    floor = torch.maximum((g32 - g64).abs(), est)
    ratio = (g64.abs() / floor).tolist()
    evals = launches["logml_kernel_grads"]
    out = {"wall_s": wall, "ms_per_step": 1e3 * wall / OPT_STEPS,
           "evals": evals, "evals_per_step": evals / OPT_STEPS,
           "value": float(res.value), "grad_norm32": float(res.grad_norm),
           "converged": res.converged,
           "params": [float(t) for t in _leaves(res.params)],
           "g64_u": g64.tolist(), "g32_u": g32.tolist(),
           "f32_error_u": (g32 - g64).abs().tolist(),
           "noise_floor_fn_u": est.tolist(),
           "error_over_fn_floor": ((g32 - g64).abs() / est).tolist(),
           "g64_over_floor_per_component": ratio}
    print("optimize lbfgs N=16384: " + json.dumps(out), flush=True)
    g64_norm, floor_norm = float(g64.norm()), float(floor.norm())
    print(f"optimize lbfgs: |g64| {g64_norm:.4g} against |noise| "
          f"{floor_norm:.4g}: {g64_norm / floor_norm:.3g}x (limit "
          f"{NOISE_MULT:g}x)", flush=True)
    check(g64_norm <= NOISE_MULT * floor_norm,
          f"optimize lbfgs: float64 gradient {g64.tolist()} beyond "
          f"{NOISE_MULT:g} x the float32 noise {floor.tolist()} (norms)")
    return res, out


def _opt_hybrid(torch, gt, gp, optimize, x, y, log_prior, opt):
    """Adam on the hybrid at N = 16,384 (case 2): twice with one key; its
    optimum's distance from the L-BFGS one ``opt``, in unconstrained
    space and in the exact log posterior."""
    def run():
        return optimize(_map_template(gt), x, y, log_prior=log_prior,
                        steps=HYB_STEPS, optimizer="adam", method="hybrid",
                        learning_rate=0.05)

    a, wall, launches = _counted(torch, run)
    _hold_route("optimize hybrid adam", launches,
                ("gram", "trmm", "syrk_lower", "logml_probe_grads"),
                ("logml_kernel_grads",))
    b = run()
    same = torch.equal(a.values, b.values) and all(
        torch.equal(s, t) for s, t in zip(_leaves(a.params),
                                          _leaves(b.params)))
    exact = float(gp.logml_value_and_grad(a.params, x, y)[0]
                  + log_prior(a.params))
    gap = float(opt.value) - exact
    out = {"wall_s": wall, "ms_per_step": 1e3 * wall / (HYB_STEPS + 1),
           "value": float(a.value), "bitwise_repeat": same,
           "params": [float(t) for t in _leaves(a.params)],
           "u_dist_to_lbfgs": (_u_of(a.params) - _u_of(opt.params)).abs()
           .tolist(), "exact_log_posterior": exact,
           "gap_to_lbfgs_nats": gap}
    print("optimize hybrid adam N=16384: " + json.dumps(out), flush=True)
    check(bool(torch.isfinite(a.values).all()), "optimize hybrid: non-finite")
    check(same, "optimize hybrid: two calls with one key differ")
    check(gap <= HYB_ENVELOPE, f"optimize hybrid: its exact log posterior "
          f"{gap:.4g} nats below the L-BFGS optimum's (envelope "
          f"{HYB_ENVELOPE:g})")
    return out


def _opt_iterative(torch, gt, optimize):
    """Adam on the iterative route at examples/large_n.py's N = 32,768
    (case 3), from its parameters, fresh probes each step."""
    x_np, y_np = _iter_case(N_IT)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    template = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt))
    res, wall, launches = _counted(torch, lambda: optimize(
        template, x, y, steps=IT_STEPS, optimizer="adam",
        method="iterative", learning_rate=0.05, key=0,
        n_probes=ITER["n_probes"], lanczos_iters=ITER["lanczos_iters"],
        precond_rank=ITER["precond_rank"]))
    _hold_route("optimize iterative", launches, ("gram_matvec",),
                ("logml_kernel_grads", "logml_probe_grads"))
    vals = res.values.double().cpu()
    out = {"wall_s": wall, "ms_per_step": 1e3 * wall / (IT_STEPS + 1),
           "first": float(vals[0]), "last": float(vals[-1]),
           "value": float(res.value),
           "params": [float(t) for t in _leaves(res.params)]}
    print(f"optimize iterative N={N_IT}: " + json.dumps(out), flush=True)
    check(bool(torch.isfinite(vals).all()), "optimize iterative: non-finite")
    check(out["last"] > out["first"], "optimize iterative: no improvement")
    return out


def _opt_lbfgs_hybrid(torch, gt, gp, x, y, log_prior, u_map):
    """A measurement, not a gate (case 4): L-BFGS on the hybrid log
    density through optimize_log_density, which optimize refuses."""
    from gpx_torch.models.optimize import optimize_log_density

    ll = gp.log_marginal_likelihood_hybrid_vjp(x, y)
    res, wall, _ = _counted(torch, lambda: optimize_log_density(
        _map_template(gt), lambda p: log_prior(p) + ll(p),
        steps=LBFGS_HYB_STEPS))
    vals = res.values.double().cpu()
    out = {"wall_s": wall, "finite": bool(torch.isfinite(vals).all()),
           "value": float(res.value), "first": float(vals[0]),
           "params": [float(t) for t in _leaves(res.params)],
           "u_dist_to_lbfgs": (_u_of(res.params) - u_map).abs().tolist()}
    print("optimize_log_density lbfgs on the hybrid N=16384 (measurement "
          "only): " + json.dumps(out), flush=True)
    return out


def _nuts(torch, gt, x, y, init, log_prior, hmc_ms):
    """sample_nuts at n = 4096 from the MAP (part 6)."""
    from gpx_torch.infer import sample_nuts

    post, wall, launches = _counted(torch, lambda: sample_nuts(
        3, x, y, init, log_prior, 128, max_depth=8, eps=None,
        warmup_iters=64, n_chains=4, adapt_mass=True,
        analytic_gradients=True, init_jitter=0.02))
    _hold_route("nuts n=4096", launches, FUSED, ("logml_probe_grads",))
    recovered, rows = _recovery(torch, post, TRUTH)
    grads = launches["logml_kernel_grads"]
    depth = post.extras["depth"].double()
    min_ess = min(r["ess"] for r in rows.values())
    max_rhat = max(r["rhat"] for r in rows.values())
    out = {"wall_s": wall, "leapfrog_gradients": grads,
           "ms_per_gradient": 1e3 * wall / max(grads, 1),
           "hmc_ms_per_gradient":
           hmc_ms, "mean_depth": float(depth.mean()),
           "max_depth_reached": int(depth.max()),
           "accept": [float(a) for a in post.accept_rate],
           "eps": post.extras["eps"].tolist(), "min_ess": min_ess,
           "ess_per_s": min_ess / wall, "max_rhat": max_rhat,
           "recovered": recovered,
           "divergences": "not counted (NUTSState has no such field)"}
    print("nuts n=4096: " + json.dumps(out), flush=True)
    check(all(recovered.values()), "nuts: a true hyperparameter outside the "
          "pooled central 98% interval")
    check(max_rhat < 1.1, f"nuts: split-R-hat {max_rhat:.3f} >= 1.1")
    return out


def _ehmc(torch, gt, x, y, init, log_prior):
    """sample_ehmc at n = 4096 from the MAP (part 7): k = 32 length
    measurements, l_max = 48, 32 warmup iterations and 48 draws per chain
    (cut from the reference's k = 2000 and 500 warmup to fit the run)."""
    from gpx_torch.infer import sample_ehmc

    post, wall, launches = _counted(torch, lambda: sample_ehmc(
        4, x, y, init, log_prior, 48, k=32, l_max=48, warmup_iters=32,
        n_chains=2, analytic_gradients=True, init_jitter=0.02))
    _hold_route("ehmc n=4096", launches, FUSED, ("logml_probe_grads",))
    recovered, _ = _recovery(torch, post, TRUTH)
    lengths = post.extras["lengths"].double().cpu().reshape(-1)
    q = torch.quantile(lengths, torch.tensor([0.1, 0.5, 0.9],
                                             dtype=lengths.dtype))
    grads = launches["logml_kernel_grads"]
    out = {"wall_s": wall, "leapfrog_gradients": grads,
           "ms_per_gradient": 1e3 * wall / max(grads, 1),
           "length_q10_50_90": q.tolist(),
           "accept": [float(a) for a in post.accept_rate],
           "eps": post.extras["eps"].tolist(), "recovered": recovered}
    print("ehmc n=4096: " + json.dumps(out), flush=True)
    check(all(recovered.values()), "ehmc: a true hyperparameter outside the "
          "pooled central 98% interval")
    return out


def _mh(torch, gt, x, y, init, log_prior):
    """sample_mh at n = 4096 from the MAP on the value route (part 8)."""
    from gpx_torch.infer import sample_mh

    post, wall, launches = _counted(torch, lambda: sample_mh(
        5, x, y, init, log_prior, 1500, n_chains=4, proposal_scale=0.03,
        init_jitter=0.02))
    _hold_route("mh n=4096", launches, ("gram",),
                ("logml_kernel_grads", "logml_probe_grads", "trmm"))
    recovered, rows = _recovery(torch, post, TRUTH)
    accept = [float(a) for a in post.accept_rate]
    out = {"wall_s": wall, "ms_per_value": 1e3 * wall / (4 * 1501),
           "accept": accept, "recovered": recovered,
           "min_ess": min(r["ess"] for r in rows.values())}
    print("mh n=4096: " + json.dumps(out), flush=True)
    check(all(recovered.values()), "mh: a true hyperparameter outside the "
          "pooled central 98% interval")
    check(all(0.05 < a < 0.9 for a in accept),
          f"mh: accept rates {accept} outside (0.05, 0.9)")
    return out


def _gibbs(torch, gt, x, y, init, log_prior):
    """sample_mh_within_gibbs at n = 4096 (part 9): a Plane mean on the
    same x with the plane PLANE added to y, from the MAP's kernel."""
    from gpx_torch.distributions import Normal
    from gpx_torch.infer import sample_mh_within_gibbs

    yp = y + PLANE[0] + PLANE[1] * x[:, 0]
    template = gt.Parameters(mean=gt.plane([0.0, 0.0]), kernel=init.kernel)
    prior_mean = Normal(torch.tensor(0.0, device="cuda"),
                        torch.tensor(5.0, device="cuda"))

    def log_prior_kernel(k):
        return log_prior(gt.Parameters(mean=gt.zero(), kernel=k))

    post, wall, launches = _counted(torch, lambda: sample_mh_within_gibbs(
        6, x, yp, template, log_prior_kernel, prior_mean, 300, n_chains=2,
        burn_in=100, proposal_scale=0.03))
    _hold_route("mh-within-gibbs n=4096", launches, ("gram",),
                ("logml_kernel_grads", "logml_probe_grads"))
    flat = post.flat.double().cpu()
    check(bool(torch.isfinite(flat).all()), "gibbs: non-finite draws")
    pooled = flat.reshape(-1, flat.shape[-1])
    med = [float(pooled[:, post.names.index(f"mean.beta_{i}")].median())
           for i in (0, 1)]
    accept = [float(a) for a in post.accept_rate]
    out = {"wall_s": wall, "ms_per_iteration": 1e3 * wall / (2 * 400),
           "beta_median": med, "accept": accept}
    print("mh-within-gibbs n=4096: " + json.dumps(out), flush=True)
    # tests/test_mcmc_gp.py's bounds: the plane is identified up to the
    # GP's own smooth part
    check(abs(med[0] - PLANE[0]) < 1.5 and abs(med[1] - PLANE[1]) < 0.3,
          f"gibbs: plane medians {med} against {PLANE}")
    check(all(a > 0.02 for a in accept), f"gibbs: accept rates {accept}")
    return out


def _nuts_big(torch, gt, eps):
    """One NUTS chain at N = 16,384 on the bench data (part 10): a fixed
    step (half the HMC chains' stiffest), 4 draws, max_depth 3."""
    from gpx_torch.infer import sample_nuts

    params, xb, yb = _bench_case_cuda(torch, gt)
    post, wall, launches = _counted(torch, lambda: sample_nuts(
        7, xb, yb, params, _log_prior(gt, torch), 4, eps=eps / 2.0,
        max_depth=3, n_chains=1, analytic_gradients=True, init_jitter=0.0))
    grads = launches["logml_kernel_grads"]
    out = {"wall_s": wall, "leapfrog_gradients": grads,
           "ms_per_gradient": 1e3 * wall / max(grads, 1),
           "depth": post.extras["depth"].tolist()}
    print(f"nuts N={N_BENCH}: " + json.dumps(out), flush=True)
    check(grads > 0, f"nuts N={N_BENCH}: no gradient kernel launch")
    check(bool(torch.isfinite(post.flat).all()), f"nuts N={N_BENCH}: "
          "non-finite draws")
    return out


def phase_workflows(torch, gt, sampler_case, sampler_out):
    """Phase 6: optimize at full width (L-BFGS on the analytic route,
    Adam on the hybrid twice, Adam on the iterative route at N = 32,768,
    L-BFGS on the hybrid log density as a measurement), then NUTS, eHMC,
    MH and MH-within-Gibbs at n = 4096 from phase 5's MAP, and one NUTS
    chain at N = 16,384. Each part's seconds."""
    from gpx_torch.models import gp
    from gpx_torch.models.optimize import optimize

    t0 = time.perf_counter()
    secs = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        print(f"phase_workflows {name}: {secs[name]:.1f} s", flush=True)
        return out

    xb, yb = _sampler_data(torch, gt, N_BENCH)
    log_prior = _log_prior(gt, torch)
    opt, opt_out = part("optimize_lbfgs", lambda: _opt_lbfgs(
        torch, gt, gp, optimize, xb, yb, log_prior))
    u_map = _u_of(opt.params)
    out = {"optimize_lbfgs": opt_out}
    out["optimize_hybrid"] = part("optimize_hybrid", lambda: _opt_hybrid(
        torch, gt, gp, optimize, xb, yb, log_prior, opt))
    out["optimize_iterative"] = part("optimize_iterative",
                                     lambda: _opt_iterative(torch, gt,
                                                            optimize))
    out["lbfgs_hybrid"] = part("lbfgs_hybrid", lambda: _opt_lbfgs_hybrid(
        torch, gt, gp, xb, yb, log_prior, u_map))
    x, y, init, lp = sampler_case
    hmc_ms = sampler_out["sampler"]["ms_per_gradient"]
    out["nuts"] = part("nuts", lambda: _nuts(torch, gt, x, y, init, lp,
                                             hmc_ms))
    out["ehmc"] = part("ehmc", lambda: _ehmc(torch, gt, x, y, init, lp))
    out["mh"] = part("mh", lambda: _mh(torch, gt, x, y, init, lp))
    out["gibbs"] = part("gibbs", lambda: _gibbs(torch, gt, x, y, init, lp))
    out["nuts_16384"] = part("nuts_16384", lambda: _nuts_big(
        torch, gt, sampler_out["sampler"]["eps_stiff"]))
    out["seconds"] = secs
    print(f"phase_workflows: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- phase 7: the sparse and multi-output models ----------------------------

N_SVGP, M_SVGP = 262144, 1024     # benchmarks/svgp_scale.py
SVGP_STEPS, SVGP_BATCH = 500, 2048
M_MO, MO_STEPS, T_MO = 512, 200, 4
N_ICM, T_ICM = 4096, 4            # benchmarks/multioutput_scale.py defaults
N_MF, T_MF = 16384, 8             # its matrix-free case
MF = dict(n_probes=16, lanczos_iters=32, cg_tol=1e-5, precond_rank=64)
GRID = (4096, 64)                 # benchmarks/grid_scale.py
# test points: SGPR's fit, SVGP's held-out set and the exact fit's
# subsample, the multi-output SVGP's fit, the ICM's, iterative and grid fits
S_SGPR, S_HELD, S_MO, S_ICM = 16384, 16384, 4096, 1024
# limits before the witness: the exact path's float32 envelope (value 1e-4
# relative; a gradient 1e-2 of its norm) and fit's records (MEAN_LIMIT,
# VAR_LIMIT of scale)
VALUE_REL, GRAD_REL = 1e-4, 1e-2
# the largest miss of the float32 plain route (or of the path's own float64
# algorithm) that may widen a limit; an output past it is not held
WITNESS_CAP = 0.1
NOT_HELD: list = []               # the outputs _hold_model did not hold
DEV = "cuda"                      # phase 7's device (a CPU rehearsal sets "cpu")


class _PlainRoutes:
    """Inside: the Gram and the matvec take their plain torch routes on
    the card, for the float32 witness of a model (the same float32
    algorithm, no CUDA kernel)."""

    def __enter__(self):
        from gpx_torch.ops import gram, matvec

        self._saved = gram.uses_cuda_kernel, matvec._uses_cuda_kernel
        gram.uses_cuda_kernel = matvec._uses_cuda_kernel = (
            lambda *a, **k: False)

    def __exit__(self, *exc):
        from gpx_torch.ops import gram, matvec

        gram.uses_cuda_kernel, matvec._uses_cuda_kernel = self._saved


class _F32Jitter:
    """Inside: the sparse models regularize Kuu with the float32 jitter
    (JITTER_F32) in float64 too, so that a float64 run computes the same
    function as the float32 one (its own jitter, 1e-6, is another)."""

    def __enter__(self):
        from gpx_torch.models import sparse, svgp, svgp_mo

        self._mods = (sparse, svgp, svgp_mo)
        self._saved = [m._jitter for m in self._mods]
        for m in self._mods:
            m._jitter = lambda dtype: sparse.JITTER_F32

    def __exit__(self, *exc):
        for m, f in zip(self._mods, self._saved):
            m._jitter = f


def _same_nonfinite(a, b):
    """Whether ``a`` and ``b`` are non-finite at the same entries."""
    return bool(((~a.isfinite()) == (~b.isfinite())).all())


def _to64(gt, tree):
    return gt.params.unflatten(tree, [t.double() for t in gt.params.leaves(tree)])


def _rel(got, want) -> float:
    """Normwise relative error of a tensor against float64."""
    g, w = got.double(), want.double().to(got.device)
    return float((g - w).norm() / max(float(w.norm()), 1e-300))


def _hold_model(label, names, got, want, witness, base, own64=None):
    """Each output of a float32 model on the kernel route against the same
    port code in float64 on the same inputs, normwise relative: within
    ``base`` (VALUE_REL for a value, GRAD_REL for a gradient, the fit
    records for a posterior), or, where the float32 plain route (the
    witness: the same algorithm in float32 without the kernels) misses it
    too, within twice the witness's error. ``own64``: where ``want`` is
    another algorithm's float64 result (the dense logML for the kron one),
    the path's own float64 outputs, whose miss is the algorithm's and
    counts as a witness too. A witness that misses by more than
    WITNESS_CAP of the output's norm leaves the output not held: float32
    rounding decides it, and a limit scaled to it could not fail (the
    kernels on that path are held directly, _hold_gram and the matvec
    holds). Returns the largest error of the outputs held; the outputs not
    held are listed in NOT_HELD."""
    worst = 0.0
    own64 = [None] * len(names) if own64 is None else own64
    for nm, g, w, f, b, o in zip(names, got, want, witness, base, own64):
        e, ew = _rel(g, w), _rel(f, w)
        eo = 0.0 if o is None else _rel(o, w)
        limit = max(b, 2.0 * ew, 2.0 * eo)
        own = "" if o is None else f", its own float64 {eo:.3e}"
        if not bool(g.isfinite().all()):
            # a float32 fault of the algorithm, not of a kernel, where the
            # plain route gives non-finite values at the same entries
            same = _same_nonfinite(g, f)
            bad = int((~g.isfinite()).sum())
            print(f"{label} {nm}: NOT FINITE in float32 ({bad} of "
                  f"{g.numel()} entries), as on the float32 plain route: "
                  f"{same}; float64 finite, norm {float(w.double().norm()):.4e}"
                  + ("" if o is None else f", its own float64 off by {eo:.3e}")
                  + " (a fault of the float32 algorithm: ROADMAP section 3)",
                  flush=True)
            check(same, f"{label} {nm}: not finite where the float32 plain "
                  f"route is")
            check(bool(w.isfinite().all()), f"{label} {nm}: float64 not finite")
            NOT_HELD.append(f"{label} {nm} (not finite)")
            continue
        if max(ew, eo) > WITNESS_CAP:
            print(f"{label} {nm}: not held (float32 algorithm): err {e:.3e} "
                  f"of float64's norm {float(w.double().norm()):.4e}; the "
                  f"float32 plain route misses it by {ew:.3e}{own}, above "
                  f"{WITNESS_CAP:g}", flush=True)
            NOT_HELD.append(f"{label} {nm}")
            continue
        print(f"{label} {nm}: err {e:.3e} of float64's norm "
              f"{float(w.double().norm()):.4e} (limit {limit:.3e}; base {b:g}, "
              f"float32 plain route {ew:.3e}{own})", flush=True)
        check(e <= limit, f"{label} {nm}: outside its limit")
        worst = max(worst, e)
    return worst


def _value_and_grads(torch, gt, fn, tree, *extra):
    """``[value, d/dleaf for every leaf of tree, d/d each of extra]`` of
    ``fn(tree, *extra)``, detached."""
    ls = [t.detach().requires_grad_() for t in gt.params.leaves(tree)]
    ex = [t.detach().requires_grad_() for t in extra]
    with torch.enable_grad():
        v = fn(gt.params.unflatten(tree, ls), *ex)
        gs = torch.autograd.grad(v, ls + ex)
    return [v.detach()] + [g.detach() for g in gs]


def _three(torch, gt, fn, tree, *inputs):
    """``(float32 on the kernel route, float64, float32 witness)`` of
    ``fn(tree, *inputs)``; float64 with the float32 Kuu jitter."""
    f32 = fn(tree, *inputs)
    with _F32Jitter():
        f64 = fn(_to64(gt, tree), *(t.double() for t in inputs))
    with _PlainRoutes():
        wit = fn(tree, *inputs)
    return f32, f64, wit


def _svgp_data(torch, n):
    """benchmarks/svgp_scale.py's data: x sorted U(-10, 10) at numpy seed 0,
    y = 3 sin(0.7 x) + 0.5 eps, float32 on the card."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-10.0, 10.0, size=n)).astype(np.float32)
    y = (3.0 * np.sin(0.7 * x) + 0.5 * rng.normal(size=n)).astype(np.float32)
    return (torch.as_tensor(x, device=DEV)[:, None],
            torch.as_tensor(y, device=DEV))


def _per(launches, n):
    return {k: v / n for k, v in launches.items() if v}


def _sgpr_case(torch, gt, x, y):
    """(a) SGPR at N = 262,144, M = 1024 quantile landmarks: the bound and
    its gradient in the kernel's leaves and z, and fit to 16,384 grid
    points, each against float64 (same code) with the float32 plain route
    as witness; peak memory of the bound with its gradient."""
    from gpx_torch.models import sparse

    z = x[:: N_SVGP // M_SVGP][:M_SVGP]
    p = gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 2.0, device=DEV))

    def bound(params, z_, x_, y_):
        return _value_and_grads(
            torch, gt, lambda q, zz: sparse.elbo(q, zz, x_, y_, noise=0.25),
            params, z_)

    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, wall, launches = _counted(torch, lambda: bound(p, z, x, y))
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    ms = 1e3 * min(_counted(torch, lambda: bound(p, z, x, y))[1]
                   for _ in range(3))
    with _F32Jitter():
        want = bound(_to64(gt, p), z.double(), x.double(), y.double())
    with _PlainRoutes():
        wit = bound(p, z, x, y)
    print(f"(a) SGPR elbo + grad N={N_SVGP} M={M_SVGP}: {ms:.2f} ms (best of "
          f"3 after one); launches {json.dumps(launches)}; value "
          f"{float(got[0]):.8e} (float64 {float(want[0]):.8e}); peak memory "
          f"{peak:.2f} GiB above the data (Kuf alone 1.00 GiB in float32)",
          flush=True)
    check(launches["gram"] >= 2, "(a) SGPR: the Gram kernel was not launched "
          "for Kuu and Kuf")
    gerr = max(_hold_gram(torch, gt, "(a) SGPR Kuu", p.kernel, z,
                          nugget=sparse.JITTER_F32),
               _hold_gram(torch, gt, "(a) SGPR Kuf", p.kernel, z, nugget=0.0,
                          x2=x))
    torch.cuda.empty_cache()
    err = _hold_model("(a) SGPR", ["value", "dh", "dsigma", "dz"], got, want,
                      wit, [VALUE_REL] + [GRAD_REL] * 3)
    xs = torch.linspace(-10.0, 10.0, S_SGPR, device=DEV)[:, None]

    def fit(params, z_, x_, y_, xs_):
        s = sparse.fit(params, z_, x_, y_, xs_, noise=0.25)
        return [s.mean, s.variance]

    (f32, f64, fw), wall_f, fl = _counted(
        torch, lambda: _three(torch, gt, fit, p, z, x, y, xs))
    t_fit = _counted(torch, lambda: fit(p, z, x, y, xs))[1]
    _hold_model("(a) SGPR fit", ["mean", "variance"], f32, f64, fw,
                [MEAN_LIMIT, VAR_LIMIT])
    print(f"(a) SGPR fit -> {S_SGPR} points: {1e3 * t_fit:.2f} ms", flush=True)
    return {"elbo_grad_ms": ms, "fit_ms": 1e3 * t_fit, "peak_gib": peak,
            "launches": launches, "err": err, "gram_err": gerr}


def _svgp_case(torch, gt, x, y):
    """(b) svgp.train at N = 262,144 (M = 1024, batch 2048, 500 steps, lr
    1e-2, noise trained): ms per step, points/s, the ELBO trace, the
    trained noise; one elbo_minibatch and its gradient at a fixed batch
    against float64; held-out RMSE and NLPD beside an exact gp.fit."""
    from gpx_torch.models import gp, svgp

    z = x[:: N_SVGP // M_SVGP][:M_SVGP]
    p = gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 2.0, device=DEV))

    def train(steps):
        return svgp.train(0, p, z, x, y, noise=0.25, batch_size=SVGP_BATCH,
                          steps=steps, learning_rate=1e-2, train_noise=True)

    train(2)  # the first torch.optim step of a process imports torch._dynamo
    (pt, zt, st, nt, trace), wall, launches = _counted(
        torch, lambda: train(SVGP_STEPS))
    tr = trace.cpu().numpy()
    ms = 1e3 * wall / SVGP_STEPS
    print(f"(b) SVGP train: {ms:.2f} ms per step, "
          f"{SVGP_STEPS * SVGP_BATCH / wall:.4e} points/s; ELBO first "
          f"{tr[0]:.6e} last {tr[-1]:.6e} (mean of the last 10 "
          f"{tr[-10:].mean():.6e}); trained noise {float(nt):.5f} (truth "
          f"0.25), h {float(pt.kernel.h):.4f}, sigma {float(pt.kernel.sigma):.4f};"
          f" launches per step {json.dumps(_per(launches, SVGP_STEPS))}",
          flush=True)
    check(bool(np.isfinite(tr).all()), "(b) SVGP: ELBO trace not finite")
    check(tr[-10:].mean() > tr[:10].mean(), "(b) SVGP: ELBO did not improve")
    check(launches["gram"] >= 2 * SVGP_STEPS, "(b) SVGP: the Gram kernel was "
          "not launched for Kuu and Kuf at every step")
    idx = torch.as_tensor(np.random.default_rng(1).choice(
        N_SVGP, SVGP_BATCH, replace=False), device=DEV)

    def mb(params, z_, mu, c_raw, s2, x_, y_):
        return _value_and_grads(torch, gt, lambda q, zz, m_, c_, n_: (
            svgp.elbo_minibatch(q, zz, svgp.SVGPState(m_, c_), x_, y_,
                                n_total=N_SVGP, noise=n_)),
            params, z_, mu, c_raw, s2)

    got, want, wit = _three(torch, gt, mb, pt, zt, st.mu, st.c_raw, nt,
                            x[idx], y[idx])
    err = _hold_model("(b) SVGP elbo_minibatch", [
        "value", "dh", "dsigma", "dz", "dmu", "dc_raw", "dnoise"], got, want,
        wit, [VALUE_REL] + [GRAD_REL] * 6)
    step_ms = 1e3 * min(_counted(torch, lambda: mb(
        pt, zt, st.mu, st.c_raw, nt, x[idx], y[idx]))[1] for _ in range(3))

    # held-out quality: S_HELD new points of the same law (numpy seed 1)
    rng = np.random.default_rng(1)
    xh = np.sort(rng.uniform(-10.0, 10.0, S_HELD)).astype(np.float32)
    yh = torch.as_tensor((3.0 * np.sin(0.7 * xh) + 0.5 * rng.normal(
        size=S_HELD)).astype(np.float32), device=DEV)
    xh = torch.as_tensor(xh, device=DEV)[:, None]
    s = svgp.fit(pt, zt, st, xh, noise=nt)
    sub = torch.as_tensor(np.sort(rng.choice(N_SVGP, S_HELD, replace=False)),
                          device=DEV)
    ex = gp.fit(gt.Parameters(mean=gt.zero(), kernel=pt.kernel), x[sub],
                y[sub], xh, nugget=float(nt))
    quality = {}
    for name, mean, var in (("svgp", s.mean, s.variance),
                            ("exact_subsample", ex.mean, ex.variance + nt)):
        r = (yh - mean).double()
        quality[name] = {
            "rmse": float(r.pow(2).mean().sqrt()),
            "nlpd": float((0.5 * torch.log(2 * math.pi * var.double())
                           + r.pow(2) / (2 * var.double())).mean())}
    floor = 0.5 * math.log(2 * math.pi * 0.25) + 0.5
    print(f"(b) held-out ({S_HELD} points): {json.dumps(quality)} (noise sd "
          f"0.5: RMSE floor 0.5, NLPD floor {floor:.4f})", flush=True)
    for q in quality.values():
        check(all(math.isfinite(v) for v in q.values()),
              "(b) held-out quality not finite")
    return {"ms_per_step": ms, "points_per_s": SVGP_STEPS * SVGP_BATCH / wall,
            "elbo_first": float(tr[0]), "elbo_last": float(tr[-1]),
            "noise": float(nt), "minibatch_grad_ms": step_ms, "err": err,
            "quality": quality,
            "launches_per_step": _per(launches, SVGP_STEPS)}


def _mo_svgp_case(torch, gt, x):
    """(c) svgp_mo.train on the same x: T = 4 outputs y_t = 3 sin(0.7 x +
    phi_t) + 0.5 eps, Q = 2 latents (SE(2, 2), Matern(1, 3/2, 2)), M = 512,
    batch 2048, 200 steps, 10% of the entries masked; fit to 4,096 points
    against float64."""
    from gpx_torch.models import sparse, svgp_mo

    rng = np.random.default_rng(2)
    phase = rng.uniform(0.0, 2.0, T_MO)
    xn = x[:, 0].cpu().numpy().astype(np.float64)
    Y = torch.as_tensor((3.0 * np.sin(0.7 * xn[:, None] + phase[None, :])
                         + 0.5 * rng.normal(size=(N_SVGP, T_MO))
                         ).astype(np.float32), device=DEV)
    mask = rng.uniform(size=(N_SVGP, T_MO)) >= 0.1
    z = x[:: N_SVGP // M_MO][:M_MO]
    p = svgp_mo.mo_svgp([gt.se(2.0, 2.0, device=DEV),
                         gt.matern(1.0, 1.5, 2.0, device=DEV)], T_MO)

    def train(steps):
        return svgp_mo.train(0, p, z, x, Y, noise=0.25, batch_size=SVGP_BATCH,
                             steps=steps, learning_rate=1e-2,
                             train_noise=True, mask=mask)

    train(2)
    (pt, zt, st, nt, trace), wall, launches = _counted(
        torch, lambda: train(MO_STEPS))
    tr = trace.cpu().numpy()
    ms = 1e3 * wall / MO_STEPS
    print(f"(c) multi-output SVGP train: {ms:.2f} ms per step; ELBO first "
          f"{tr[0]:.6e} last {tr[-1]:.6e}; noise {nt.cpu().numpy().round(4)}; "
          f"launches per step {json.dumps(_per(launches, MO_STEPS))}",
          flush=True)
    check(bool(np.isfinite(tr).all()), "(c) MO-SVGP: ELBO trace not finite")
    check(tr[-10:].mean() > tr[:10].mean(), "(c) MO-SVGP: ELBO did not improve")
    check(launches["gram"] >= 4 * MO_STEPS, "(c) MO-SVGP: the Gram kernel was "
          "not launched for every latent's Kuu and Kuf at every step")
    gerr = 0.0
    for q, kern in enumerate(pt.kernels):
        gerr = max(gerr, _hold_gram(torch, gt, f"(c) MO-SVGP latent {q} Kuu",
                                    kern, zt, nugget=sparse.JITTER_F32),
                   _hold_gram(torch, gt, f"(c) MO-SVGP latent {q} Kuf", kern,
                              zt, nugget=0.0, x2=x))
        torch.cuda.empty_cache()
    xs = torch.linspace(-10.0, 10.0, S_MO, device=DEV)[:, None]

    def fit(params, z_, mu, c_raw, xs_):
        s = svgp_mo.fit(params, z_, svgp_mo.MoSVGPState(mu, c_raw), xs_)
        return [s.mean, s.variance]

    f32, f64, fw = _three(torch, gt, fit, pt, zt, st.mu, st.c_raw, xs)
    err = _hold_model("(c) MO-SVGP fit", ["mean", "variance"], f32, f64, fw,
                      [MEAN_LIMIT, VAR_LIMIT])
    return {"ms_per_step": ms, "elbo_first": float(tr[0]),
            "elbo_last": float(tr[-1]), "err": err, "gram_err": gerr,
            "launches_per_step": _per(launches, MO_STEPS)}


def _icm_problem(torch, gt, n, t, seed=42, distinct=False):
    """benchmarks/multioutput_scale.py's problem: x sorted U(-10, 10), W ~
    0.6 N(0, 1) (T, 2), kappa 0.3, noise 0.5, SE(2, 2), Y_t = 3 sin(0.7 x +
    phi_t) + 0.5 eps, float32 on the card. Its rank-2 W repeats B's
    eigenvalue 0.3 T - 2 times, where eigh's VJP is not defined and the
    basis that rotates the Kronecker preconditioner's probes is not unique.
    ``distinct``: the same data and kernel under a full-rank W (T, T) ~ 0.6
    N(0, 1) (numpy seed ``seed + 1``) and kappa spread over [0.2, 0.5], so
    that B's eigenvalues are distinct, for the gradients' holds."""
    from gpx_torch.models import multioutput as mo

    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-10.0, 10.0, n))[:, None]
    w = rng.normal(size=(t, 2)) * 0.6
    phase = rng.uniform(0.0, 2.0, t)
    y = 3.0 * np.sin(0.7 * x + phase[None, :]) + 0.5 * rng.normal(size=(n, t))
    kappa = np.full(t, 0.3)
    if distinct:
        w = np.random.default_rng(seed + 1).normal(size=(t, t)) * 0.6
        kappa = np.linspace(0.2, 0.5, t)
    p = mo.IcmParams(kernel=gt.se(2.0, 2.0, device=DEV),
                     w=torch.as_tensor(w, dtype=torch.float32, device=DEV),
                     kappa=torch.as_tensor(kappa, dtype=torch.float32,
                                           device=DEV),
                     noise=torch.tensor(0.5, device=DEV))
    if distinct:
        lam = torch.linalg.eigvalsh(mo.coregion_matrix(p).double())
        gap = float((lam[1:] - lam[:-1]).min() / lam[-1])
        print(f"ICM T={t} with distinct B: eigenvalues "
              f"{[round(float(v), 4) for v in lam]}, smallest gap {gap:.3e} "
              f"of the largest", flush=True)
        check(gap > 1e-3, "the distinct-B instance has close eigenvalues")
    return (p, torch.as_tensor(x, dtype=torch.float32, device=DEV),
            torch.as_tensor(y, dtype=torch.float32, device=DEV))


def _icm_case(torch, gt):
    """(d) ICM at N = 4096, T = 4: the kron and dense logML and their
    gradients timed on the bench problem, its values against the dense
    float64 logML; the gradients held on the instance with distinct B
    eigenvalues (every leaf; the kron float64 gradient against the dense
    one); the base Gram against float64; an LMC (Q = 2) and a masked case
    on the dense path, fit to 1,024 points."""
    from gpx_torch.models import multioutput as mo

    p, x, Y = _icm_problem(torch, gt, N_ICM, T_ICM)
    pd, _, _ = _icm_problem(torch, gt, N_ICM, T_ICM, distinct=True)
    out = {"gram_err": _hold_gram(torch, gt, "(d) ICM Kxx", p.kernel, x,
                                  nugget=0.0)}
    names = ["value", "dh", "dsigma", "dw", "dkappa", "dnoise"]

    def lml(q, x_, Y_, method):
        return _value_and_grads(torch, gt, lambda r: mo.log_marginal_likelihood(
            r, x_, Y_, method=method), q)

    # the oracle: the dense logML and its gradient in float64
    p64, pd64, x64, Y64 = _to64(gt, p), _to64(gt, pd), x.double(), Y.double()
    ref, refd = lml(p64, x64, Y64, "dense"), lml(pd64, x64, Y64, "dense")
    for method in ("kron", "dense"):
        f32, wall, launches = _counted(torch, lambda: lml(p, x, Y, method))
        ms = 1e3 * min(_counted(torch, lambda: lml(p, x, Y, method))[1]
                       for _ in range(2))
        own = lml(p64, x64, Y64, method)
        with _PlainRoutes():
            wit = lml(p, x, Y, method)
        print(f"(d) ICM {method} N={N_ICM} T={T_ICM}: value {float(f32[0]):.8e} "
              f"(float64 {float(own[0]):.8e}); {ms:.2f} ms per value + "
              f"gradient; launches per eval {json.dumps(_per(launches, 1))}",
              flush=True)
        check(launches["gram"] >= 1, f"(d) ICM {method}: the Gram kernel was "
              f"not launched")
        kron = method == "kron"
        err = _hold_model(f"(d) ICM {method}", names[:1], f32[:1], ref[:1],
                          wit[:1], [VALUE_REL], own64=own[:1] if kron else None)
        g32, gown = lml(pd, x, Y, method), lml(pd64, x64, Y64, method)
        with _PlainRoutes():
            gwit = lml(pd, x, Y, method)
        err = max(err, _hold_model(
            f"(d) ICM {method} (distinct B)", names, g32, refd, gwit,
            [VALUE_REL] + [GRAD_REL] * (len(names) - 1),
            own64=gown if kron else None))
        if kron:
            # eigh's VJP is defined where B's eigenvalues are distinct: the
            # kron float64 gradient is the dense one's
            for nm, a, b in zip(names, gown, refd):
                e = _rel(a, b)
                print(f"(d) ICM kron (distinct B) float64 {nm}: {e:.3e} of the "
                      f"dense float64's norm (limit 1e-6)", flush=True)
                check(e <= 1e-6, f"(d) kron float64 {nm} misses the dense one")
        out[method] = {"ms": ms, "value64": float(own[0]), "err": err}
    gap = abs(out["kron"]["value64"] - out["dense"]["value64"])
    print(f"(d) kron - dense in float64: {gap:.3e} (limit 1e-6 of "
          f"{abs(out['dense']['value64']):.6e})", flush=True)
    check(gap <= 1e-6 * abs(out["dense"]["value64"]), "(d) kron and dense "
          "disagree in float64")

    lmc = mo.lmc([gt.se(2.0, 2.0, device=DEV),
                  gt.matern(1.0, 1.5, 2.0, device=DEV)], T_ICM, noise=0.5)
    mask = np.random.default_rng(3).uniform(size=(N_ICM, T_ICM)) >= 0.1

    def lmc_vg(q, x_, Y_):
        return _value_and_grads(torch, gt, lambda r: mo.log_marginal_likelihood(
            r, x_, Y_), q)

    f32, f64, fw = _three(torch, gt, lmc_vg, lmc, x, Y)
    lnames = ["value"] + [f"d{i}" for i in range(len(gt.params.leaves(lmc)))]
    out["lmc_err"] = _hold_model("(d) LMC dense", lnames, f32, f64, fw,
                                 [VALUE_REL] + [GRAD_REL] * (len(lnames) - 1))

    def masked(q, x_, Y_):
        return [mo.log_marginal_likelihood(q, x_, Y_, mask=mask)]

    f32, f64, fw = _three(torch, gt, masked, p, x, Y)
    out["masked_err"] = _hold_model("(d) ICM masked", ["value"], f32, f64, fw,
                                    [VALUE_REL])
    xs = torch.linspace(-10.0, 10.0, S_ICM, device=DEV)[:, None]

    def fit(q, x_, Y_, xs_):
        s = mo.fit(q, x_, Y_, xs_)
        return [s.mean, s.variance]

    f32, f64, fw = _three(torch, gt, fit, p, x, Y, xs)
    out["fit_err"] = _hold_model("(d) ICM fit (kron)", ["mean", "variance"],
                                 f32, f64, fw, [MEAN_LIMIT, VAR_LIMIT])
    return out


def _mf_noise(torch, gi, seed, n, t, s):
    """The base noise logml_value_and_grad_iterative draws with a
    preconditioner from a generator seeded ``seed``: the Rademacher probe
    base, then the Normal SLQ base, (N, T, s) each, float32."""
    key = torch.Generator(device=DEV).manual_seed(seed)
    return (gi._rademacher(key, (n, t, s), torch.float32, DEV),
            gi._normal(key, (n, t, s), torch.float32, DEV))


class _AlignedEigh:
    """Inside: ``chol.eigh`` of a matrix shaped as ``ref`` returns its
    eigenvectors with the signs of ``ref``'s columns. B's eigenvectors are
    unique up to sign where its eigenvalues are distinct, so a float64 run
    of the matrix-free estimator then rotates its probes by the float32
    run's basis: the same estimator on the same probes."""

    def __init__(self, ref):
        self.ref = ref

    def __enter__(self):
        from gpx_torch.ops import chol

        self._saved = eigh = chol.eigh
        ref = self.ref

        def aligned(a):
            lam, q = eigh(a)
            if a.shape == ref.shape:
                q = q * (q * ref.to(q.dtype)).sum(dim=0).sign()
            return lam, q

        chol.eigh = aligned

    def __exit__(self, *exc):
        from gpx_torch.ops import chol

        chol.eigh = self._saved


def _matrix_free_case(torch, gt, dense_small):
    """(e) The matrix-free ICM at N = 16,384, T = 8 (16 probes, 32 Lanczos
    steps, cg_tol 1e-5, rank-64 Kronecker preconditioner): ms/eval, CG
    iterations and launches on the bench problem; gram_matvec at the T R =
    136 columns of its CG block and cross_matvec at fit_iterative's shape
    against float64; the value and every leaf's gradient against the same
    estimator in float64 on the same probes, on the instance with distinct
    B eigenvalues; at N = 4096, T = 4, four seeds against the dense float64
    logML of (d); fit_iterative's mean to 1,024 points against float64."""
    from gpx_torch.models import gp_iterative as gi
    from gpx_torch.models import multioutput as mo
    from gpx_torch.models import multioutput_iterative as mi
    from gpx_torch.ops import chol

    p, x, Y = _icm_problem(torch, gt, N_MF, T_MF)
    key = torch.Generator(device=DEV).manual_seed(0)
    res, wall, launches = _counted(torch, lambda: mi.logml_value_and_grad_iterative(
        p, x, Y, key, **MF))
    ms = [1e3 * _counted(torch, lambda: mi.logml_value_and_grad_iterative(
        p, x, Y, torch.Generator(device=DEV).manual_seed(0), **MF))[1]
        for _ in range(3)]
    print(f"(e) matrix-free ICM N={N_MF} T={T_MF}: {statistics.median(ms):.2f} ms"
          f"/eval (median of {[round(v, 2) for v in ms]}); CG {res.cg_iters} "
          f"iterations, converged {res.cg_converged}; launches per eval "
          f"{json.dumps(_per(launches, 1))}", flush=True)
    check(launches["gram_matvec"] > 0, "(e) gram_matvec was not launched")
    check(res.cg_converged, "(e) CG did not converge")
    gen = torch.Generator(device=DEV).manual_seed(5)
    k64 = _f64_kernel(gt, p.kernel)
    r = T_MF * (MF["n_probes"] + 1)
    xs = torch.linspace(-10.0, 10.0, S_ICM, device=DEV)[:, None]
    mv_err = max(
        _hold_gram_matvec(torch, f"(e) gram_matvec n={N_MF} d=1 r={r} (T R)",
                          p.kernel, k64, x, torch.randn(
                              (N_MF, r), generator=gen, device=DEV), 0.0),
        _hold_cross_matvec(torch, f"(e) cross_matvec ({S_ICM}, {N_MF}) d=1 "
                           f"r={T_MF}", p.kernel, k64, xs, x, torch.randn(
                               (N_MF, T_MF), generator=gen, device=DEV)))

    pd, _, _ = _icm_problem(torch, gt, N_MF, T_MF, distinct=True)
    pn, sn = _mf_noise(torch, gi, 0, N_MF, T_MF, MF["n_probes"])
    core = {k: MF[k] for k in ("lanczos_iters", "cg_tol", "precond_rank")}

    def est(q, x_, Y_, pn_, sn_):
        r = mi._logml_value_and_grad_iterative(q, x_, Y_, probe_noise=pn_,
                                               slq_noise=sn_, **core)
        return [r.value] + list(gt.params.leaves(r.grads))

    first = mi.logml_value_and_grad_iterative(
        pd, x, Y, torch.Generator(device=DEV).manual_seed(0), **MF)
    f32 = est(pd, x, Y, pn, sn)
    check(float(f32[0]) == float(first.value), "(e) replayed noise differs")
    qb32 = chol.eigh(mo.coregion_matrix(pd))[1]
    qb64 = chol.eigh(mo.coregion_matrix(_to64(gt, pd)))[1]
    flips = int(((qb32.double() * qb64).sum(dim=0) < 0).sum())
    with _AlignedEigh(qb32):
        f64 = est(_to64(gt, pd), x.double(), Y.double(), pn.double(),
                  sn.double())
        basis = float((chol.eigh(mo.coregion_matrix(_to64(gt, pd)))[1]
                       - qb32.double()).abs().max())
    with _PlainRoutes():
        fw = est(pd, x, Y, pn, sn)
    print(f"(e) distinct B: float64 eigh(B) columns with the other sign "
          f"{flips} of {T_MF}, aligned to float32's; then max |diff| {basis:.3e}"
          f" (limit 1e-4)", flush=True)
    check(basis <= 1e-4, "(e) the float64 oracle rotates by another basis")
    names = ["value", "dh", "dsigma", "dw", "dkappa", "dnoise"]
    err = _hold_model("(e) matrix-free (distinct B)", names, f32, f64, fw,
                      [VALUE_REL] + [GRAD_REL] * (len(names) - 1))

    ps, xs4, Ys = _icm_problem(torch, gt, N_ICM, T_ICM)
    vals = [float(mi.logml_value_and_grad_iterative(
        ps, xs4, Ys, torch.Generator(device=DEV).manual_seed(s), **MF).value)
        for s in range(4)]
    limit = 5e-3 * abs(dense_small) + 0.5
    print(f"(e) N={N_ICM} T={T_ICM}: estimates {[round(v, 3) for v in vals]} "
          f"(sd {statistics.stdev(vals):.3f}) against the dense float64 logML "
          f"{dense_small:.4f}; each within {limit:.3f} (the JAX package's "
          f"tests' limit, 5e-3 |value| + 0.5)", flush=True)
    check(all(abs(v - dense_small) <= limit for v in vals),
          "(e) an estimate misses the dense float64 logML")

    def fit(q, x_, Y_, xs_):
        return [mi.fit_iterative(q, x_, Y_, xs_, cg_tol=MF["cg_tol"],
                                 precond_rank=MF["precond_rank"],
                                 variance="none").mean]

    post, wall_f, fl = _counted(torch, lambda: fit(p, x, Y, xs))
    print(f"(e) fit_iterative (mean) N={N_MF} T={T_MF} -> {S_ICM} points: "
          f"{1e3 * wall_f:.2f} ms; launches {json.dumps(fl)}", flush=True)
    check(fl["cross_matvec"] > 0, "(e) fit_iterative did not launch cross_matvec")
    check(fl["gram_matvec"] > 0, "(e) fit_iterative did not launch gram_matvec")
    f32, f64, fw = _three(torch, gt, fit, p, x, Y, xs)
    ferr = _hold_model("(e) fit_iterative", ["mean"], f32, f64, fw, [MEAN_LIMIT])
    return {"ms_per_eval": statistics.median(ms), "cg_iters": res.cg_iters,
            "launches_per_eval": _per(launches, 1), "err": err,
            "matvec_err": mv_err, "cg_iters_distinct": first.cg_iters,
            "small_estimates": vals, "fit_ms": 1e3 * wall_f, "fit_err": ferr,
            "fit_launches": fl}


def _fd_check(torch, gt, label, value, tree, grads, rel=1e-6, limit=1e-4):
    """The float64 oracle's gradient through eigh against central
    differences of its value (step ``rel`` of each scalar leaf): its
    eigenvectors' VJP divides by eigenvalue gaps, which the value does not;
    each leaf within ``limit`` of the gradient's norm."""
    ls = gt.params.leaves(tree)
    norm = math.sqrt(sum(float(g) ** 2 for g in grads))
    for i, (t, g) in enumerate(zip(ls, grads)):
        h = rel * max(abs(float(t)), 1.0)
        vals = []
        for sgn in (1.0, -1.0):
            moved = [u + sgn * h if j == i else u for j, u in enumerate(ls)]
            vals.append(float(value(gt.params.unflatten(tree, moved))))
        fd = (vals[0] - vals[1]) / (2.0 * h)
        e = abs(fd - float(g)) / norm
        print(f"{label} float64 d{i}: autograd {float(g):.8e} central "
              f"difference {fd:.8e} ({e:.3e} of the gradient's norm, limit "
              f"{limit:g})", flush=True)
        check(e <= limit, f"{label}: the float64 gradient misses its central "
              f"difference")


def _grid_case(torch, gt):
    """(f) benchmarks/grid_scale.py's lattice, 4096 x 64 at seed 42: SE(2, 2)
    on the 1-D axis, Matern(1, 3/2, 1) on the 64 points of the D = 2 axis,
    noise 0.5: the logML and its full gradient against float64 (through
    both axes' eigh), then fit to 1,024 points."""
    from gpx_torch.models import gridgp

    n1, n2 = GRID
    rng = np.random.default_rng(42)
    a1 = np.sort(rng.uniform(-10, 10, n1))[:, None]
    a2 = rng.uniform(-2, 2, size=(n2, 2))
    y = 3.0 * np.sin(0.7 * a1) + 0.5 * rng.normal(size=(n1, n2))
    axes = [torch.as_tensor(a, dtype=torch.float32, device=DEV) for a in (a1, a2)]
    Y = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    p = gridgp.grid([gt.se(2.0, 2.0, device=DEV),
                     gt.matern(1.0, 1.5, 1.0, device=DEV)], noise=0.5)

    def lml(q, a1_, a2_, Y_):
        return _value_and_grads(torch, gt, lambda r: gridgp.log_marginal_likelihood(
            r, [a1_, a2_], Y_), q)

    f32, f64, fw = _three(torch, gt, lml, p, *axes, Y)
    _, _, per_eval = _counted(torch, lambda: lml(p, *axes, Y))
    ms = [1e3 * _counted(torch, lambda: lml(p, *axes, Y))[1] for _ in range(3)]
    ms_v = [1e3 * _counted(torch, lambda: gridgp.log_marginal_likelihood(
        p, axes, Y))[1] for _ in range(3)]
    print(f"(f) grid {n1} x {n2}: logML {statistics.median(ms_v):.2f} ms/eval, "
          f"with its gradient {statistics.median(ms):.2f} ms/eval (medians of "
          f"{[round(v, 2) for v in ms_v]}, {[round(v, 2) for v in ms]}); value "
          f"{float(f32[0]):.8e} (float64 {float(f64[0]):.8e}); launches per "
          f"eval {json.dumps(_per(per_eval, 1))}", flush=True)
    check(per_eval["gram"] >= 2, "(f) grid: the Gram kernel was not launched "
          "for both axes")
    gerr = max(_hold_gram(torch, gt, f"(f) grid axis {i}", k, a, nugget=0.0)
               for i, (k, a) in enumerate(zip(p.kernels, axes)))
    names = ["value"] + ["d" + n for n in ("se_h", "se_sigma", "matern_sigma",
                                           "matern_l", "noise")]
    err = _hold_model("(f) grid", names, f32, f64, fw,
                      [VALUE_REL] + [GRAD_REL] * (len(names) - 1))
    _fd_check(torch, gt, "(f) grid", lambda q: gridgp.log_marginal_likelihood(
        q, [a.double() for a in axes], Y.double()), _to64(gt, p), f64[1:])
    xs = torch.cat([torch.linspace(-10.0, 10.0, S_ICM, device=DEV)[:, None],
                    torch.zeros((S_ICM, 2), device=DEV)], dim=1)

    def fit(q, a1_, a2_, Y_, xs_):
        s = gridgp.fit(q, [a1_, a2_], Y_, xs_)
        return [s.mean, s.variance]

    f32, f64, fw = _three(torch, gt, fit, p, *axes, Y, xs)
    ferr = _hold_model("(f) grid fit", ["mean", "variance"], f32, f64, fw,
                       [MEAN_LIMIT, VAR_LIMIT])
    return {"ms_per_eval": statistics.median(ms_v),
            "ms_per_eval_with_grad": statistics.median(ms), "err": err,
            "gram_err": gerr,
            "fit_err": ferr, "launches_per_eval": _per(per_eval, 1)}


def phase_models(torch, gt):
    """Phase 7: the sparse and multi-output models at full width, (a)-(f),
    each part's seconds."""
    out, secs = {}, {}
    x, y = _svgp_data(torch, N_SVGP)
    for name, fn in (("sgpr", lambda: _sgpr_case(torch, gt, x, y)),
                     ("svgp", lambda: _svgp_case(torch, gt, x, y)),
                     ("svgp_mo", lambda: _mo_svgp_case(torch, gt, x))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    del x, y
    for name, fn in (("icm", lambda: _icm_case(torch, gt)),
                     ("matrix_free", lambda: _matrix_free_case(
                         torch, gt, out["icm"]["dense"]["value64"])),
                     ("grid", lambda: _grid_case(torch, gt))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = secs
    out["not_held"] = list(NOT_HELD)
    out["second_limit"] = list(SECOND_LIMIT)
    print(f"phase 7: {len(NOT_HELD)} outputs not held (float32 algorithm): "
          f"{json.dumps(NOT_HELD)}", flush=True)
    # the kron and grid gradients hold the eigenbases constant: no eigh VJP
    eig = [s for s in NOT_HELD
           if s.startswith(("(d) ICM kron", "(f) grid value", "(f) grid d"))]
    check(not eig, f"phase 7: the eigenbasis gradients not held: {eig}")
    rounded = {k: round(v, 1) for k, v in secs.items()}
    print(f"phase 7 seconds: {json.dumps(rounded)}", flush=True)
    return out


# -- phase 8: classification and the state-space models ---------------------

N_CL, M_CL, C_CL, D_CL = 8192, 2048, 10, 784   # MNIST's shape, blob digits
N_MC = 2000                       # predict's Monte-Carlo draws (its default)
CL_REL = 1e-3                     # f, pi, mu and sigma: normwise
# Newton steps at most, cut in depth from fit's 50: float64 stops by its
# tol within it (3 and 9 steps), float32 cannot resolve tol at |psi| ~ 1e4
# and ran all 50 (27 s on an H100 80GB HBM3 at 700 W)
MAX_NEWTON = 12
T_TEMP, AHEAD = 1008, 48          # temperature_dlm.py: six weeks hourly
N_SENSORS = 8
T_GP, GRID_SIDE, T_NET = 200, 16, 720   # dlm_gp.py's case; the network's
DLM_REL = 1e-3                    # the filters' and smoother's outputs
# Gibbs sweeps, cut in depth from the examples' 500 so that phase 8 fits
# its time (on an H100 80GB HBM3 at 700 W, 4.7 s a sweep of the temperature
# DLM, 4.5 s of the 256-sensor DLM-GP: launch-bound loops over time);
# widths (classes, D, d_state, sensors) are never cut
SWEEPS, EXAMPLE_SWEEPS = 3, 500
LOCKSTEP_N = (2048, 4096, 8192)   # --newton-lockstep's sizes


def _hold_lazy(label, names, got, want, base, witness=None):
    """``_hold_model`` with the float32 plain route (``witness()``) run only
    where an output misses its base limit or is not finite: at D = 784 the
    plain route is as dear as the kernel route. ``witness=None``: a path
    with no CUDA kernel (the DLM's), whose float32 plain route is itself,
    so each output is held within its base limit. Returns the largest
    error."""
    miss = witness is not None and any(
        not bool(g.isfinite().all()) or _rel(g, w) > b
        for g, w, b in zip(got, want, base))
    return _hold_model(label, names, got, want, witness() if miss else want,
                       base)


def _digits(torch):
    """examples/mnist_classify.py's synthetic blob digits at MNIST's shape:
    ``synthetic_digits`` (numpy seed 0; C = 10 centres ~ 2 N(0, I) in D =
    784, each class's 1024 points its centre + 0.8 N(0, I)), then the
    example's permutation from the same generator; the first N = 8192
    train, the next M = 2048 test, float32 on the card."""
    rng = np.random.default_rng(0)
    n_per = (N_CL + M_CL) // C_CL
    centers = rng.normal(size=(C_CL, D_CL)) * 2.0
    xs = np.concatenate([centers[c] + rng.normal(size=(n_per, D_CL)) * 0.8
                         for c in range(C_CL)]).astype(np.float32)
    ys = np.repeat(np.arange(C_CL), n_per)
    perm = rng.permutation(len(xs))
    xs, ys = xs[perm], ys[perm]
    return (torch.as_tensor(xs[:N_CL], device=DEV),
            torch.as_tensor(ys[:N_CL], device=DEV),
            torch.as_tensor(xs[N_CL:N_CL + M_CL], device=DEV),
            ys[N_CL:N_CL + M_CL])


def _class_kernels(torch, gt, x):
    """A list of C SE + White kernels whose lengthscales are spread
    geometrically over 0.5-2x the median pairwise distance of the first
    2048 training points, so that every class's Gram is dense."""
    med = float(torch.pdist(x[:2048].double()).median())
    return med, [gt.se(1.0, float(l), device=DEV) + gt.white(0.1, device=DEV)
                 for l in med * np.geomspace(0.5, 2.0, C_CL)]


def _f64_kernels(gt, kernels):
    if isinstance(kernels, list):
        return [_f64_kernel(gt, k) for k in kernels]
    return _f64_kernel(gt, kernels)


def _gram_784(torch, gt, kern, x, xs):
    """The Gram kernel at classification's shapes, (8192, 784) with the
    fit's jitter and the 8192 x 2048 cross block: against float64 within
    FAMILY_ULPS + (D + 2) / 2 f32 ulps of each entry's scale (r2 is a
    784-term float32 sum: its rounding is at most (D + 2) u r2, which
    moves K by (D + 2) / 2 u of the scale's 2 r2 |dK/dr2|), and its
    time beside the FP32 bound and the fill floor (writing N M floats).
    The bound counts 3 D operations (a difference, a multiply, an add)
    for each r2 the function needs: N (N + 1) / 2 of them for the square
    Gram, which is symmetric, N M for the cross block."""
    from gpx_torch.ops import cuda_gram

    d = x.shape[1]
    ulps = FAMILY_ULPS + (d + 2) / 2.0
    out = {"err": max(
        _hold_gram(torch, gt, "(a) classify K + 1e-6 I", kern, x, nugget=1e-6,
                   ulps=ulps),
        _hold_gram(torch, gt, "(a) classify cross", kern, x, nugget=0.0, x2=xs,
                   ulps=ulps))}
    for name, m, fn in (
            ("square", x.shape[0],
             lambda: cuda_gram.gram_cuda(kern, x, nugget=1e-6)),
            ("cross", xs.shape[0], lambda: cuda_gram.gram_cuda(kern, x, xs))):
        n = x.shape[0]
        fn()
        ms, all_ms = _median_ms(torch, fn)
        fill_ms = _median_ms(torch, lambda: torch.empty(
            (n, m), device=DEV).fill_(1.0))[0]
        square = name == "square"
        pairs = n * (n + 1) / 2.0 if square else n * m
        bound = bound_ms(flops=3.0 * pairs * d, nbytes=4.0 * (
            n * m + (n if square else n + m) * d))
        print(f"(a) gram {name} {n} x {m} d={d}: {ms:.3f} ms (median of "
              f"{all_ms}), bound {bound[0]:.3f} ms ({bound[1]}), fill floor "
              f"{fill_ms:.3f} ms", flush=True)
        out[name] = {"ms": ms, "bound_ms": bound[0], "fill_ms": fill_ms}
    return out


def _n_iters_reason(torch, classify, r32, tol=1e-4):
    """Why float32's Newton count may differ from float64's: the stopping
    rule compares float32 values of psi = log p(y | f) - a^T f / 2, a sum
    of n = C N + 2 N terms, whose rounding in any summation order is
    bounded by (n - 1) u sum |terms| (u = eps / 2), and no smaller than
    what the log-likelihood's terms alone give; where that bound exceeds
    tol, float32 may stop at another step than float64, or run to
    max_iters. Returns the bound and the reason as text."""
    f, y1 = r32.f.double(), r32.y_onehot.double()
    c, n = f.shape
    terms = float(torch.sum(torch.abs(torch.sum(y1 * f, dim=0)))
                  + torch.sum(torch.abs(torch.logsumexp(f, dim=0))))
    bound = (c * n + 2 * n - 1) * 0.5 * EPS32 * terms
    return bound, (f"float32's psi sums {c * n + 2 * n} terms, the "
                   f"log-likelihood's of |.| {terms:.1f}: its rounding may "
                   f"reach {bound:.2e}, {'above' if bound > tol else 'not above'}"
                   f" tol {tol:g}")


def _classify_case(torch, gt, label, kern, x, y, xs, y_test):
    """fit, latent_predict and predict for one kernel set, in float32 on the
    card against the same code in float64."""
    from gpx_torch.models import classify

    kern64 = _f64_kernels(gt, kern)
    torch.cuda.reset_peak_memory_stats()
    r32, wall, launches = _counted(torch, lambda: classify.fit(
        x, kern, y, C_CL, max_iters=MAX_NEWTON))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r64, wall64, _ = _counted(torch, lambda: classify.fit(
        x.double(), kern64, y, C_CL, max_iters=MAX_NEWTON))
    n32, n64 = int(r32.n_iters), int(r64.n_iters)
    check(n64 < MAX_NEWTON, f"(a) {label}: float64 took all {MAX_NEWTON} "
          f"Newton steps: the cut in depth changed its mode")
    per_it = 1e3 * wall / (n32 + 1)   # the loop's steps and the final one
    print(f"(a) classify {label}: fit {1e3 * wall:.1f} ms ({n32} Newton "
          f"iterations + the final step: {per_it:.1f} ms each), float64 "
          f"{1e3 * wall64:.1f} ms ({n64} iterations); peak memory "
          f"{peak:.2f} GiB; launches {json.dumps(_per(launches, 1))}",
          flush=True)
    check(launches["gram"] == C_CL, f"(a) {label}: {launches['gram']} Gram "
          f"launches per fit, not {C_CL}")
    if n32 != n64:
        bound, why = _n_iters_reason(torch, classify, r32)
        print(f"(a) classify {label}: n_iters {n32} in float32, {n64} in "
              f"float64: {why}", flush=True)
        check(bound > 1e-4, f"(a) {label}: the Newton counts differ where "
              f"float32 resolves the stopping rule")
    else:
        print(f"(a) classify {label}: n_iters {n32}, as in float64", flush=True)

    plain = []

    def witness_fit():
        if not plain:
            with _PlainRoutes():
                plain.append(classify.fit(x, kern, y, C_CL,
                                          max_iters=MAX_NEWTON))
        return plain[0]

    names = ["log_marginal", "f", "pi"]
    err = _hold_lazy(f"(a) classify {label} fit", names,
                     [r32.log_marginal, r32.f, r32.pi],
                     [r64.log_marginal, r64.f, r64.pi],
                     [VALUE_REL, CL_REL, CL_REL],
                     lambda: (lambda r: [r.log_marginal, r.f, r.pi])(
                         witness_fit()))
    (mu, sigma), wall_lp, lp_launches = _counted(
        torch, lambda: classify.latent_predict(r32, x, kern, xs))
    mu64, sigma64 = classify.latent_predict(r64, x.double(), kern64,
                                            xs.double())
    print(f"(a) classify {label}: latent_predict {1e3 * wall_lp:.1f} ms at M = "
          f"{xs.shape[0]}; launches {json.dumps(_per(lp_launches, 1))}",
          flush=True)
    check(lp_launches["gram"] == C_CL, f"(a) {label}: latent_predict's cross "
          f"Grams did not go through the Gram kernel")

    def witness_lp():
        with _PlainRoutes():
            return list(classify.latent_predict(witness_fit(), x, kern, xs))

    err = max(err, _hold_lazy(f"(a) classify {label} latent_predict",
                              ["mu", "sigma"], [mu, sigma], [mu64, sigma64],
                              [CL_REL, CL_REL], witness_lp))
    diag = torch.diagonal(sigma, dim1=1, dim2=2)
    print(f"(a) classify {label}: sigma's smallest diagonal entry "
          f"{float(diag.min()):.4e}", flush=True)
    check(bool((diag >= 0).all()), f"(a) {label}: a negative latent variance")
    gen = torch.Generator(device=DEV).manual_seed(1)
    probs, wall_p, _ = _counted(torch, lambda: classify.predict(
        gen, r32, x, kern, xs, n_mc=N_MC))
    acc = float(np.mean(probs.argmax(-1).cpu().numpy() == y_test))
    rows = float((probs.sum(-1) - 1.0).abs().max())
    print(f"(a) classify {label}: predict (n_mc = {N_MC}) {1e3 * wall_p:.1f} "
          f"ms, held-out accuracy {acc:.4f} on {len(y_test)} points; rows sum "
          f"to 1 within {rows:.2e}", flush=True)
    check(bool(probs.isfinite().all()) and rows <= 1e-5,
          f"(a) {label}: predict's probabilities")
    return {"fit_ms": 1e3 * wall, "fit64_ms": 1e3 * wall64, "n_iters": n32,
            "n_iters64": n64, "ms_per_newton": per_it, "peak_gib": peak,
            "latent_ms": 1e3 * wall_lp, "predict_ms": 1e3 * wall_p,
            "accuracy": acc, "err": err}


def _first_newton_step(torch, gt, label, kern, x, y):
    """The first Newton step from f = 0 at full width, ``(f_1, a_1, E,
    chol(sum_c E_c), z)`` on the fit's Grams, in float32 on the card
    against float64, each under ``_hold_model``'s rule; here an output
    not held fails. E, its factor and z carry the batched (C, N, N) work;
    ``f_1 = K a_1`` carries E's rounding times K's norm (``a_1 = b - E K
    b + ...`` cancels), hence E's sums in float64."""
    from gpx_torch.models import classify
    from gpx_torch.ops.gram import gram

    def step(kern_, x_):
        k = torch.stack([gram(kc, x_, nugget=1e-6) for kc in kern_])
        f0 = torch.zeros((C_CL, x_.shape[0]), dtype=k.dtype, device=k.device)
        y1 = classify.encode_labels(y, C_CL).to(k.dtype)
        f1, a1, _, e, m_chol, z = classify._newton_quantities(f0, k, y1)
        return [f1, a1, e, m_chol, z]

    before = len(NOT_HELD)
    got = step(kern, x)
    want = step(_f64_kernels(gt, kern), x.double())
    with _PlainRoutes():
        wit = step(kern, x)
    err = _hold_model(f"(a) classify {label} first Newton step",
                      ["f_1", "a_1", "E", "chol(sum E)", "z"], got, want, wit,
                      [CL_REL] * 4 + [VALUE_REL])
    check(len(NOT_HELD) == before, f"(a) {label}: the first Newton step is "
          f"not held: {NOT_HELD[before:]}")
    return err


def _first_step_stages(torch, k32, k64):
    """The first Newton step's stages at f = 0 (pi = 1/C) in float32
    against float64 on the card, each from float64's input to that stage
    rounded to float32, so each stage's own error shows: the Cholesky
    factor of ``B = I + K / C``, the triangular solve ``L^-1 D^1/2`` and
    the product ``E = inner^T inner`` in float32; on the card and on the
    host's CPU (LAPACK)."""
    n = k32.shape[1]

    def chol(k):
        return torch.linalg.cholesky(
            torch.eye(n, dtype=k.dtype, device=k.device) + k / C_CL)

    def solve(lc):
        sqrt_pi = torch.full((C_CL, n), (1.0 / C_CL) ** 0.5, dtype=lc.dtype,
                             device=lc.device)
        return torch.linalg.solve_triangular(lc, torch.diag_embed(sqrt_pi),
                                             upper=False)

    def stages(k, lc, inner):
        return chol(k), solve(lc), inner.mT @ inner

    lc64 = chol(k64)
    inner64 = solve(lc64)
    want = [lc64, inner64, inner64.mT @ inner64]
    for where, dev in (("card", k32.device), ("host CPU", "cpu")):
        got = stages(k32.to(dev), want[0].float().to(dev),
                     want[1].float().to(dev))
        print(f"first step stages N={n}, {where}: Cholesky factor "
              f"{_rel(got[0], want[0]):.3e}, triangular solve "
              f"{_rel(got[1], want[1]):.3e}, E = inner^T inner in float32 "
              f"{_rel(got[2], want[2]):.3e} of float64's norm", flush=True)
        del got


def phase_newton_lockstep(torch, gt):
    """``--newton-lockstep``: the per-class classifier's Newton loop in
    float32 beside float64 on the card at N = 2048, 4096 and 8192 (the
    first N points of phase 8's data and kernels), MAX_NEWTON steps. Each
    step prints psi in both, f's normwise error, and the local error: the
    float32 step taken from float64's iterate against float64's step, so
    a step's own error is told apart from the loop's compounding. At the
    largest N, the first step's stages (``_first_step_stages``) and the
    whole first step in float32 on the host's CPU and on the card against
    the card's float64."""
    from gpx_torch.models import classify
    from gpx_torch.ops.gram import gram

    x, y, _, _ = _digits(torch)
    _, per_class = _class_kernels(torch, gt, x)
    per64 = _f64_kernels(gt, per_class)
    for n in LOCKSTEP_N:
        k32 = torch.stack([gram(k, x[:n], nugget=1e-6) for k in per_class])
        k64 = torch.stack([gram(k, x[:n].double(), nugget=1e-6)
                           for k in per64])
        y32 = classify.encode_labels(y[:n], C_CL).to(k32.dtype)
        f32 = torch.zeros((C_CL, n), device=DEV)
        f64, a32, a64 = f32.double(), torch.zeros_like(f32), f32.double()

        def psi(f, a, yo):
            return float(-0.5 * torch.sum(a * f)
                         + classify.softmax_log_likelihood(f, yo))

        for it in range(MAX_NEWTON):
            local = classify._newton_quantities(f64.float(), k32, y32)[0]
            f32, a32 = classify._newton_quantities(f32, k32, y32)[:2]
            f64, a64 = classify._newton_quantities(f64, k64, y32.double())[:2]
            print(f"lockstep N={n} step {it + 1}: psi {psi(f32, a32, y32):.6e} "
                  f"(float64 {psi(f64, a64, y32.double()):.6e}); f err "
                  f"{_rel(f32, f64):.3e}, local step err {_rel(local, f64):.3e};"
                  f" max |f| {float(f32.abs().max()):.4e} (float64 "
                  f"{float(f64.abs().max()):.4e})", flush=True)
        if n == LOCKSTEP_N[-1]:
            _first_step_stages(torch, k32, k64)
            zero = torch.zeros((C_CL, n))
            first = [classify._newton_quantities(zero.to(k), k, y.to(k))
                     for k, y in ((k32.cpu(), y32.cpu()), (k32, y32),
                                  (k64, y32.double()))]
            for i, nm in ((0, "f_1"), (1, "a_1"), (3, "E")):
                print(f"first step N={n} {nm}: float32 on the host CPU "
                      f"{_rel(first[0][i], first[2][i].cpu()):.3e}, on the "
                      f"card {_rel(first[1][i], first[2][i]):.3e} of float64's "
                      f"norm", flush=True)
            del first
        del k32, k64
        torch.cuda.empty_cache()


def _classify_phase(torch, gt):
    """(a) softmax-Laplace classification at MNIST's shape."""
    x, y, xs, y_test = _digits(torch)
    med, per_class = _class_kernels(torch, gt, x)
    shared = gt.se(1.0, 8.0, device=DEV) + gt.white(0.1, device=DEV)
    print(f"(a) classify: N = {N_CL}, M = {M_CL}, C = {C_CL}, D = {D_CL}; "
          f"median pairwise distance {med:.2f}; fit's max_iters {MAX_NEWTON} "
          f"(cut in depth from its default 50)", flush=True)
    out = {"gram": _gram_784(torch, gt, per_class[0], x, xs),
           "first_step_err": _first_newton_step(
               torch, gt, "per-class SE + White", per_class, x, y)}
    torch.cuda.empty_cache()
    for label, kern in (("se(1, 8) + white(0.1)", shared),
                        ("per-class SE + White", per_class)):
        out[label] = _classify_case(torch, gt, label, kern, x, y, xs, y_test)
        torch.cuda.empty_cache()
    return out


def _temperature_model(gt, dtype):
    from gpx_torch.models import dlm

    base = (dlm.polynomial(1, device=DEV, dtype=dtype)
            + dlm.seasonal(24, 3, device=DEV, dtype=dtype)
            + dlm.seasonal(168, 3, device=DEV, dtype=dtype))
    return dlm.replicate_observations(base, N_SENSORS)


def _temperature_data(model):
    """temperature_dlm.py's simulation with numpy noise (seed 0): x0 = 12
    in the level, 1.5 and 0.8 in the first daily and weekly harmonics; W =
    0.005 I, V = 0.3 I; 10% of the entries NaN."""
    f, g = (t.double().cpu().numpy() for t in (model.f, model.g))
    rng = np.random.default_rng(0)
    x = np.zeros(g.shape[0])
    x[0], x[1], x[7] = 12.0, 1.5, 0.8
    ys = []
    for _ in range(T_TEMP):
        x = g @ x + np.sqrt(0.005) * rng.normal(size=x.shape[0])
        ys.append(f @ x + np.sqrt(0.3) * rng.normal(size=f.shape[0]))
    ys = np.array(ys)
    ys[rng.uniform(size=ys.shape) < 0.1] = np.nan
    return ys


def _device_launches(torch, fn):
    """CUDA kernels launched by ``fn()``, by the profiler's device events;
    None where the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def _temperature_case(torch, gt):
    """(b) temperature_dlm.py's model, polynomial(1) + seasonal(24, 3) +
    seasonal(168, 3) over 8 sensors, on six weeks of hourly data."""
    from gpx_torch.distributions import InverseGamma
    from gpx_torch.models import dlm

    m32, m64 = (_temperature_model(gt, dt) for dt in (torch.float32,
                                                        torch.float64))
    d_obs, d_state = m32.f.shape
    ys_np = _temperature_data(m64)

    def inputs(dtype):
        return dict(ys=torch.as_tensor(ys_np, dtype=dtype, device=DEV),
                    v=torch.full((d_obs,), 0.3, dtype=dtype, device=DEV),
                    w=torch.full((d_state,), 0.005, dtype=dtype, device=DEV),
                    m0=torch.zeros(d_state, dtype=dtype, device=DEV),
                    c0=10.0 * torch.eye(d_state, dtype=dtype, device=DEV))

    a, b = inputs(torch.float32), inputs(torch.float64)
    ms = {}

    def run(model, i, time_it=False):
        def step(name, fn):
            out, wall, _ = _counted(torch, fn)
            if time_it:
                ms[name] = 1e3 * wall
            return out

        dt = i["ys"].dtype
        filt = step("filter", lambda: dlm.kalman_filter(
            model, i["ys"], i["v"], i["w"], i["m0"], i["c0"]))
        s_m, s_c = step("smooth", lambda: dlm.smooth(model, filt))
        f_m, f_c = step("forecast", lambda: dlm.forecast(
            model, filt.m[-1], filt.c[-1], i["v"], i["w"], AHEAD))
        prior = InverseGamma(concentration=torch.tensor(3.0, dtype=dt,
                                                        device=DEV),
                             scale=torch.tensor(1.0, dtype=dt, device=DEV))
        w_star = torch.full_like(i["w"], 0.01)    # temperature_dlm.py's
        conj = step("conjugate filter", lambda: dlm.conjugate_filter(
            model, i["ys"], w_star, i["m0"], i["c0"], prior))
        return filt, [filt.log_likelihood, filt.m, filt.c, s_m, s_c, f_m, f_c,
                      conj.m, conj.forecast_scale, conj.v_scale]

    filt, got = run(m32, a, time_it=True)
    _, want = run(m64, b)
    names = ["log_likelihood", "m", "c", "smooth means", "smooth covs",
             "forecast means", "forecast covs", "conjugate m",
             "conjugate Student-t scales", "conjugate v_scale"]
    err = _hold_lazy("(b) temperature DLM", names, got, want,
                     [VALUE_REL] + [DLM_REL] * (len(names) - 1))
    gen = torch.Generator(device=DEV).manual_seed(0)
    xs, wall, _ = _counted(torch, lambda: dlm.ffbs(gen, m32, filt, a["w"]))
    ms["ffbs"] = 1e3 * wall
    steps = 100                       # the profiler reads a 100-step filter
    launches = _device_launches(torch, lambda: dlm.kalman_filter(
        m32, a["ys"][:steps], a["v"], a["w"], a["m0"], a["c0"]))
    per_step = "not measured" if launches is None else (
        f"{launches / steps:.1f}")
    print(f"(b) temperature DLM: d_state {d_state}, d_obs {d_obs}, T = "
          f"{T_TEMP}, {int(torch.isnan(a['ys']).sum())} NaN entries; ms "
          f"{json.dumps({k: round(v, 1) for k, v in ms.items()})}; device "
          f"kernels per filter step {per_step}", flush=True)
    # FFBS: a draw from the smoothing distribution, held by its z-scores
    # against the smoother's marginals
    s_m, s_c = got[3], got[4]
    z = (xs - s_m) / torch.sqrt(torch.diagonal(s_c, dim1=1, dim2=2))
    inside = float((z.abs() < 4.0).double().mean())
    print(f"(b) FFBS: {inside:.4f} of the draw's entries within 4 sd of the "
          f"smoothed means (limit 0.99)", flush=True)
    check(inside >= 0.99, "(b) FFBS draws are not from the smoother's law")

    prior = InverseGamma(concentration=torch.tensor(3.0, device=DEV),
                         scale=torch.tensor(0.5, device=DEV))
    res, wall_g, _ = _counted(torch, lambda: dlm.gibbs_sample(
        0, m32, a["ys"], prior, prior, a["m0"], a["c0"], SWEEPS))
    ok = all(bool(t.isfinite().all()) for t in res) and bool(
        (res.v > 0).all() and (res.w > 0).all())
    print(f"(b) gibbs_sample: {SWEEPS} sweeps (cut in depth from the "
          f"example's {EXAMPLE_SWEEPS}), {1e3 * wall_g / SWEEPS:.1f} ms per "
          f"sweep; last V mean {float(res.v[-1].mean()):.4f} (truth 0.3), "
          f"last W mean {float(res.w[-1].mean()):.5f} (truth 0.005)",
          flush=True)
    check(ok, "(b) gibbs_sample: a draw is not finite or not positive")
    return {"err": err, "ms": ms,
            "launches_per_step": launches and launches / steps,
            "ms_per_sweep": 1e3 * wall_g / SWEEPS}


def _log_prior_kernel(torch, gt):
    """dlm_gp.py's prior: Gamma(2, 2) on SE's h and sigma and White's
    sigma."""
    pr = gt.distributions.Gamma(concentration=torch.tensor(2.0, device=DEV),
                                rate=torch.tensor(2.0, device=DEV))

    def log_prior(kern):
        c0, c1 = kern.kernels
        return pr.logpdf(c0.h) + pr.logpdf(c0.sigma) + pr.logpdf(c1.sigma)

    return log_prior


def _dlmgp_case(torch, gt, label, locs, t_len):
    """One DLM-GP: dlm_gp.py's truth, a local level shared by the sensors
    with SE(1, 2) + White(0.2) spatial residuals, simulated by the port
    (generator seed 0); its replicated GP likelihood and the filter with V
    = Kxx against float64, the Gram kernel on the sensors against
    float64, and SWEEPS joint Gibbs sweeps."""
    from gpx_torch.distributions import InverseGamma
    from gpx_torch.models import dlm, dlmgp

    n = locs.shape[0]
    model = dlm.replicate_observations(dlm.polynomial(1, device=DEV), n)
    truth = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 2.0, device=DEV)
                          + gt.white(0.2, device=DEV))
    gen = torch.Generator(device=DEV).manual_seed(0)
    (states, ys), wall_s, _ = _counted(torch, lambda: dlmgp.simulate(
        gen, model, truth, locs, torch.tensor(0.01, device=DEV),
        torch.tensor([0.05], device=DEV), torch.zeros(1, device=DEV), t_len))
    check(bool(ys.isfinite().all()), f"(c) {label}: simulate")
    gerr = _hold_gram(torch, gt, f"(c) {label} Kxx", truth.kernel, locs)
    resids = ys - states @ model.f.T
    p64 = gt.Parameters(mean=gt.zero(), kernel=_f64_kernel(gt, truth.kernel))
    kxx64 = p64.kernel.gram(locs.double(), nugget=1e-3)
    m0, c0 = torch.zeros(1, device=DEV), 10.0 * torch.eye(1, device=DEV)
    w = torch.tensor([0.05], device=DEV)

    def outs(p, x_, r_, y_, kxx, m0_, c0_, w_):
        filt = dlm.kalman_filter(dlm.DLM(model.f.to(y_.dtype),
                                         model.g.to(y_.dtype)), y_, kxx, w_,
                                 m0_, c0_)
        return [dlmgp.replicated_log_marginal_likelihood(p, x_, r_),
                filt.log_likelihood, filt.m]

    got = outs(truth, locs, resids, ys, truth.kernel.gram(locs, nugget=1e-3),
               m0, c0, w)
    want = outs(p64, locs.double(), resids.double(), ys.double(), kxx64,
                m0.double(), c0.double(), w.double())

    def witness():
        with _PlainRoutes():
            return outs(truth, locs, resids, ys, truth.kernel.gram(
                locs, nugget=1e-3), m0, c0, w)

    err = _hold_lazy(f"(c) {label}", ["replicated logML",
                                      "filter log-likelihood (V = Kxx)",
                                      "filter means"], got, want,
                     [VALUE_REL, VALUE_REL, DLM_REL], witness)
    template = gt.Parameters(mean=gt.zero(), kernel=gt.se(0.5, 1.0, device=DEV)
                             + gt.white(0.5, device=DEV))
    prior_w = InverseGamma(concentration=torch.tensor(3.0, device=DEV),
                           scale=torch.tensor(0.1, device=DEV))
    res, wall, launches = _counted(torch, lambda: dlmgp.gibbs_sample(
        0, model, ys, locs, template, _log_prior_kernel(torch, gt), prior_w,
        m0, c0, SWEEPS, proposal_scale=0.1))
    per = _per(launches, SWEEPS)
    rate = float(res.accept_rate)
    print(f"(c) {label}: {n} sensors, T = {t_len}; simulate "
          f"{1e3 * wall_s:.1f} ms; gibbs_sample {SWEEPS} sweeps (cut in depth "
          f"from the example's {EXAMPLE_SWEEPS}) {1e3 * wall / SWEEPS:.1f} ms "
          f"per sweep, MH accept rate {rate:.2f}, last kernel draw "
          f"{[round(float(v), 3) for v in res.kernel_flat[-1]]} (truth 1.0, "
          f"2.0, 0.2); launches per sweep {json.dumps(per)}", flush=True)
    check(launches["gram"] == 3 * SWEEPS, f"(c) {label}: {launches['gram']} "
          f"Gram launches in {SWEEPS} sweeps, not 3 a sweep")
    check(all(bool(t.isfinite().all()) for t in res[:3]),
          f"(c) {label}: a Gibbs draw is not finite")
    return {"err": err, "gram_err": gerr, "simulate_ms": 1e3 * wall_s,
            "ms_per_sweep": 1e3 * wall / SWEEPS, "accept_rate": rate,
            "launches_per_sweep": per}


def _dlmgp_phase(torch, gt):
    """(c) examples/dlm_gp.py's 8 sensors (U(0, 5)^2, numpy seed 0) at T =
    200, then a 16 x 16 grid_locations network (256 sensors) at T = 720."""
    from gpx_torch.models import dlmgp

    locs8 = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 5.0, (N_SENSORS, 2)), dtype=torch.float32, device=DEV)
    net = dlmgp.grid_locations((0.0, GRID_SIDE - 1.0), (0.0, GRID_SIDE - 1.0),
                               GRID_SIDE, GRID_SIDE, device=DEV)
    return {"dlm_gp_8": _dlmgp_case(torch, gt, "dlm_gp.py 8 sensors", locs8,
                                    T_GP),
            "network_256": _dlmgp_case(torch, gt, f"{GRID_SIDE} x {GRID_SIDE}"
                                       f" network", net, T_NET)}


def _repaired_gradients(torch, gt):
    """(d) phase 7's kron ICM on multioutput_scale.py's problem as drawn
    (rank-2 W: B's eigenvalue 0.3 twice), whose float32 gradient through
    eigh's VJP was NaN in h and sigma: every leaf held against the dense
    float64 gradient, and the kron's float64 gradient equal to it. Phase 7
    holds the grid's gradient (and the kron's at distinct eigenvalues)."""
    from gpx_torch.models import multioutput as mo

    before = len(NOT_HELD)
    p, x, Y = _icm_problem(torch, gt, N_ICM, T_ICM)
    names = ["value", "dh", "dsigma", "dw", "dkappa", "dnoise"]

    def lml(q, x_, Y_, method):
        return _value_and_grads(torch, gt, lambda r: mo.log_marginal_likelihood(
            r, x_, Y_, method=method), q)

    p64, x64, Y64 = _to64(gt, p), x.double(), Y.double()
    dense64, kron64 = lml(p64, x64, Y64, "dense"), lml(p64, x64, Y64, "kron")
    g32 = lml(p, x, Y, "kron")
    with _PlainRoutes():
        wit = lml(p, x, Y, "kron")
    ms = 1e3 * min(_counted(torch, lambda: lml(p, x, Y, "kron"))[1]
                   for _ in range(3))
    print(f"(d) kron ICM N={N_ICM} T={T_ICM} (B's eigenvalue 0.3 twice): "
          f"{ms:.2f} ms per value + gradient (through eigh's VJP: 100.82 "
          f"ms on an H100 80GB HBM3 at 700 W)", flush=True)
    err = _hold_model("(d) kron ICM, repeated eigenvalue", names, g32, dense64,
                      wit, [VALUE_REL] + [GRAD_REL] * (len(names) - 1),
                      own64=kron64)
    for nm, a, b in zip(names, kron64, dense64):
        e = _rel(a, b)
        print(f"(d) kron float64 {nm}: {e:.3e} of the dense float64's norm "
              f"(limit 1e-6)", flush=True)
        check(e <= 1e-6, f"(d) kron float64 {nm} misses the dense one")
    check(len(NOT_HELD) == before, f"(d) not held: {NOT_HELD[before:]}")
    return {"kron_ms": ms, "kron_err": err}


def phase_statespace(torch, gt):
    """Phase 8: classification and the state-space models at full width,
    (a)-(d), each part's seconds."""
    out, secs = {}, {}
    t_all = time.perf_counter()
    for name, fn in (("classify", lambda: _classify_phase(torch, gt)),
                     ("temperature_dlm", lambda: _temperature_case(torch, gt)),
                     ("dlmgp", lambda: _dlmgp_phase(torch, gt)),
                     ("repaired_gradients",
                      lambda: _repaired_gradients(torch, gt))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = secs
    print(f"phase 8 seconds: {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f", total {time.perf_counter() - t_all:.1f}", flush=True)
    return out

# -- phase 9: the user-facing layer and the examples --------------------------

# The examples' data sizes are gpx's accelerator ones (large_n at 16,384,
# 32,768 and 16,384); their depth is cut from the defaults so that phase 9
# fits its time (on an H100 80GB HBM3 at 700 W, a sweep of the temperature
# DLM takes 4.4-4.7 s and of dlm_gp's DLM-GP ~1 s, phase 8); widths are
# never cut
EX_N = {"dense": 16384, "iterative": 32768, "svgp": 16384}
EX_MH = 300                 # simulated_gp parameters (1000)
EX_EHMC = (20, 20, 20)      # simulated_gp hmc: iterations, --warmup, --k
                            # (1000, 200, 200)
EX_GIBBS = 200              # temperature (1000)
EX_KRIG = 500               # temperature_kriging (1500)
EX_ICM_MH = 100             # temperature_icm's MH (500)
EX_DLM = 3                  # temperature_dlm's Gibbs sweeps (500)
EX_DLMGP = 20               # dlm_gp's Gibbs sweeps (500)
# a random-walk chain's accept rate at cut depth, burn-in included: a
# stuck chain or one that accepts every move fails (MH-within-Gibbs's
# small kernel steps accept ~0.9-0.96)
ACCEPT = (0.05, 0.99)
CSV_SHAPE = (10000, 6)      # phase 9 (a)'s chain
CSV_VALUES = 10 ** 6        # the write timing's values
RESUME_K = 100              # (b): 2k draws against k + checkpoint + k
PHASE9_DIR = "build/phase9"  # under the checkout's root (git-ignored)


def _phase9_dir(name):
    import pathlib

    d = pathlib.Path(__file__).resolve().parent / PHASE9_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def _bitwise64(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and bool((a.view(np.int64) == b.view(np.int64)).all())


def _csv_phase(torch):
    """(a) The native CSV: it must load; the native and Python writers'
    bytes alike on a (10,000 x 6) float64 chain and its read back bitwise
    on both readers; ``write_chains_csv`` of a (4, n, d) tensor on the card;
    both writers' times for 10^6 values (host)."""
    from gpx_torch import io
    from gpx_torch.native import build, load_fastcsv

    lib = load_fastcsv()
    check(lib is not None, "(a) the native fastcsv library did not load")
    print(f"(a) fastcsv loaded from {build.library_path()}", flush=True)
    d = _phase9_dir("csv")
    rng = np.random.default_rng(0)
    flat = rng.normal(size=CSV_SHAPE) * 10.0 ** rng.integers(-30, 30, CSV_SHAPE)
    names = [f"p{i}" for i in range(CSV_SHAPE[1])]
    io.write_chain_csv(d / "native.csv", flat, names)
    io._write_csv_py(d / "python.csv", flat, names)
    same = (d / "native.csv").read_bytes() == (d / "python.csv").read_bytes()
    back_n, got_names = io.read_chain_csv(d / "native.csv")
    back_p = io._read_csv_py(d / "native.csv")
    bitwise = _bitwise64(back_n, flat) and _bitwise64(back_p, flat)
    print(f"(a) {CSV_SHAPE} float64 chain: native and Python bytes alike "
          f"{same}; read back bitwise (native, Python readers) {bitwise}",
          flush=True)
    check(same, "(a) the native and Python writers' bytes differ")
    check(bitwise and got_names == names, "(a) the chain does not read back")
    chains = torch.randn((4, 2500, 6), dtype=torch.float64, device=DEV)
    paths = io.write_chains_csv(d / "chain.csv", chains, names)
    check([p.name for p in paths] == [f"chain_{i}.csv" for i in range(4)],
          "(a) write_chains_csv's file names")
    check(all(_bitwise64(io.read_chain_csv(p)[0], c.cpu().numpy())
              for p, c in zip(paths, chains)), "(a) a chain file differs")
    big = rng.normal(size=(CSV_VALUES // 10, 10))
    ms = {}
    for name, write in (("native", io.write_chain_csv),
                        ("python", io._write_csv_py)):
        t0 = time.perf_counter()
        write(d / f"big_{name}.csv", big, names[:1] * 10)
        ms[name] = 1e3 * (time.perf_counter() - t0)
    print(f"(a) writing 10^6 values (host): native {ms['native']:.1f} ms, "
          f"Python {ms['python']:.1f} ms ({ms['python'] / ms['native']:.1f}x)",
          flush=True)
    return {"write_ms": ms}


def _resume_phase(torch, gt):
    """(b) MH chains on simulated_gp's data: 2k draws against k draws, a
    checkpoint of the final state and the generator, and k more draws from
    the restored ones, bitwise."""
    from gpx_torch import io
    from gpx_torch.examples import simulated_gp
    from gpx_torch.infer import base, mh
    from gpx_torch.models import gp

    x, y = simulated_gp.simulate(torch.Generator(device=DEV).manual_seed(0))
    xobs, yobs = x[::15], y[::15]
    prior = simulated_gp.log_prior_fn(DEV)
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(
        lambda p: prior(p) + gp.log_marginal_likelihood(p, xobs, yobs),
        simulated_gp.template(DEV))
    step = mh.kernel(logpost, mh.gaussian_random_walk(0.12))
    init = mh.init(flat0, logpost)
    k = RESUME_K
    whole = base.sample(step, init, torch.Generator(device=DEV).manual_seed(1),
                        2 * k)
    gen = torch.Generator(device=DEV).manual_seed(1)
    first = base.sample(step, init, gen, k)
    path = io.save_checkpoint(_phase9_dir("resume") / "mh.pt",
                              {"state": first.final_state, "generator": gen})
    saved = (io.load_checkpoint(path) if DEV == "cuda"
             else io.load_checkpoint(path, device=DEV))
    on_card = all(t.device.type == torch.device(DEV).type
                  for t in saved["state"]) and saved["generator"].device.type == torch.device(DEV).type
    rest = base.sample(step, saved["state"], saved["generator"], k)
    joined = [torch.cat([a, b]) for a, b in zip(first.samples, rest.samples)]
    same = all(torch.equal(a, b) for a, b in zip(whole.samples, joined)) and all(
        torch.equal(a, b) for a, b in zip(whole.final_state, rest.final_state))
    acc = int(whole.final_state.accepted) / (2 * k)
    print(f"(b) MH resume on the card: {2 * k} draws against {k} + "
          f"checkpoint + {k}, bitwise {same}; restored on the card {on_card}; "
          f"accept {acc:.3f}", flush=True)
    check(on_card, "(b) the checkpoint did not restore onto the card")
    check(same, "(b) the resumed chain differs from the unbroken one")
    return {"accept": acc}


def _tensors(tree):
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "_fields") and hasattr(node, "buffers"):
            stack.extend(node.buffers())
        elif hasattr(node, "device") and hasattr(node, "is_floating_point"):
            out.append(node)
    return out


EX_MS: dict = {}
SECOND_LIMIT: list = []     # outputs past their base limit on both float32
                            # routes, held within twice the witness's error


def _example(torch, name, argv):
    """``python -m gpx_torch.examples.<name> *argv --no-plots`` through its
    ``main``, on the card by default: every kernel's launches counted,
    its ms, and every output tensor on the card and finite."""
    import importlib

    mod = importlib.import_module(f"gpx_torch.examples.{name}")
    args = [*argv, "--no-plots"] + ([] if DEV == "cuda" else ["--device", DEV])
    out, wall, launches = _counted(torch, lambda: mod.main(args))
    ts = _tensors(out)
    where = {t.device.type for t in ts}
    finite = all(bool(t.isfinite().all()) for t in ts if t.is_floating_point())
    label = f"{name} {' '.join(argv)}".strip()
    EX_MS[label] = 1e3 * wall
    print(f"[{label}] {1e3 * wall:.1f} ms; {len(ts)} output tensors on "
          f"{sorted(where)}, finite {finite}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    check(where == {torch.device(DEV).type}, f"{label}: an output is not on "
          f"the card")
    check(finite, f"{label}: an output is not finite")
    return out, launches


def _hold_scalars(label, names, got, want, limits, witness):
    """Scalars against float64 within ``limits`` (absolute), or, where the
    float32 witness route misses a limit too, within twice its error (the
    second limit; such outputs are listed in SECOND_LIMIT); an output
    outside its limit whose witness is off by more than WITNESS_CAP of the
    value is not held (NOT_HELD)."""
    for nm, g, w, lim, f in zip(names, got, want, limits, witness):
        e, ew = abs(g - w), abs(f - w)
        if e > lim and ew > WITNESS_CAP * abs(w):
            print(f"{label} {nm}: not held (float32 algorithm): f32 {g:.8e} "
                  f"f64 {w:.8e} err {e:.3e}; the float32 witness misses by "
                  f"{ew:.3e}", flush=True)
            NOT_HELD.append(f"{label} {nm}")
            continue
        limit = max(lim, 2.0 * ew)
        print(f"{label} {nm}: f32 {g:.8e} f64 {w:.8e} err {e:.3e} (limit "
              f"{limit:.3e}; base {lim:.3e}, float32 witness {ew:.3e})",
              flush=True)
        check(math.isfinite(g) and e <= limit, f"{label} {nm}: outside its "
              f"limit")
        if e > lim:
            SECOND_LIMIT.append(f"{label} {nm}")


def _ex_large_n(torch, gt):
    """large_n dense (phase 3's launches and limits), iterative (phase 4's
    value limits, both matvec kernels launched) and svgp."""
    from gpx_torch.models import gp, gp_iterative as gi

    n = EX_N["dense"]
    out, launches = _example(torch, "large_n", ["dense", str(n)])
    leaves = -(-n // 128)
    logml = {"gram": 1, "trmm": 3 * (leaves - 1), "syrk_lower": leaves - 1,
             "chol_inv_tile": leaves, "chol_inv_tile_off": leaves,
             "logml_kernel_grads": 1}
    fit = {"gram": 2, "trmm": 3 * (leaves - 1) + 1, "syrk_lower": leaves - 1,
           "chol_inv_tile": leaves, "chol_inv_tile_off": leaves,
           "logml_kernel_grads": 0}
    want = {k: logml[k] + fit[k] for k in logml}
    got = {k: launches[k] for k in logml}
    print(f"large_n dense launches {json.dumps(got)} = the logML's (phase "
          f"3's) {json.dumps(logml)} + fit's {json.dumps(fit)}", flush=True)
    check(got == want and launches["logml_probe_grads"] == 0
          and launches["gram_matvec"] == 0, "large_n dense: not phase 3's "
          "fused route")
    params, x, y = out["params"], out["x"], out["y"]
    want64 = _f64_result(torch, gt, gp, params, x, y)
    keep = gp.FUSED_MIN_N
    gp.FUSED_MIN_N = n + 1
    try:
        witness = _flat_result(gt, *gp.logml_value_and_grad(params, x, y))
    finally:
        gp.FUSED_MIN_N = keep
    got = _flat_result(gt, out["value"], out["grads"])
    # phase 3's limits: value 1e-4 relative, h 0.5 absolute, sigma 1e-2
    # and White 1e-5 relative
    limits = [1e-4 * abs(want64[0]), 0.5, 1e-2 * abs(want64[2]),
              1e-5 * abs(want64[3])]
    _hold_scalars(f"large_n dense n={n}", ["value", "h", "sigma", "white"],
                  got, want64, limits, witness)

    n = EX_N["iterative"]
    out, launches = _example(torch, "large_n", ["iterative", str(n)])
    check(launches["gram_matvec"] > 0 and launches["cross_matvec"] > 0,
          "large_n iterative: a matvec kernel was not launched")
    params, x, y = out["params"], out["x"], out["y"]
    pn, sn = _iter_noise(torch, gi, 0, n, ITER["n_probes"])
    r64 = gi._logml_value_and_grad_iterative(
        _to64(gt, params), x.double(), y.double(), probe_noise=pn.double(),
        slq_noise=sn.double(), lanczos_iters=ITER["lanczos_iters"],
        cg_tol=ITER["cg_tol"], precond_rank=ITER["precond_rank"])
    lmat = torch.linalg.cholesky(_dense_gram64(
        torch, _iter_kernel(gt, torch.float64), x.double(), gp.LOGML_NUGGET))
    z = torch.linalg.solve_triangular(lmat, y.double()[:, None],
                                      upper=False)[:, 0]
    dense = (-0.5 * float(z @ z) - float(torch.log(lmat.diagonal()).sum())
             - 0.5 * n * math.log(2.0 * math.pi))
    del lmat
    _hold_logml(f"large_n iterative n={n}", [float(out["value"])],
                [float(r64.value)], [dense], names=("value",),
                kinds=("value",))
    print(f"large_n iterative: CG {out['cg_iters']} iterations, converged "
          f"{out['cg_converged']}", flush=True)
    check(bool(out["cg_converged"]), "large_n iterative: CG did not converge")
    torch.cuda.empty_cache()

    n = EX_N["svgp"]
    out, launches = _example(torch, "large_n", ["svgp", str(n)])
    tr = out["elbo_trace"]
    first, last = float(tr[:5].mean()), float(tr[-5:].mean())
    print(f"large_n svgp n={n}: {tr.shape[0]} steps, ELBO {first:.1f} -> "
          f"{last:.1f}, noise {float(out['noise']):.4f} (truth 0.49)",
          flush=True)
    check(launches["gram"] > 0, "large_n svgp: the Gram kernel was not launched")
    check(last > first, "large_n svgp: the ELBO did not improve")


def _in_range(label, rates) -> None:
    rates = [float(r) for r in np.atleast_1d(np.asarray(rates, dtype=float))]
    print(f"{label} accept rates {[round(r, 3) for r in rates]} (range "
          f"{ACCEPT})", flush=True)
    check(all(ACCEPT[0] <= r <= ACCEPT[1] for r in rates),
          f"{label}: an accept rate outside {ACCEPT}")


def _ex_simulated_gp(torch, gt):
    """simulated_gp's six commands; ``fit`` held against float64;
    ``posterior-predictive`` reads the chain ``parameters`` wrote."""
    from gpx_torch.examples import simulated_gp
    from gpx_torch.models import gp

    _example(torch, "simulated_gp", ["simulate"])
    _example(torch, "simulated_gp", ["replicate"])
    out, _ = _example(torch, "simulated_gp", ["fit"])
    truth = simulated_gp.truth(DEV)

    def fit(p, x, y, xs):
        s = gp.fit(p, x, y, xs)
        return [s.mean, s.variance]

    _, f64, wit = _three(torch, gt, fit, truth, out["xobs"], out["yobs"],
                         out["xs"])
    _hold_model("simulated_gp fit", ["mean", "variance"],
                [out["mean"], out["variance"]], f64, wit,
                [MEAN_LIMIT, VAR_LIMIT])
    par, _ = _example(torch, "simulated_gp", ["parameters", str(EX_MH)])
    _in_range("simulated_gp parameters (MH)", par["accept_rate"].cpu())
    means = par["flat"].mean((0, 1)).tolist()
    print(f"simulated_gp parameters: posterior means {[round(m, 3) for m in means]}"
          f" (truth 3.0, 5.5, 0.5; {EX_MH} draws, not held)", flush=True)
    hmc, _ = _example(torch, "simulated_gp", ["hmc", str(EX_EHMC[0]),
                                              "--warmup", str(EX_EHMC[1]),
                                              "--k", str(EX_EHMC[2])])
    rates = hmc["accept_rate"].cpu().numpy()
    print(f"simulated_gp hmc (eHMC) accept rates {rates.tolist()}, posterior "
          f"means {[round(m, 3) for m in hmc['flat'].mean((0, 1)).tolist()]}",
          flush=True)
    check(bool(((rates > 0) & (rates <= 1)).all()), "simulated_gp hmc: an "
          "accept rate outside (0, 1]")
    pp, _ = _example(torch, "simulated_gp", ["posterior-predictive", str(EX_MH)])
    thin = max(1, EX_MH // 20)
    want = par["flat"][0].double().cpu().numpy()[::thin]
    same = _bitwise64(pp["flat"], want)
    print(f"simulated_gp posterior-predictive: read gpmcmc_0.csv thinned by "
          f"{thin}, {pp['flat'].shape[0]} rows, bitwise the parameters run's "
          f"chain 0 {same}; curves {tuple(pp['curves'].shape)}", flush=True)
    check(same, "posterior-predictive did not read the chain parameters wrote")
    check(tuple(pp["curves"].shape) == (20, pp["xs"].shape[0]),
          "posterior-predictive: curves' shape")


def _ex_temperature(torch, gt):
    """temperature (MH-within-Gibbs) and temperature_kriging (MH, CSV
    resume, the grid's fit held against float64)."""
    from gpx_torch.examples import temperature_kriging
    from gpx_torch.models import gp

    out, launches = _example(torch, "temperature", [str(EX_GIBBS)])
    _in_range("temperature (MH-within-Gibbs)", out["accept_rate"].cpu())
    print(f"temperature held-out sensor: observed {float(out['observed']):.3f}"
          f", predicted {float(out['mean'][0]):.3f} +- "
          f"{1.64 * float(out['variance'][0].sqrt()):.3f} (90%; not held)",
          flush=True)
    check(launches["gram"] > 0, "temperature: the Gram kernel was not launched")

    out, _ = _example(torch, "temperature_kriging", [str(EX_KRIG)])
    _in_range("temperature_kriging (MH)", out["accept_rate"].cpu())
    fitted = temperature_kriging.fitted_params(out["post_mean"], DEV)

    def fit(p, x, y, xs):
        s = gp.fit(p, x, y, xs)
        return [s.mean, s.variance]

    _, f64, wit = _three(torch, gt, fit, fitted, out["locs"], out["resid"],
                         out["grid"])
    _hold_model("temperature_kriging grid fit", ["mean", "variance"],
                [out["mean"], out["variance"]], f64, wit,
                [MEAN_LIMIT, VAR_LIMIT])


def _ex_icm(torch, gt):
    """temperature_icm: optimize, the forecast at the optimum held against
    float64, the MH run."""
    from gpx_torch.models import multioutput as mo

    out, launches = _example(torch, "temperature_icm", [str(EX_ICM_MH)])
    print(f"temperature_icm: logML {float(out['values'][0]):.2f} -> "
          f"{float(out['value']):.2f}, grad norm {float(out['grad_norm']):.3e}; "
          f"coupling signs {out['signs'].tolist()} (sensor 7 negative: not "
          f"held at cut depth)", flush=True)
    _in_range("temperature_icm (MH)", out["accept_rate"].cpu())

    def fit(p, x, y, xs):
        s = mo.fit(p, x, y, xs)
        return [s.mean, s.variance]

    _, f64, wit = _three(torch, gt, fit, out["params"], out["x"], out["y"],
                         out["xs"])
    _hold_model("temperature_icm forecast at the optimum", ["mean", "variance"],
                [out["forecast_mean"], out["forecast_variance"]], f64, wit,
                [MEAN_LIMIT, VAR_LIMIT])


def _ex_dlm(torch, gt):
    """temperature_dlm (the Gibbs fit, the forecast and the held-out
    Student-t intervals at fixed variances held against float64) and
    dlm_gp."""
    from gpx_torch.examples import temperature_dlm as td

    out, _ = _example(torch, "temperature_dlm", [str(EX_DLM)])
    g = out["gibbs"]
    ok = bool((g.v > 0).all() and (g.w > 0).all())
    print(f"temperature_dlm: {EX_DLM} sweeps; V hat "
          f"{float(out['v_hat'].mean()):.4f} (truth 0.3), W hat "
          f"{float(out['w_hat'].mean()):.5f} (truth 0.005); "
          f"held-out coverage {out['heldout']['coverage']:.3f} (not held)",
          flush=True)
    check(ok, "temperature_dlm: a variance draw is not positive")
    _in_range("temperature_dlm residual GP (MH)",
              out["residual_accept_rate"].cpu())
    ys = out["ys"].double()
    m0, c0 = out["m0"].double(), out["c0"].double()
    model64 = td.build_model(device=DEV, dtype=torch.float64)
    _, means, covs = td.filter_and_forecast(
        model64, ys, out["v_hat"].double(), out["w_hat"].double(), m0, c0,
        out["forecast_means"].shape[0])
    held = td.heldout_intervals(ys, m0, c0)
    names = ["forecast means", "forecast covs", "held-out mean",
             "held-out scale", "held-out lo", "held-out hi"]
    got = [out["forecast_means"], out["forecast_covs"],
           *(out["heldout"][k] for k in ("mean", "scale", "lo", "hi"))]
    want = [means, covs, *(held[k] for k in ("mean", "scale", "lo", "hi"))]
    _hold_lazy("temperature_dlm at fixed variances", names, got, want,
               [DLM_REL] * len(names))

    out, launches = _example(torch, "dlm_gp", [str(EX_DLMGP)])
    r = out["result"]
    print(f"dlm_gp: {EX_DLMGP} sweeps, kernel medians "
          f"{[round(v, 3) for v in out['kernel_medians'].tolist()]} (truth 1.0, "
          f"2.0, 0.2), W median {float(out['w_median']):.4f} (truth 0.05; not "
          f"held)", flush=True)
    _in_range("dlm_gp kernel MH", r.accept_rate.cpu())
    check(launches["gram"] > 0, "dlm_gp: the Gram kernel was not launched")


def _ex_mnist(torch, gt):
    out, launches = _example(torch, "mnist_classify", [])
    p = out["probs"]
    sums = float((p.sum(-1) - 1.0).abs().max())
    print(f"mnist_classify: {int(out['fit'].n_iters)} Newton steps, held-out "
          f"accuracy {out['accuracy']:.3f} on the blob digits (not held); "
          f"probabilities sum to 1 within {sums:.2e}", flush=True)
    check(sums <= 1e-5, "mnist_classify: probabilities do not sum to 1")
    check(launches["gram"] > 0, "mnist_classify: the Gram kernel was not "
          "launched")


def _trace_kernels(path):
    """The CUDA kernel names of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def _profile_phase(torch, gt):
    """(d) profile_gp_stages at the bench case (its table; every stage > 0;
    the chol_inv stage's fused launches) and a device_trace of two
    logml_value_and_grad calls naming the port's kernels."""
    import re

    from gpx_torch.models import gp
    from gpx_torch.utils.profiling import device_trace, profile_gp_stages

    params, x_np, y_np = _bench_case(gt)
    reps = 3
    timer, _, launches = _counted(torch, lambda: profile_gp_stages(
        params, x_np, y_np, reps=reps, device=DEV))
    print(f"profile_gp_stages at the bench case (N = {N_BENCH}, float32):\n"
          + timer.report(), flush=True)
    names = list(timer.times)
    check(names == ["gram", "cholesky", "triangular_solve", "tri_inverse",
                    "chol_inv", "logml_value_and_grad"],
          f"profile_gp_stages: stages {names}")
    check(all(min(ts) > 0 for ts in timer.times.values()),
          "profile_gp_stages: a stage took no time")
    leaves = N_BENCH // 128
    calls = reps + 1                  # one warm-up call of each stage
    want = {"trmm": calls * 6 * (leaves - 1),
            "syrk_lower": calls * 2 * (leaves - 1),
            "chol_inv_tile_off": calls * 2 * leaves,
            "logml_kernel_grads": calls,
            "gram": 2 * calls}
    got = {k: launches[k] for k in want}
    print(f"profile_gp_stages launches {json.dumps(got)} (the chol_inv and "
          f"logML stages' fused kernels, {calls} calls each)", flush=True)
    check(got == want, "profile_gp_stages: the chol_inv stage is not the "
          "fused route")
    vg = [1e3 * t for t in timer.times["logml_value_and_grad"]]
    print(f"profile_gp_stages logml_value_and_grad {statistics.median(vg):.2f} "
          f"ms (median of {reps}, host clock synchronised) beside phase 3's "
          f"ms/eval (CUDA events; for the record)", flush=True)

    x = torch.as_tensor(x_np, device=DEV)
    y = torch.as_tensor(y_np, device=DEV)
    d = _phase9_dir("trace")
    with device_trace(d, device=DEV):
        # a warm-up call first: after phase 8's profiler run in the same
        # process, a trace of one call missed that call's first kernels on
        # the card (the Gram, the first fills)
        gp.logml_value_and_grad(params, x, y)
        gp.logml_value_and_grad(params, x, y)
    kernels = _trace_kernels(d / "trace.json")
    syrk = re.compile(r"product_kernel<.*, (\w+|\(bool\)\d), (\w+|\(bool\)\d), "
                      r"(\w+|\(bool\)\d), \d+>")
    flags = {m.group(2) for k in kernels for m in [syrk.search(k)] if m}
    found = {"gram": any("gram_kernel" in k for k in kernels),
             "trmm": bool(flags & {"false", "(bool)0"}),
             "syrk": bool(flags & {"true", "(bool)1"}),
             "leaf": any("chol_inv_tile_kernel" in k for k in kernels),
             "logml_grad": any("logml_grad_kernel" in k
                               and "probe" not in k for k in kernels)}
    print(f"device_trace of logml_value_and_grad (a warm-up call, then "
          f"one more): {len(kernels)} kernel "
          f"names, the port's {json.dumps(found)}; names: "
          f"{[k[:96] for k in kernels]}", flush=True)
    check(all(found.values()), "device_trace: a fused kernel is missing from "
          "the trace")
    return {"stages_ms": {k: statistics.median([1e3 * t for t in ts])
                          for k, ts in timer.times.items()},
            "trace_kernels": len(kernels)}


def phase_examples(torch, gt):
    """Phase 9: the user-facing layer and the eight examples on the card,
    (a)-(d), each part's seconds."""
    out, secs = {}, {}
    t_all = time.perf_counter()
    NOT_HELD.clear()
    SECOND_LIMIT.clear()
    for name, fn in (("csv", lambda: _csv_phase(torch)),
                     ("resume", lambda: _resume_phase(torch, gt)),
                     ("large_n", lambda: _ex_large_n(torch, gt)),
                     ("simulated_gp", lambda: _ex_simulated_gp(torch, gt)),
                     ("temperature", lambda: _ex_temperature(torch, gt)),
                     ("temperature_icm", lambda: _ex_icm(torch, gt)),
                     ("dlm", lambda: _ex_dlm(torch, gt)),
                     ("mnist_classify", lambda: _ex_mnist(torch, gt)),
                     ("profile", lambda: _profile_phase(torch, gt))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["example_ms"] = dict(EX_MS)
    out["not_held"] = list(NOT_HELD)
    out["second_limit"] = list(SECOND_LIMIT)
    out["seconds"] = secs
    print(f"phase 9 ms per example command: "
          f"{json.dumps({k: round(v, 1) for k, v in EX_MS.items()})}", flush=True)
    print(f"phase 9 not held: {NOT_HELD}; past the base limit on both "
          f"float32 routes, held by the second limit: {SECOND_LIMIT}",
          flush=True)
    print(f"phase 9 seconds: {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f", total {time.perf_counter() - t_all:.1f}", flush=True)
    return out


# -- phase 10: multi-device (gpx_torch.parallel) -----------------------------

PAR_RANKS = 4                     # (b): ranks sharing the one card over gloo
PAR_PANEL = 128
PAR_PREDICT_PANEL = 127           # N = 16,383 after the merge = 127 x 129
# sample_mh_2d at the bench width: N, draws, and the proposal scale (the
# default 0.15, which suits N = 4096, over sqrt(N / 4096): the posterior
# narrows as 1 / sqrt(N))
PAR_MH = (N_BENCH, 8, 0.075)
PAR_SVGP = dict(n=16384, m=256, batch=512, steps=5)
PAR_TIMEOUT_S = 400


def _bench_limits(want):
    return [1e-4 * abs(want[0]), 0.5, 1e-2 * abs(want[2]),
            1e-5 * abs(want[3])]


def _par_counters():
    from gpx_torch.ops import cuda_gram, cuda_matvec

    return {"gram": cuda_gram.gram_cuda,
            "cross_matvec": cuda_matvec.cross_matvec_cuda}


def _par_count(torch, fn):
    """``fn()`` with the Gram and cross_matvec counters set to 0 just
    before and read just after."""
    counters = _par_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def _host_ms(torch, fn, reps=1):
    """Mean host time of ``fn`` over ``reps`` calls after a warm-up,
    ending in a synchronize (the gloo ranks wait on the host at every
    collective, so device events would not see that time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _merged_bench(torch, gt):
    """The bench data with its coincident pair merged as phase 3b merges it
    (the second point dropped: N = 16,383), and phase 3b's test grid."""
    params, x_np, y_np = _bench_case(gt)
    first = np.sort(np.unique(x_np[:, 0], return_index=True)[1])
    x = torch.as_tensor(x_np[first], device="cuda")
    y = torch.as_tensor(y_np[first], device="cuda")
    xs = torch.linspace(-10.0, 10.0, N_BENCH, device="cuda")[:, None]
    return params, x, y, xs


def _phase10_mesh_of_one(torch, gt):
    """(a) a mesh of 1 over NCCL in this process: the distributed logML
    and gradient at the bench case against float64 (phase 3's limits, the
    float32 torch.linalg route as the second), its ms/eval in turns with
    phase 3's fused route, and distributed_predict on the merged data
    against float64 (phase 3b's limits)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from gpx_torch.models import gp
    from gpx_torch.parallel import (distributed_logml_value_and_grad,
                                    distributed_predict, make_mesh)
    from gpx_torch.parallel.mesh import init_process_group

    out = {}
    params, x, y = _bench_case_cuda(torch, gt)
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    init_process_group(0, 1, store, backend="nccl")
    try:
        mesh = make_mesh(data=1)

        def dist_eval():
            return distributed_logml_value_and_grad(params, x, y, mesh,
                                                    panel=PAR_PANEL)

        torch.cuda.reset_peak_memory_stats()
        (value, grads), launches = _par_count(torch, dist_eval)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"phase 10 (a) mesh of 1 (NCCL) launches: {json.dumps(launches)}"
              f"; peak memory {out['peak_gib']:.2f} GiB", flush=True)
        check(launches["gram"] > 0, "(a) the Gram kernel was not launched")
        got = _flat_result(gt, value, grads)
        want = _f64_result(torch, gt, gp, params, x, y)
        witness = _flat_result(gt, *gp.logml_value_and_grad(
            params, x, y, method="autodiff"))
        _hold_scalars("phase 10 (a) d=1", ["value", "h", "sigma", "white"],
                      got, want, _bench_limits(want), witness)
        out.update(result=got, f64=want, witness=witness, launches=launches)
        ms = {}
        for route, fn in (("distributed", dist_eval),
                          ("fused", lambda: gp.logml_value_and_grad(
                              params, x, y))):
            ms[route] = _median_ms(torch, fn, reps=3)
        out["ms"] = ms
        print(f"phase 10 (a) ms/eval at N = {N_BENCH} (median of 3, each "
              f"call's): distributed d=1 {ms['distributed']}, phase 3's "
              f"fused {ms['fused']}", flush=True)
        torch.cuda.empty_cache()

        params, xu, yu, xs = _merged_bench(torch, gt)
        post, launches = _par_count(torch, lambda: distributed_predict(
            params, xu, yu, xs, mesh, panel=PAR_PREDICT_PANEL))
        check(launches["gram"] == 2, "(a) distributed_predict: not 2 Gram "
              "launches (K's rows and the cross block)")
        want = _fit64(gt, gp, params, xu, yu, xs)
        keep = gp.FUSED_MIN_N
        gp.FUSED_MIN_N = xu.shape[0] + 1
        try:
            lin = gp.fit(params, xu, yu, xs)
        finally:
            gp.FUSED_MIN_N = keep
        for what, limit in (("mean", MEAN_LIMIT), ("variance", VAR_LIMIT)):
            err = _err_of_scale(getattr(post, what), getattr(want, what))
            _hold_predict(f"phase 10 (a) distributed_predict n={xu.shape[0]} "
                          f"m={N_BENCH}", what, err,
                          _err_of_scale(getattr(lin, what),
                                        getattr(want, what)), limit)
            out[f"predict_{what}_err"] = err
        out["predict_ms"] = _median_ms(torch, lambda: distributed_predict(
            params, xu, yu, xs, mesh, panel=PAR_PREDICT_PANEL), reps=1)[0]
        print(f"phase 10 (a) distributed_predict: {out['predict_ms']:.2f} ms "
              f"(panel {PAR_PREDICT_PANEL})", flush=True)
        del post, want, lin
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def _phase10_rank(rank):
    """(b), one rank of four sharing the card over gloo: the main path with
    the counters set to 0 just before and read just after (the
    distributed logML and gradient at the bench case on make_mesh(data=4),
    then the iterative logML with mesh= at examples/large_n.py's N =
    32,768 on phase 4's probes), its ms/eval and peak memory; then on a 2 x
    2 mesh sample_mh_2d and svgp.train(mesh=) beside the single-card
    trajectory on the same global minibatches. Returns plain numbers."""
    import torch

    import gpx_torch as gt
    from gpx_torch._device import full_fp32
    from gpx_torch.models import gp_iterative as gi
    from gpx_torch.models import svgp
    from gpx_torch.parallel import (distributed_logml_value_and_grad,
                                    make_mesh, sample_mh_2d)
    from gpx_torch.parallel import comm

    full_fp32()
    out = {}
    params, x, y = _bench_case_cuda(torch, gt)
    mesh = make_mesh(data=PAR_RANKS)
    # large_n's data with its coincident pairs merged, as phase 4 holds
    # fit_iterative: the mesh matvec splits White off to the diagonal
    # (gpx's split_noise) where the single-card matvec also meets it at
    # each pair's r2 = 0, so on the data as drawn the two are different
    # operators; trimmed to a multiple of the ranks, phase 4's probes on
    # the rows kept
    xi_np, yi_np = _iter_case(N_IT)
    keep = np.flatnonzero(np.r_[True, xi_np[1:, 0] != xi_np[:-1, 0]])
    keep = torch.as_tensor(keep[:keep.size - keep.size % PAR_RANKS],
                           device="cuda")
    xi = torch.as_tensor(xi_np, device="cuda")[keep]
    yi = torch.as_tensor(yi_np, device="cuda")[keep]
    p_it = gt.Parameters(mean=gt.zero(), kernel=_iter_kernel(gt))
    pn, sn = (t[keep] for t in _iter_noise(torch, gi, 0, N_IT,
                                            ITER["n_probes"]))
    out["n_iterative"] = int(keep.numel())
    it_kw = dict(probe_noise=pn, slq_noise=sn,
                 lanczos_iters=ITER["lanczos_iters"], cg_tol=ITER["cg_tol"],
                 precond_rank=ITER["precond_rank"])

    def main_path():
        v, g = distributed_logml_value_and_grad(params, x, y, mesh,
                                                panel=PAR_PANEL)
        it = gi._logml_value_and_grad_iterative(p_it, xi, yi, mesh=mesh,
                                                **it_kw)
        return v, g, it

    torch.cuda.reset_peak_memory_stats()
    (v, g, it), out["launches"] = _par_count(torch, main_path)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["logml"] = _flat_result(gt, v, g)
    out["iterative"] = _flat(gt, it)
    out["cg_iters"] = it.cg_iters
    out["ms"] = _host_ms(torch, lambda: distributed_logml_value_and_grad(
        params, x, y, mesh, panel=PAR_PANEL))
    out["iterative_ms"] = _host_ms(torch, lambda: gi._logml_value_and_grad_iterative(
        p_it, xi, yi, mesh=mesh, **it_kw))
    if rank == 0:
        one = gi._logml_value_and_grad_iterative(p_it, xi, yi, **it_kw)
        out["iterative_one"] = _flat(gt, one)
    del xi, yi, pn, sn
    torch.cuda.empty_cache()

    grid = make_mesh(chains=2, data=2)
    n, draws, scale = PAR_MH
    t0 = time.perf_counter()
    post = sample_mh_2d(1, x[:n], y[:n], _map_template(gt),
                        _log_prior(gt, torch), draws, grid, panel=PAR_PANEL,
                        proposal_scale=scale)
    torch.cuda.synchronize()
    out["mh_2d"] = {"shape": list(post.flat.shape),
                    "finite": bool(torch.isfinite(post.flat).all()),
                    "accept_rate": post.accept_rate.tolist(),
                    "s_per_draw": (time.perf_counter() - t0) / (draws + 1)}

    # svgp: one global minibatch a step, each data rank its rows of it
    sx, sy = _svgp_data(torch, PAR_SVGP["n"])
    z = sx[:: PAR_SVGP["n"] // PAR_SVGP["m"]][:PAR_SVGP["m"]]
    p = gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 2.0, device="cuda"))
    rng = np.random.default_rng(3)
    n_loc, b_loc = PAR_SVGP["n"] // 2, PAR_SVGP["batch"] // 2
    batches = [np.concatenate([r * n_loc + rng.choice(n_loc, b_loc, False)
                               for r in range(2)])
               for _ in range(PAR_SVGP["steps"])]
    my = comm.axis_index(grid, "data")
    mine = [b[my * b_loc:(my + 1) * b_loc] - my * n_loc for b in batches]
    keep = svgp._batch_indices
    runs = {}
    try:
        for tag, source, m in (("mesh", mine, grid), ("one", batches, None)):
            step = iter(source)
            svgp._batch_indices = lambda gen, n_, b, device, step=step: (
                torch.as_tensor(next(step), device=device))
            res = svgp.train(0, p, z, sx, sy, noise=0.25,
                             batch_size=PAR_SVGP["batch"],
                             steps=PAR_SVGP["steps"], learning_rate=1e-2,
                             train_noise=True, mesh=m)
            runs[tag] = [float(t) for t in gt.params.leaves(res[0])] + [
                float(res[3])] + res[4].tolist()
    finally:
        svgp._batch_indices = keep
    out["svgp"] = runs
    return out


def _phase10_four_ranks(torch, gt, ref):
    """(b): four ranks on the one card over gloo (phase 1 built the kernels;
    the ranks only load them), held against (a) and float64, then
    dryrun_multichip(4)."""
    from gpx_torch.parallel.dryrun import dryrun_multichip, run_ranks

    t0 = time.perf_counter()
    outs = run_ranks(_phase10_rank, PAR_RANKS, backend="gloo",
                     timeout_s=PAR_TIMEOUT_S, threads=2)
    wall = time.perf_counter() - t0
    r0 = outs[0]
    for r, o in enumerate(outs):
        print(f"phase 10 (b) rank {r}: launches {json.dumps(o['launches'])}, "
              f"peak memory {o['peak_gib']:.2f} GiB, ms/eval d=4 "
              f"{o['ms']:.1f}, iterative ms/eval {o['iterative_ms']:.1f}, "
              f"CG {o['cg_iters']}", flush=True)
        check(o["launches"]["gram"] > 0 and o["launches"]["cross_matvec"] > 0,
              f"(b) rank {r}: the Gram kernel or cross_matvec not launched")
        check(o["logml"] == r0["logml"] and o["iterative"] == r0["iterative"],
              f"(b) rank {r}: a replicated result differs from rank 0's")
    names = ["value", "h", "sigma", "white"]
    _hold_scalars("phase 10 (b) d=4", names, r0["logml"], ref["f64"],
                  _bench_limits(ref["f64"]), ref["witness"])
    # against (a): the same float32 program summed in another order: each
    # rank's trailing updates over its own rows and columns, the logdet's
    # partial sums and the gradients' partials added over the four ranks
    # (the Gram rows are (a)'s bitwise: centred on the whole set). Each
    # gradient is a cancellation of ~1e4-sized terms whose float32 rounding
    # moves with the order; how far is read from the run: the float32
    # torch.linalg route (a third order) against float64. Each output of
    # d = 4 is held to (a)'s within phase 3's limit or twice that route's
    # error, the limit each is held to against float64
    for nm, a, b, w, f, lim in zip(names, ref["result"], r0["logml"],
                                   ref["f64"], ref["witness"],
                                   _bench_limits(ref["f64"])):
        limit = max(lim, 2.0 * abs(f - w))
        print(f"phase 10 (b) d=4 against (a) d=1 {nm}: {b:.8e} {a:.8e} diff "
              f"{abs(a - b):.3e} (limit {limit:.3e}; base {lim:.3e}, "
              f"float32 witness {abs(f - w):.3e})", flush=True)
        check(abs(a - b) <= limit, f"(b) d=4 {nm} differs from (a)'s d=1")
    # the iterative logML against the single card on the same probes, at
    # phase 4's limits against the same estimator
    got, one = r0["iterative"], r0["iterative_one"]
    for nm, kind, a, b in zip(names, names, got, one):
        lim = {"value": 1e-4 * abs(b), "h": 0.5, "sigma": 1e-2 * abs(b),
               "white": 1e-3 * abs(b)}[kind]
        print(f"phase 10 (b) iterative n={r0['n_iterative']} (pairs merged) "
              f"d=4 {nm}: {a:.8e} single card "
              f"{b:.8e} diff {abs(a - b):.3e} (limit {lim:.3e})", flush=True)
        check(math.isfinite(a) and abs(a - b) <= lim,
              f"(b) iterative d=4 {nm} differs from the single card")
    mh = r0["mh_2d"]
    rates = mh["accept_rate"]
    print(f"phase 10 (b) sample_mh_2d n={PAR_MH[0]} (proposal scale "
          f"{PAR_MH[2]}): draws {mh['shape']}, finite {mh['finite']}, accept "
          f"rates {rates}, {mh['s_per_draw']:.2f} s a logML of every chain "
          f"(the init's and each draw's)", flush=True)
    check(mh["shape"][:2] == [2, PAR_MH[1]] and mh["finite"]
          and 0.0 < float(np.mean(rates)) < 1.0, "(b) sample_mh_2d")
    a, b = (np.array(r0["svgp"][k]) for k in ("mesh", "one"))
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
    print(f"phase 10 (b) svgp.train(mesh=) {PAR_SVGP['steps']} steps against "
          f"the single card on the same global minibatches: max rel "
          f"{rel:.3e} (limit 1e-4) over the trained leaves, noise and ELBO "
          f"trace", flush=True)
    check(rel <= 1e-4, "(b) svgp.train(mesh=) differs from the single card")
    t1 = time.perf_counter()
    dryrun_multichip(PAR_RANKS, device="cuda", timeout_s=PAR_TIMEOUT_S)
    print(f"phase 10 (b) dryrun_multichip({PAR_RANKS}, cuda): ok "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    return {"ranks": outs, "ranks_wall_s": wall}


def _cross_matvec_distributed_time(torch, gt):
    """cross_matvec at the mesh path's per-rank shape (8192 x 32,768, R =
    probes + 1 = 9): its device time by CUDA-graph replay beside its bound
    and torch.matmul on the prebuilt block."""
    from gpx_torch.ops.cuda_matvec import cross_matvec_cuda

    xi_np, _ = _iter_case(N_IT)
    x = torch.as_tensor(xi_np, device="cuda")
    x = x - x.mean(dim=0, keepdim=True)
    rows = N_IT // PAR_RANKS
    r = ITER["n_probes"] + 1
    v = torch.randn((N_IT, r), generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    kern = _iter_kernel(gt).kernels[0]        # the smooth part (split_noise)
    ms = graph_ms(torch, lambda: cross_matvec_cuda(kern, x[:rows], x, v))
    k = kern.gram(x[:rows], x)
    lib = graph_ms(torch, lambda: k @ v)
    bound, by = _matvec_bound(rows, N_IT, 1, r, "se+white")
    print(f"phase 10 cross_matvec {rows} x {N_IT}, R = {r}: {ms:.4f} ms "
          f"(CUDA-graph replay), bound {bound:.4f} ms ({by}), torch.matmul "
          f"on the prebuilt block {lib:.4f} ms", flush=True)
    del k
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_parallel(torch, gt):
    """Phase 10: gpx_torch.parallel on the card, (a) and (b), and
    cross_matvec's time at the mesh path's shape."""
    t_all = time.perf_counter()
    NOT_HELD.clear()
    SECOND_LIMIT.clear()
    out = {"mesh_of_one": _phase10_mesh_of_one(torch, gt)}
    out["cross_matvec_rank_shape"] = _cross_matvec_distributed_time(torch, gt)
    out["four_ranks"] = _phase10_four_ranks(torch, gt, out["mesh_of_one"])
    out["not_held"] = list(NOT_HELD)
    out["second_limit"] = list(SECOND_LIMIT)
    out["seconds"] = time.perf_counter() - t_all
    print(f"phase 10 not held: {NOT_HELD}; held by the second limit: "
          f"{SECOND_LIMIT}; {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    import gpx_torch as gt

    t0 = time.perf_counter()
    card = phase_setup()
    if "--sampler-only" in sys.argv[1:]:
        records = {name: {} for name in _counters()}
        summary, case = phase_sampler(torch, gt, records)
        summary["workflows"] = phase_workflows(torch, gt, case, summary)
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (sampler only)",
              flush=True)
        return 0
    if "--matvec-times" in sys.argv[1:]:
        phase_matvec_times(torch, gt)
        print(f"total {time.perf_counter() - t0:.1f} s (matvec times)", flush=True)
        return 0
    if "--kernel-times" in sys.argv[1:]:
        phase_kernel_times(torch, gt)
        print(f"total {time.perf_counter() - t0:.1f} s (kernel times)", flush=True)
        return 0
    if "--models-only" in sys.argv[1:]:
        summary = {"models": phase_models(torch, gt)}
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (models only)", flush=True)
        return 0
    if "--newton-lockstep" in sys.argv[1:]:
        phase_newton_lockstep(torch, gt)
        print(f"total {time.perf_counter() - t0:.1f} s (Newton lockstep)",
              flush=True)
        return 0
    if "--examples-only" in sys.argv[1:]:
        summary = {"examples": phase_examples(torch, gt)}
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (examples only)",
              flush=True)
        return 0
    if "--parallel-only" in sys.argv[1:]:
        summary = {"parallel": phase_parallel(torch, gt)}
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (parallel only)",
              flush=True)
        return 0
    if "--classify-dlm-only" in sys.argv[1:]:
        summary = {"statespace": phase_statespace(torch, gt)}
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (classify and DLMs "
              f"only)", flush=True)
        return 0
    if "--bench-only" in sys.argv[1:]:
        records = {name: {} for name in _counters()}
        summary = phase_bench(torch, gt, records)
        summary["hybrid"] = phase_hybrid(torch, gt, records)
        print(f"ms/eval at N = {N_BENCH}: exact {summary['ms_per_eval']:.2f}  "
              f"hybrid {summary['hybrid']['ms_per_eval']:.2f}", flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (bench only)", flush=True)
        return 0
    records, chol = phase_kernels(torch, gt)
    families = phase_families(torch, gt)
    summary = phase_bench(torch, gt, records)
    summary.update(chol)
    summary["families"] = families
    summary["hybrid"] = phase_hybrid(torch, gt, records)
    summary["families_e2e"] = phase_families_e2e(torch, gt)
    summary["predict"] = phase_predict(torch, gt)
    print(f"ms/eval at N = {N_BENCH}: exact {summary['ms_per_eval']:.2f}  "
          f"hybrid {summary['hybrid']['ms_per_eval']:.2f}", flush=True)
    if "--no-iterative" in sys.argv[1:]:
        print("summary: " + json.dumps(summary), flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s (phases 1-3)", flush=True)
        return 0
    summary["iterative"] = phase_iterative(torch, gt, records)
    summary["sampler"], case = phase_sampler(torch, gt, records)
    summary["workflows"] = phase_workflows(torch, gt, case,
                                           summary["sampler"])
    summary["models"] = phase_models(torch, gt)
    summary["statespace"] = phase_statespace(torch, gt)
    summary["examples"] = phase_examples(torch, gt)
    summary["parallel"] = phase_parallel(torch, gt)
    print("summary: " + json.dumps(summary), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    order = ("gram", "trmm", "syrk_lower", "chol_inv_tile", "chol_inv_tile_off",
             "logml_kernel_grads", "logml_probe_grads", "gram_matvec",
             "cross_matvec")
    print(json.dumps({"kernels": [records[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
