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
7. a ``kernels`` JSON line, the card line, and the ``ok`` line last.

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


def _hold_gram(torch, gt, label, kern, x, nugget=1e-3) -> float:
    """The Gram kernel against its plain version in float64 on the same f32
    x, within FAMILY_ULPS of each entry's scale; returns the largest
    absolute error."""
    from gpx_torch.ops import cuda_gram
    from gpx_torch.ops.distance import sq_distances
    from gpx_torch.ops.terms import term_dr2

    got = cuda_gram.gram_cuda(kern, x, nugget=nugget)
    k64, x64 = _f64_kernel(gt, kern), x.double()
    want = cuda_gram.gram_reference(k64, x64, None, nugget)
    r2 = sq_distances(x64)
    # the smallest normal f32 as a floor: f32 entries below it underflow
    scale = (want.abs() + 2.0 * r2 * term_dr2(k64, r2, absolute=True)
             + 2.0 ** -126)
    return _hold_ulps(torch, f"gram {label} n={x.shape[0]} d={x.shape[1]}", got,
                      want, scale, FAMILY_ULPS)


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
        errs["gram_matvec"] = max(errs["gram_matvec"],
                                  _hold_ulps(torch, label, got, want, scale, 4.0))
        del want
        wit = cm._gram_matvec_tf32x3_torch(kern, xc, v, nug, rows=rows)
        _hold_ulps(torch, f"{label} against the plain TF32 version", got,
                   wit.double(), scale, 4.0)

    def cross_case(label, x1, x2, v, kern=kern, k64=k64):
        c = x2.mean(dim=0, keepdim=True)
        x1c, x2c = x1 - c, x2 - c
        got = cm.cross_matvec_cuda(kern, x1c, x2c, v)
        check(torch.equal(got, cm.cross_matvec_cuda(kern, x1c, x2c, v)),
              f"{label}: a repeated call differs")
        want = cm._cross_matvec_torch(k64, x1c.double(), x2c.double(), v.double())
        scale = cm._cross_matvec_torch(k64, x1c.double(), x2c.double(),
                                       v.double().abs())
        errs["cross_matvec"] = max(errs["cross_matvec"],
                                   _hold_ulps(torch, label, got, want, scale, 4.0))
        wit = cm._cross_matvec_tf32x3_torch(kern, x1c, x2c, v)
        _hold_ulps(torch, f"{label} against the plain TF32 version", got,
                   wit.double(), scale, 4.0)

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
