#!/usr/bin/env python3
"""Drive the gpx_torch main path on one CUDA card and hold every kernel of
that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi); TF32 off; build the CUDA
   sources under gpx_torch/csrc (nvcc, sm_90a), printing the build time;
2. each kernel against its plain version at the shapes the main paths give
   it, with the tolerance and its reason; kernel, plain and library times;
   the spine factorization and its solves;
3. the end-to-end bench case (numpy seed 0, x ~ U(-10, 10) of shape
   (16384, 1), y ~ N(0, 1), SE(3.0, 5.5) + White(0.5), float32) through
   ``gp.logml_value_and_grad``, held against the non-fused route run in
   float64 on the card; every kernel's launch count in that call; ms/eval;
   fused against non-fused times at n = 1024 ... 16384; then the same case
   through ``method="hybrid"`` (three probe seeds, and n = 9000), its
   launch counts, ms/eval and the times of its stages;
4. a ``kernels`` JSON line, the card line, and the ``ok`` line last.

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
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_BENCH = 16384


def bound_ms(*, flops: float = 0.0, nbytes: float = 0.0):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


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
    return card


def phase_kernels(torch, gt):
    """Each kernel against its plain version; returns the kernels' records."""
    from gpx_torch.ops import cuda_chol, cuda_gram, cuda_logml_grad, cuda_trmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kern = gt.se(3.0, 5.5) + gt.white(0.5)
    records = {}

    def record(name, source, replaces, err, ms, plain_ms, bound, lib_ms):
        records[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms}
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
        if d == 1:
            ms = time_ms(torch, lambda: cuda_gram.gram_cuda(kern, x, nugget=1e-3))
            plain = time_ms(torch, lambda: cuda_gram.gram_reference(kern, x, None, 1e-3))
            record("gram", "gpx_torch/csrc/gram.cu",
                   "gpx/ops/pallas_gram.py:89", err, ms, plain,
                   bound_ms(nbytes=4.0 * n * n + 4.0 * n * d), None)
        del got, want
    # a cross-covariance block (x2 given: no nugget, no forced diagonal)
    got = cuda_gram.gram_cuda(kern, x[:1000], x[1000:3000])
    want = cuda_gram.gram_reference(kern, x[:1000], x[1000:3000])
    err = float((got - want).abs().max())
    print(f"gram cross (1000, 2000) d=2: max abs err {err:.3e}", flush=True)
    check(err <= 1e-5 * float(want.abs().max()), "cross gram disagrees")

    # -- 2./3. trmm (three modes) and syrk_lower at 8192^2, uneven panels ---
    # tolerance 1e-4 of max|C|: two f32 sums of up to 8192 products in
    # different orders (random-walk error ~sqrt(k) eps ~ 5e-6 of the scale,
    # worst case k eps ~ 5e-4)
    n = 8192
    l = torch.randn((n, n), generator=gen, device=dev).tril_() / math.sqrt(n)
    l.diagonal().add_(2.0)
    b = torch.randn((n, n), generator=gen, device=dev)
    trmm_err = 0.0
    for m_rows in (n, 5120):
        for mode, neg in (("right_lower", True), ("left_lower", False),
                          ("right_lower_t", False)):
            bb = b[:, :m_rows] if mode == "left_lower" else b[:m_rows]
            got = cuda_trmm.trmm(bb, l, mode=mode, neg=neg)
            want = cuda_trmm.trmm_reference(bb, l, mode=mode, neg=neg)
            err = float((got - want).abs().max())
            print(f"trmm {mode} b {tuple(bb.shape)} neg={neg}: max abs err "
                  f"{err:.3e}", flush=True)
            check(err <= 1e-4 * float(want.abs().max()), f"trmm {mode} disagrees")
            trmm_err = max(trmm_err, err)
    # a ragged shape (no dimension a multiple of the 64 tile) for the masks
    lr, br = l[:200, :200].contiguous(), b[:130, :200].contiguous()
    for mode in ("right_lower", "right_lower_t"):
        err = rel_max(cuda_trmm.trmm(br, lr, mode=mode),
                      cuda_trmm.trmm_reference(br, lr, mode=mode))
        check(err <= 1e-5, f"ragged trmm {mode} disagrees ({err:.2e})")
    ms = time_ms(torch, lambda: cuda_trmm.trmm(b, l, mode="right_lower"))
    plain = time_ms(torch, lambda: cuda_trmm.trmm_reference(b, l, mode="right_lower"))
    lib = time_ms(torch, lambda: torch.matmul(b, l))
    record("trmm", "gpx_torch/csrc/trmm.cu", "gpx/ops/pallas_trmm.py:127",
           trmm_err, ms, plain, bound_ms(flops=float(n) ** 3,
                                         nbytes=4.0 * (n * n * 2.5)), lib)

    a = b @ b.T / n
    a.diagonal().add_(1.0)
    syrk_err = 0.0
    for k in (n, 5120):
        got = cuda_trmm.syrk_lower(a, b[:, :k])
        want = cuda_trmm.syrk_lower_reference(a, b[:, :k])
        err = float((got.tril() - want).abs().max())
        print(f"syrk_lower b (8192, {k}): max abs err {err:.3e}", flush=True)
        check(err <= 1e-4 * float(want.abs().max()), "syrk_lower disagrees")
        syrk_err = max(syrk_err, err)
    ms = time_ms(torch, lambda: cuda_trmm.syrk_lower(a, b))
    plain = time_ms(torch, lambda: cuda_trmm.syrk_lower_reference(a, b))
    lib = time_ms(torch, lambda: torch.addmm(a, b, b.T, alpha=-1.0))
    record("syrk_lower", "gpx_torch/csrc/trmm.cu", "gpx/ops/pallas_trmm.py:239",
           syrk_err, ms, plain, bound_ms(flops=float(n) ** 3,
                                         nbytes=4.0 * (n * n + n * n)), lib)
    del l, b, a, got, want

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
    ms = time_ms(torch, lambda: cuda_chol.chol_inv_tile(leaf), reps=20)
    plain = time_ms(torch, lambda: cuda_chol.chol_inv_tile_reference(leaf), reps=20)
    lib = time_ms(torch, lambda: torch.linalg.cholesky(leaf), reps=20)
    record("chol_inv_tile", "gpx_torch/csrc/chol_inv_tile.cu",
           "gpx/ops/pallas_chol.py:160", err, ms, plain,
           bound_ms(flops=t ** 3 / 3.0, nbytes=4.0 * 2.5 * t * t), lib)

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
    ms = time_ms(torch, lambda: cuda_chol.chol_inv_tile_off(kmat, off, t), reps=20)
    plain = time_ms(torch, lambda: cuda_chol.chol_inv_tile_reference(blk), reps=20)
    lib = time_ms(torch, lambda: torch.linalg.cholesky(blk), reps=20)
    record("chol_inv_tile_off", "gpx_torch/csrc/chol_inv_tile.cu",
           "gpx/ops/pallas_chol.py:184", err, ms, plain,
           bound_ms(flops=t ** 3 / 3.0, nbytes=4.0 * 2.5 * t * t), lib)

    # chol_inv: ||L L^T - K|| / ||K|| and ||M L - I|| / ||I|| (Frobenius);
    # 1e-5 is a few f32 ulps for the backward error of the factor, 1e-3
    # allows eps * cond(L) (cond(K) ~ 5e4) for the inverse's residual
    factor_kernels = (cuda_chol.chol_inv_tile, cuda_chol.chol_inv_tile_off,
                      cuda_trmm.trmm, cuda_trmm.syrk_lower)
    for c in factor_kernels:
        c.launches = 0
    lf, mf = cuda_chol.chol_inv(kmat)
    launches = {c.__name__: c.launches for c in factor_kernels}
    # (the residuals are formed in float64: an f32 product would add its
    # own rounding of the same size)
    l64, k64m = lf.double(), kmat.double()
    fact = float(torch.linalg.matrix_norm(l64 @ l64.T - k64m)
                 / torch.linalg.matrix_norm(k64m))
    del k64m
    res = mf.double() @ l64
    res.diagonal().sub_(1.0)
    inv = float(torch.linalg.matrix_norm(res) / math.sqrt(N_BENCH))
    del l64, res
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
    del lf

    # -- 5. logml_kernel_grads at N = 4096 and at the main path's N = 16384,
    # each against the plain version in float64 on the same f32 inputs
    # (_hold); timed at N = 16384
    nchk = 4096
    xs = x[:nchk].contiguous()
    _, ms_inv = cuda_chol.chol_inv(cuda_gram.gram_cuda(kern, xs, nugget=1e-3))
    alpha = torch.randn(nchk, generator=gen, device=dev) * 0.1
    err = _hold_grads(torch, gt, kern, xs, alpha, ms_inv)
    alpha16 = torch.randn(N_BENCH, generator=gen, device=dev) * 0.1
    m16 = mf
    err = max(err, _hold_grads(torch, gt, kern, x, alpha16, m16))
    ms = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads(kern, x, alpha16, m16), reps=3)
    plain = time_ms(torch, lambda: cuda_logml_grad.logml_kernel_grads_reference(
        kern, x, alpha16, m16), reps=3)
    record("logml_kernel_grads", "gpx_torch/csrc/logml_grad.cu",
           "gpx/ops/pallas_logml_grad.py:136", err, ms, plain,
           bound_ms(flops=N_BENCH ** 3 / 3.0, nbytes=4.0 * N_BENCH * N_BENCH / 2),
           None)

    # -- 6. logml_probe_grads: against its plain version in float64 on the
    # same f32 inputs (_hold) at the main path's N = 16384 with s = 64 (the
    # plain estimate) and s = 128 (the augmented block), and at n = 4096
    # with ragged s = 96 and 41; with identity probes against
    # logml_kernel_grads at n = 2048; timed at N = 16384, s = 64 and 128
    probe_ms, err = {}, 0.0
    for xp, m_inv, al, s in ((x, m16, alpha16, 64), (x, m16, alpha16, 128),
                             (xs, ms_inv, alpha, 96), (xs, ms_inv, alpha, 41)):
        z = _rademacher(torch, (xp.shape[0], s), gen)
        u = m_inv.T @ (m_inv @ z)  # K^-1 z through the factor
        err = max(err, _hold_probe(torch, gt, kern, xp, al, u, z))
        if xp.shape[0] == N_BENCH:
            probe_ms[s] = (
                time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads(
                    kern, xp, al, u, z), reps=5),
                time_ms(torch, lambda: cuda_logml_grad.logml_probe_grads_reference(
                    kern, xp, al, u, z), reps=3),
                bound_ms(flops=2.0 * N_BENCH ** 2 * s,
                         nbytes=4.0 * (2 * N_BENCH * s + 2 * N_BENCH)))
            print(f"logml_probe_grads n={N_BENCH} s={s}: kernel "
                  f"{probe_ms[s][0]:.3f} ms  plain {probe_ms[s][1]:.3f} ms  "
                  f"bound {probe_ms[s][2][0]:.3f} ms ({probe_ms[s][2][1]})",
                  flush=True)
    del ms_inv, m16, mf
    _probe_identity(torch, gt, kern, x[:2048].contiguous(), gen)
    ms, plain, bound = probe_ms[64]
    record("logml_probe_grads", "gpx_torch/csrc/logml_probe_grad.cu",
           "gpx/ops/pallas_logml_grad.py:334", err, ms, plain, bound, None)
    del kmat
    torch.cuda.empty_cache()
    return records, {"chol_inv_ms": chol_ms, "cholesky_lib_ms": lib_chol,
                     "chol_inv_launches": launches, "leaf_share": leaf_share,
                     "spine": spine,
                     "probe_ms": {s: v[0] for s, v in probe_ms.items()}}


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


def _hold(label, got, want, scales, names) -> float:
    """Each output p of a gradient kernel against its plain version in
    float64 on the same f32 inputs; returns the largest absolute error.

    Each output is a sum of terms whose magnitudes add up to scale_p
    (_term_scales), and must meet two limits:
    - 4 f32 ulps of scale_p: the kernel's rounding (f32 K^-1 tile dots,
      then the tile sums) adds with random signs over the n^2 entries;
    - 1e-2 of the output's own value, so that a dropped, mis-signed or
      mis-scaled derivative term fails even where a cancellation makes
      scale_p large (h at n = 4096: value 1.7, scale 2.7e4).
    """
    eps = 1.1920928955078125e-07  # float32
    err = 0.0
    for g, w, s, nm in zip(got, want, scales, names):
        e, limit = abs(g - w), min(4.0 * eps * s, 1e-2 * abs(w))
        print(f"{label} {nm}: kernel {g:.6e} reference {w:.6e} err {e:.3e} "
              f"limit {limit:.3e} scale {s:.3e}", flush=True)
        check(e <= limit, f"{label} {nm} disagrees")
        err = max(err, e)
    return err


_NAMES = ("h", "sigma", "white", "tkw", "trw")


def _outputs(gt, out):
    d_kernel, traces = out
    return [float(t) for t in (*gt.params.leaves(d_kernel), *traces)]


def _k64(torch, gt, device):
    f64 = {"dtype": torch.float64, "device": device}
    return gt.se(3.0, 5.5, **f64) + gt.white(0.5, **f64)


def _hold_grads(torch, gt, kern, x, alpha, l_inv) -> float:
    """logml_kernel_grads against its plain version (_hold)."""
    from gpx_torch.ops import cuda_logml_grad

    got = _outputs(gt, cuda_logml_grad.logml_kernel_grads(kern, x, alpha, l_inv))
    args = (_k64(torch, gt, x.device), x.double(), alpha.double())
    l64 = l_inv.double()
    want = _outputs(gt, cuda_logml_grad.logml_kernel_grads_reference(*args, l64))
    scales = _term_scales(torch, *args, l64.T @ l64)
    return _hold(f"logml_kernel_grads n={x.shape[0]}", got, want, scales, _NAMES)


def _hold_probe(torch, gt, kern, x, alpha, u, z) -> float:
    """logml_probe_grads against its plain version (_hold)."""
    from gpx_torch.ops import cuda_logml_grad

    got = _outputs(gt, cuda_logml_grad.logml_probe_grads(kern, x, alpha, u, z))
    args = (_k64(torch, gt, x.device), x.double(), alpha.double())
    u64, z64 = u.double(), z.double()
    want = _outputs(gt, cuda_logml_grad.logml_probe_grads_reference(*args, u64, z64))
    what = (u64 @ z64.T + z64 @ u64.T) * (0.5 / z.shape[1])
    scales = _term_scales(torch, *args, what)
    return _hold(f"logml_probe_grads n={x.shape[0]} s={z.shape[1]}", got, want,
                 scales, _NAMES)


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
    scales = _term_scales(torch, _k64(torch, gt, x.device), x.double(),
                          alpha.double(), kinv)
    _hold(f"logml_probe_grads n={n} s={n} identity probes vs logml_kernel_grads",
          got, want, scales, _NAMES)


def _term_scales(torch, kernel, x, alpha, kinv):
    """sum |W_ij dk_ij/dtheta_p| per hyperparameter, with W = 0.5 (alpha
    alpha^T - kinv), and the sums of |terms| of the two traces, in
    float64."""
    from gpx_torch.ops.distance import sq_distances
    from gpx_torch.ops.terms import term_derivatives

    w = 0.5 * (torch.outer(alpha, alpha) - kinv)
    r2 = sq_distances(x)
    out = [float(torch.sum((w * dk).abs())) for dk in term_derivatives(kernel, r2)]
    out.append(float(torch.sum((kinv * kernel.evaluate_r2(r2)).abs())))
    out.append(float(torch.sum(torch.diagonal(kinv).abs())))
    return out


def phase_bench(torch, gt, records):
    """The bench case end to end, against float64; returns the summary."""
    from gpx_torch.models import gp

    rng = np.random.default_rng(0)
    x_np = rng.uniform(-10.0, 10.0, size=(N_BENCH, 1)).astype(np.float32)
    y_np = rng.normal(size=N_BENCH).astype(np.float32)
    params = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5) + gt.white(0.5))
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    check(gp._fused_gate(params.kernel, x), "bench case is not on the fused route")

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
    # off the tile grid: n = 9000 pads to 9088 (uneven Schur splits)
    n_off = 9000
    check(gp._fused_gate(params.kernel, x[:n_off]), "n=9000 is not fused")
    value, grads = gp.logml_value_and_grad(params, x[:n_off], y[:n_off])
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

    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gp.logml_value_and_grad(params, x, y)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    eval_ms = statistics.median(ms)
    print(f"bench ms/eval (median of 5, CUDA events): {eval_ms:.2f} "
          f"{[round(t, 2) for t in ms]}", flush=True)

    # fused against non-fused route by n: these set gp.FUSED_MIN_N
    crossover = {}
    keep = gp.FUSED_MIN_N
    for n in (1024, 2048, 4096, 8192, N_BENCH):
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

    rng = np.random.default_rng(0)
    x_np = rng.uniform(-10.0, 10.0, size=(N_BENCH, 1)).astype(np.float32)
    y_np = rng.normal(size=N_BENCH).astype(np.float32)
    params = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5) + gt.white(0.5))
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

    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gp.logml_value_and_grad(params, x, y, method="hybrid", probes=64)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    eval_ms = statistics.median(ms)
    print(f"hybrid ms/eval (median of 5, CUDA events): {eval_ms:.2f} "
          f"{[round(t, 2) for t in ms]}", flush=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    import gpx_torch as gt

    t0 = time.perf_counter()
    card = phase_setup()
    records, chol = phase_kernels(torch, gt)
    summary = phase_bench(torch, gt, records)
    summary.update(chol)
    summary["hybrid"] = phase_hybrid(torch, gt, records)
    print(f"ms/eval at N = {N_BENCH}: exact {summary['ms_per_eval']:.2f}  "
          f"hybrid {summary['hybrid']['ms_per_eval']:.2f}", flush=True)
    print("summary: " + json.dumps(summary), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    order = ("gram", "trmm", "syrk_lower", "chol_inv_tile", "chol_inv_tile_off",
             "logml_kernel_grads", "logml_probe_grads")
    print(json.dumps({"kernels": [records[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
