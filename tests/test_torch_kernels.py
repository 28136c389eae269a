"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode), on the CPU at small sizes.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against these same plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.ops.pallas_chol import chol_inv as jax_chol_inv
from gpx.ops.pallas_chol import chol_inv_tile as jax_chol_inv_tile
from gpx.ops.pallas_chol import chol_inv_tile_off as jax_chol_inv_tile_off
from gpx.ops.pallas_gram import pallas_gram
from gpx.ops.pallas_trmm import syrk_lower as jax_syrk_lower
from gpx.ops.pallas_trmm import trmm as jax_trmm
from gpx_torch.models.gp import _pad_spd
from gpx_torch.ops import cuda_chol, cuda_gram, cuda_trmm, terms
from gpx_torch.params import leaves, unflatten

torch.set_num_threads(1)


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("d", [1, 2])
def test_gram_reference_matches_pallas_gram(rng, d):
    # both f32 with no split product: agreement to f32 round-off
    x = rng.uniform(-10, 10, size=(256, d)).astype(np.float32)
    want = pallas_gram(gpx.se(3.0, 5.5) + gpx.white(0.5), jnp.asarray(x),
                       nugget=1e-3, interpret=True)
    kern = (gt.se(3.0, 5.5, device="cpu", dtype=torch.float32)
            + gt.white(0.5, device="cpu", dtype=torch.float32))
    got = cuda_gram.gram_cuda(kern, torch.as_tensor(x), nugget=1e-3)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("mode,m,neg", [
    ("right_lower", 128, True),
    ("left_lower", 128, True),
    ("right_lower_t", 128, True),
    ("right_lower_t", 192, False),   # an uneven Schur panel
])
def test_trmm_reference_matches_pallas(rng, mode, m, neg):
    # gpx's bf16x3 split carries ~1.5e-5 per dot
    n = 128
    l = np.tril(rng.normal(size=(n, n))).astype(np.float32)
    shape = (n, m) if mode == "left_lower" else (m, n)
    b = rng.normal(size=shape).astype(np.float32)
    want = jax_trmm(jnp.asarray(b), jnp.asarray(l), mode=mode, bt=64,
                    interpret=True, neg=neg, m=m)
    got = cuda_trmm.trmm(torch.as_tensor(b), torch.as_tensor(l), mode=mode,
                         neg=neg)
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) < 1e-4


def test_syrk_lower_reference_matches_pallas(rng):
    n, k = 128, 192
    a = _spd(rng, n)
    b = rng.normal(size=(n, k)).astype(np.float32)
    want = np.tril(np.asarray(jax_syrk_lower(jnp.asarray(a), jnp.asarray(b),
                                             bt=64, interpret=True)))
    out = torch.full((n, n), 7.0)
    got = cuda_trmm.syrk_lower(torch.as_tensor(a), torch.as_tensor(b), out=out)
    assert _rel(torch.tril(got), want) < 1e-4
    # the strict upper triangle of ``out`` is left as it was
    assert bool(torch.all(torch.triu(got, 1) == torch.triu(torch.full((n, n), 7.0), 1)))


def test_syrk_lower_out_may_alias_a(rng):
    # ``out=a`` (aliased, as chol_inv's Schur step calls it) gives the
    # unaliased result on i >= j and leaves a's strict upper triangle
    n, k = 96, 40
    a = torch.as_tensor(_spd(rng, n))
    b = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32))
    want = cuda_trmm.syrk_lower(a, b)
    upper = torch.ones(n, n, dtype=torch.bool).triu(1)
    aliased = a.clone()
    cuda_trmm.syrk_lower(aliased, b, out=aliased)
    assert torch.equal(aliased[~upper], want[~upper])
    assert torch.equal(aliased[upper], a[upper])


@pytest.mark.parametrize("base", [64, 128])
def test_chol_inv_padded_bases(rng, base):
    # n = 200 padded to 256 as the fused route pads it: either base gives
    # exact zeros above both diagonals and the float64 factor
    k = _pad_spd(torch.as_tensor(_spd(rng, 200), dtype=torch.float64), 56)
    l, m = cuda_chol.chol_inv(k, base=base)
    assert not torch.triu(l, 1).any() and not torch.triu(m, 1).any()
    assert _rel(l, torch.linalg.cholesky(k)) < 1e-12
    assert _rel(m @ l, torch.eye(256, dtype=torch.float64)) < 1e-12


def test_chol_inv_tile_reference_matches_pallas(rng):
    a = _spd(rng, 128)
    wl, wm = jax_chol_inv_tile(jnp.asarray(a), interpret=True)
    gl, gm = cuda_chol.chol_inv_tile(torch.as_tensor(a))
    assert _rel(gl, wl) < 1e-4
    assert _rel(gm, wm) < 1e-4


def test_chol_inv_tile_off_reference_matches_pallas(rng):
    """The leaf read in place at (128, 128) of a 256^2 buffer: it writes
    into the given outputs and agrees with gpx's offset leaf."""
    a = _spd(rng, 256)
    wl, wm = jax_chol_inv_tile_off(jnp.asarray(a), 128, 128, interpret=True)
    src = torch.as_tensor(a)
    l_out, m_out = torch.zeros(128, 128), torch.zeros(128, 128)
    gl, gm = cuda_chol.chol_inv_tile_off(src, 128, 128, l_out=l_out, m_out=m_out)
    assert gl is l_out and gm is m_out
    assert _rel(gl, wl) < 1e-4
    assert _rel(gm, wm) < 1e-4
    with pytest.raises(ValueError):
        cuda_chol.chol_inv_tile_off(src, 192, 128)


def test_chol_inv_recursion_matches_pallas(rng):
    a = _spd(rng, 256)
    wl, wm = jax_chol_inv(jnp.asarray(a), base=128, bt=64, interpret=True)
    gl, gm = cuda_chol.chol_inv(torch.as_tensor(a), base=128)
    assert _rel(gl, wl) < 1e-4
    assert _rel(gm, wm) < 1e-4
    # exact zeros above the diagonal, as the kernels require of L and M
    assert not torch.triu(gl, 1).any() and not torch.triu(gm, 1).any()


def test_term_device_functions_match_autograd(rng):
    """The explicit dk/dtheta formulas of csrc/terms.cuh (in their plain
    form) against torch autograd of evaluate_r2, with r2 == 0 entries."""
    kern = (gt.se(2.5, 1.7, device="cpu", dtype=torch.float64)
            + gt.white(0.3, device="cpu", dtype=torch.float64)
            + gt.se(0.7, 4.0, device="cpu", dtype=torch.float64))
    r2 = torch.as_tensor(np.concatenate([[0.0, 0.0], rng.uniform(0, 30, 40)]))
    jac = torch.autograd.functional.jacobian(
        lambda *ls: unflatten(kern, ls).evaluate_r2(r2), tuple(leaves(kern)))
    got = terms.term_derivatives(kern, r2)
    assert len(got) == len(jac) == 5
    for g, w in zip(got, jac):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
    table = [(typ, off) for typ, off, _ in terms.terms(kern)]
    assert table == [(terms.SE, 0), (terms.WHITE, 2), (terms.SE, 3)]


def test_table_tensors_cache_structure_not_values():
    """The term table is built once per kernel structure; the
    hyperparameters are read anew at each call."""
    cpu = {"device": "cpu", "dtype": torch.float32}
    k1 = gt.se(3.0, 5.5, **cpu) + gt.white(0.5, **cpu)
    k2 = gt.se(1.0, 2.0, **cpu) + gt.white(0.25, **cpu)
    t1, p1 = terms.table_tensors(k1, "cpu")
    t2, p2 = terms.table_tensors(k2, torch.device("cpu"))
    assert t1 is t2
    # rows of (type, offset, aux, group)
    assert t1.dtype == torch.int32 and t1.tolist() == [terms.SE, 0, 0, 0,
                                                       terms.WHITE, 2, 0, 1]
    assert p1.tolist() == [3.0, 5.5, 0.5] and p2.tolist() == [1.0, 2.0, 0.25]
    t3, _ = terms.table_tensors(gt.white(0.5, **cpu) + gt.se(3.0, 5.5, **cpu), "cpu")
    assert t3.tolist() == [terms.WHITE, 0, 0, 0, terms.SE, 1, 0, 1]
