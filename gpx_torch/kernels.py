"""Covariance kernels as ``nn.Module``s — the port of ``gpx/kernels.py``.

A kernel holds its hyperparameters as tensors (registered buffers, in the
field order of the JAX package's dataclasses) and maps a whole squared-
distance tensor at once through ``evaluate_r2``. ``_fields`` names the
leaves and sub-kernels in that order; :mod:`gpx_torch.params` flattens and
rebuilds kernels from it, in the order ``jax.tree_util.tree_flatten`` gives
for the JAX kernels.

``pallas_safe`` keeps the JAX package's meaning (the kernel may run inside
a tile kernel; every kernel but general-``nu`` Matérn) and gates
``method="hybrid"`` as it does there. ``cuda_supported`` says whether the
CUDA kernels' term table (:mod:`gpx_torch.ops.terms`) can evaluate the
kernel: a leaf (SE, White, Matérn with half-integer ``nu``, RQ, Periodic),
or any tree of ``Sum``s and ``Product``s over such leaves whose expansion
into a sum of products of leaves (every ``Product`` distributed over its
``Sum``s) has at most :data:`MAX_TERMS` factors in all. Every other kernel
(general-``nu`` Matérn, Linear, ``Ard`` below the top level, a tree that
expands past the table) runs the plain torch route.
"""

from __future__ import annotations

import math

import torch

from gpx_torch import bijectors as bij
from gpx_torch._device import as_tensor
from gpx_torch._module import FieldModule

MAX_TERMS = 8  # csrc/terms.cuh: GPX_MAX_TERMS


def _safe_dist(r2):
    """``sqrt(r2)`` with a finite gradient at ``r2 == 0``: the sqrt runs on a
    safe input and both value and gradient are pinned to 0 at coincident
    points."""
    zero = r2 <= 0.0
    r2_safe = torch.where(zero, torch.ones_like(r2), r2)
    return torch.where(zero, torch.zeros_like(r2), torch.sqrt(r2_safe))


class Kernel(FieldModule):
    """Base class. Subclasses set ``_fields`` and implement ``evaluate_r2``
    (the kernel as a function of squared Euclidean distance)."""

    def evaluate_r2(self, r2):
        raise NotImplementedError

    def evaluate_xx(self, x1, x2, r2):
        """Kernel value given the locations and their squared distances;
        stationary kernels ignore the locations."""
        return self.evaluate_r2(r2)

    @property
    def is_stationary(self) -> bool:
        return True

    @property
    def pallas_safe(self) -> bool:
        """True when the kernel may run inside a tile kernel (the JAX
        package's gate of its fused and hybrid paths)."""
        return True

    @property
    def cuda_supported(self) -> bool:
        """True when the CUDA kernels' term table evaluates this kernel."""
        return False

    def evaluate(self, d):
        """The kernel at (non-squared) distance ``d``: the reference's
        ``Double => Double`` covariance function
        (KernelFunction.scala:47-55)."""
        d = torch.as_tensor(d)
        return self.evaluate_r2(d * d)

    def variance(self, n: int, dtype=None):
        """The kernel at distance zero, broadcast to ``(n,)`` (the ``kyy``
        of Predict.scala:78), on the kernel's device, in ``dtype`` or its
        hyperparameters' type. Stationary kernels only; :meth:`diag` in
        general."""
        leaf = next(iter(self.buffers()))
        return self.evaluate_r2(torch.zeros(n, dtype=dtype or leaf.dtype,
                                            device=leaf.device))

    def bijectors(self):
        """The same kernel with a :class:`gpx_torch.bijectors.Bijector` in
        every leaf slot (walked by :func:`gpx_torch.params.leaves` in the
        order of its tensors)."""
        raise NotImplementedError

    def diag(self, x, dtype=None):
        """``k(x_i, x_i)`` per point."""
        from gpx_torch.ops.distance import as_locations

        x = as_locations(x)
        dtype = dtype or x.dtype
        if self.is_stationary:
            return self.evaluate_r2(torch.zeros(x.shape[0], dtype=dtype,
                                                device=x.device))
        r2 = torch.zeros((1, 1), dtype=dtype, device=x.device)
        return torch.func.vmap(
            lambda xi: self.evaluate_xx(xi[None], xi[None], r2)[0, 0])(x)

    def gram(self, x, x2=None, *, nugget: float = 0.0, method: str = "auto",
             center_of=None):
        from gpx_torch.ops.gram import gram

        return gram(self, x, x2, nugget=nugget, method=method,
                    center_of=center_of)

    def __add__(self, other):
        a = tuple(self.kernels) if isinstance(self, Sum) else (self,)
        b = tuple(other.kernels) if isinstance(other, Sum) else (other,)
        return Sum(a + b)

    def __mul__(self, other):
        a = tuple(self.kernels) if isinstance(self, Product) else (self,)
        b = tuple(other.kernels) if isinstance(other, Product) else (other,)
        return Product(a + b)


class SquaredExponential(Kernel):
    """``k(d) = h * exp(-d^2 / sigma^2)``."""

    _fields = ("h", "sigma")

    def __init__(self, h, sigma):
        super().__init__(h=h, sigma=sigma)

    def evaluate_r2(self, r2):
        return self.h * torch.exp(-r2 / (self.sigma * self.sigma))

    def bijectors(self):
        return SquaredExponential(h=bij.positive, sigma=bij.positive)

    @property
    def cuda_supported(self) -> bool:
        return True


class Matern(Kernel):
    """Matérn kernel: half-integer ``nu`` (1/2, 3/2, 5/2, ...) by its closed
    form, any other ``nu > 0`` through the Bessel ``K_nu``
    (:func:`gpx_torch.ops.besselk.kv`), which keeps that Matérn on the
    plain torch route (``pallas_safe`` and ``cuda_supported`` False)."""

    _fields = ("sigma", "l")

    def __init__(self, sigma, l, nu: float = 1.5):
        if nu <= 0:
            raise ValueError(f"Matern needs nu > 0; got nu={nu}")
        super().__init__(sigma=sigma, l=l)
        self.nu = float(nu)

    def _meta(self) -> dict:
        return {"nu": self.nu}

    @property
    def _half_integer_p(self):
        p = self.nu - 0.5
        return int(round(p)) if abs(p - round(p)) < 1e-12 else None

    def evaluate_r2(self, r2):
        d = _safe_dist(r2)
        s = (math.sqrt(2.0 * self.nu) / self.l) * d
        p = self._half_integer_p
        if p is None:
            from gpx_torch.ops.besselk import kv

            # k -> sigma at s = 0: pin that point with the double-where
            # trick so s^nu K_nu(s) puts a NaN in neither value nor gradient
            zero = r2 <= 0.0
            s_safe = torch.where(zero, torch.ones_like(s), s)
            const = 2.0 ** (1.0 - self.nu) / math.gamma(self.nu)
            val = const * s_safe ** self.nu * kv(self.nu, s_safe)
            return self.sigma * torch.where(zero, torch.ones_like(val), val)
        scale = math.factorial(p) / math.factorial(2 * p)
        poly = 0.0
        for i in range(p + 1):
            coeff = math.factorial(p + i) / (
                math.factorial(i) * math.factorial(p - i)
            )
            poly = poly + coeff * (2.0 * s) ** (p - i)
        return self.sigma * scale * poly * torch.exp(-s)

    @property
    def pallas_safe(self) -> bool:
        return self._half_integer_p is not None

    @property
    def cuda_supported(self) -> bool:
        return self._half_integer_p is not None

    def bijectors(self):
        return Matern(sigma=bij.positive, l=bij.positive, nu=self.nu)


class White(Kernel):
    """``sigma`` where the distance is exactly zero, else 0 — for any zero
    distance, duplicated locations included."""

    _fields = ("sigma",)

    def __init__(self, sigma):
        super().__init__(sigma=sigma)

    def evaluate_r2(self, r2):
        return torch.where(r2 == 0.0, self.sigma, torch.zeros_like(r2))

    def bijectors(self):
        return White(sigma=bij.positive)

    @property
    def cuda_supported(self) -> bool:
        return True


class RationalQuadratic(Kernel):
    """``k(d) = h * (1 + d^2 / (2 alpha l^2))^(-alpha)``."""

    _fields = ("h", "alpha", "l")

    def __init__(self, h, alpha, l):
        super().__init__(h=h, alpha=alpha, l=l)

    def evaluate_r2(self, r2):
        return self.h * (1.0 + r2 / (2.0 * self.alpha * self.l**2)) ** (
            -self.alpha
        )

    def bijectors(self):
        return RationalQuadratic(h=bij.positive, alpha=bij.positive,
                                 l=bij.positive)

    @property
    def cuda_supported(self) -> bool:
        return True


class Periodic(Kernel):
    """``k(d) = h * exp(-2 sin^2(pi d / period) / l^2)``."""

    _fields = ("h", "period", "l")

    def __init__(self, h, period, l):
        super().__init__(h=h, period=period, l=l)

    def evaluate_r2(self, r2):
        d = _safe_dist(r2)
        s = torch.sin(math.pi * d / self.period)
        return self.h * torch.exp(-2.0 * (s * s) / (self.l * self.l))

    def bijectors(self):
        return Periodic(h=bij.positive, period=bij.positive, l=bij.positive)

    @property
    def cuda_supported(self) -> bool:
        return True


class Linear(Kernel):
    """``k(x, x') = v * (x . x') + c`` — non-stationary."""

    _fields = ("v", "c")

    def __init__(self, v, c):
        super().__init__(v=v, c=c)

    @property
    def is_stationary(self) -> bool:
        return False

    def evaluate_r2(self, r2):
        raise TypeError("Linear is non-stationary: no distance-only form")

    def evaluate_xx(self, x1, x2, r2):
        return self.v * (x1 @ x2.T) + self.c

    def bijectors(self):
        return Linear(v=bij.positive, c=bij.positive)


class Ard(Kernel):
    """Per-dimension lengthscales: ``k(x, x') = base(||(x - x') / ell||)``."""

    _fields = ("base", "ell")

    def __init__(self, base, ell):
        super().__init__(base=base, ell=ell)

    @property
    def is_stationary(self) -> bool:
        return False

    def evaluate_r2(self, r2):
        raise TypeError("Ard re-weights coordinates: no isotropic-r2 form")

    def evaluate_xx(self, x1, x2, r2):
        from gpx_torch.ops.distance import sq_distances

        s = 1.0 / self.ell
        exact = x1.shape[-1] > 8 and has_white(self.base)
        r2w = (sq_distances(x1 * s, exact=exact) if x1 is x2
               else sq_distances(x1 * s, x2 * s, exact=exact))
        return self.base.evaluate_r2(torch.clamp_min(r2w, 0.0))

    def bijectors(self):
        return Ard(base=self.base.bijectors(), ell=bij.positive)


class Sum(Kernel):
    _fields = ("kernels",)

    def __init__(self, kernels):
        super().__init__(kernels=tuple(kernels))

    def evaluate_r2(self, r2):
        out = self.kernels[0].evaluate_r2(r2)
        for k in self.kernels[1:]:
            out = out + k.evaluate_r2(r2)
        return out

    def evaluate_xx(self, x1, x2, r2):
        out = self.kernels[0].evaluate_xx(x1, x2, r2)
        for k in self.kernels[1:]:
            out = out + k.evaluate_xx(x1, x2, r2)
        return out

    @property
    def is_stationary(self) -> bool:
        return all(k.is_stationary for k in self.kernels)

    @property
    def pallas_safe(self) -> bool:
        return all(k.pallas_safe for k in self.kernels)

    def bijectors(self):
        return Sum(tuple(k.bijectors() for k in self.kernels))

    @property
    def cuda_supported(self) -> bool:
        return _table_fits(self)


class Product(Kernel):
    _fields = ("kernels",)

    def __init__(self, kernels):
        super().__init__(kernels=tuple(kernels))

    def evaluate_r2(self, r2):
        out = self.kernels[0].evaluate_r2(r2)
        for k in self.kernels[1:]:
            out = out * k.evaluate_r2(r2)
        return out

    def evaluate_xx(self, x1, x2, r2):
        out = self.kernels[0].evaluate_xx(x1, x2, r2)
        for k in self.kernels[1:]:
            out = out * k.evaluate_xx(x1, x2, r2)
        return out

    @property
    def is_stationary(self) -> bool:
        return all(k.is_stationary for k in self.kernels)

    @property
    def pallas_safe(self) -> bool:
        return all(k.pallas_safe for k in self.kernels)

    def bijectors(self):
        return Product(tuple(k.bijectors() for k in self.kernels))

    @property
    def cuda_supported(self) -> bool:
        return _table_fits(self)


def expanded_size(kernel) -> tuple[int, int]:
    """``(products, factors)`` of ``kernel`` expanded into a sum of products
    of leaves, counted without expanding: a ``Product`` of parts with
    ``(m_i, f_i)`` has ``prod m_i`` products and ``sum_i f_i prod_{j != i}
    m_j`` factors."""
    if isinstance(kernel, Sum):
        sizes = [expanded_size(k) for k in kernel.kernels]
        return sum(m for m, _ in sizes), sum(f for _, f in sizes)
    if isinstance(kernel, Product):
        m, f = 1, 0
        for km, kf in (expanded_size(k) for k in kernel.kernels):
            m, f = m * km, f * km + kf * m
        return m, f
    return 1, 1


def _leaves_supported(kernel) -> bool:
    if isinstance(kernel, (Sum, Product)):
        return all(_leaves_supported(k) for k in kernel.kernels)
    return kernel.cuda_supported


def _table_fits(kernel) -> bool:
    """Every leaf has a device function and the expansion has at most
    :data:`MAX_TERMS` factors, the term table's rows."""
    return _leaves_supported(kernel) and expanded_size(kernel)[1] <= MAX_TERMS


def table_miss(kernel) -> str:
    """Why the CUDA term table does not hold ``kernel``, for error
    messages."""
    if not _leaves_supported(kernel):
        return "a part of it has no CUDA device function"
    return (f"its expansion into a sum of products has "
            f"{expanded_size(kernel)[1]} factors, more than the term table's "
            f"{MAX_TERMS}")


def has_white(kernel) -> bool:
    """Whether the kernel tree holds a :class:`White` term anywhere (the Gram
    builders then force exact broadcast-difference distances at D > 8)."""
    if isinstance(kernel, White):
        return True
    if isinstance(kernel, (Sum, Product)):
        return any(has_white(k) for k in kernel.kernels)
    if isinstance(kernel, Ard):
        return has_white(kernel.base)
    return False


def unwrap_ard(kernel, x, x2=None):
    """Peel top-level :class:`Ard` wrappers by scaling the coordinates:
    ``K_ard(x, x') = K_base(x/ell, x'/ell)``. Returns ``(kernel, x, x2)``."""
    while isinstance(kernel, Ard):
        s = 1.0 / kernel.ell
        x = x * s
        if x2 is not None:
            x2 = x2 * s
        kernel = kernel.base
    return kernel, x, x2


def split_noise(kernel):
    """``(smooth_part, noise_variance)``: the noise is the sum of the
    top-level White terms, the additive diagonal. ``(None, sigma)`` for a
    kernel that is only White noise; White inside a Product cannot be split
    and stays in the smooth part."""
    if isinstance(kernel, White):
        return None, kernel.sigma
    zero = next(iter(kernel.buffers())).new_zeros(())
    if isinstance(kernel, Sum):
        smooth, noise = [], zero
        for k in kernel.kernels:
            s, nz = split_noise(k)
            noise = noise + nz
            if s is not None:
                smooth.append(s)
        if not smooth:
            return None, noise
        return (smooth[0] if len(smooth) == 1 else Sum(smooth)), noise
    return kernel, zero


# -- constructors: ``device`` defaults to the CUDA card ------------------------

def se(h, sigma, *, device=None, dtype=None) -> SquaredExponential:
    kw = dict(device=device, dtype=dtype)
    return SquaredExponential(h=as_tensor(h, **kw), sigma=as_tensor(sigma, **kw))


def matern(sigma, nu, l, *, device=None, dtype=None) -> Matern:
    kw = dict(device=device, dtype=dtype)
    return Matern(sigma=as_tensor(sigma, **kw), l=as_tensor(l, **kw),
                  nu=float(nu))


def white(sigma, *, device=None, dtype=None) -> White:
    return White(sigma=as_tensor(sigma, device=device, dtype=dtype))


def linear(v, c=0.0, *, device=None, dtype=None) -> Linear:
    kw = dict(device=device, dtype=dtype)
    return Linear(v=as_tensor(v, **kw), c=as_tensor(c, **kw))


def ard(base: Kernel, ell, *, device=None, dtype=None) -> Ard:
    """Wrap ``base`` with per-dimension lengthscales ``ell`` (length D)."""
    return Ard(base=base, ell=as_tensor(ell, device=device, dtype=dtype))


def rational_quadratic(h, alpha, l, *, device=None, dtype=None):
    kw = dict(device=device, dtype=dtype)
    return RationalQuadratic(h=as_tensor(h, **kw), alpha=as_tensor(alpha, **kw),
                             l=as_tensor(l, **kw))


def periodic(h, period, l, *, device=None, dtype=None) -> Periodic:
    kw = dict(device=device, dtype=dtype)
    return Periodic(h=as_tensor(h, **kw), period=as_tensor(period, **kw),
                    l=as_tensor(l, **kw))
