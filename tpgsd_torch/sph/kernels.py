"""Smoothing kernels for SPH (torch counterpart of ``tpgsd.sph.kernels``).

Each kernel provides ``w(r, h)`` and ``dw_over_r(r, h)`` (the radial
derivative divided by r, so the gradient is ``(x_i - x_j) * dw_over_r``
with no division by a possibly-zero r).  Support radius is ``2h`` for
both kernels.  ``r`` is a float32 tensor; ``h`` a Python float.  The
CUDA pair kernels evaluate the same formulas in-kernel, selected by
:func:`kernel_code`.
"""

import math

import torch


class CubicSpline:
    """Monaghan cubic spline kernel, support radius 2h."""

    support_scale = 2.0

    @staticmethod
    def _sigma(h, dim=3):
        if dim == 3:
            return 1.0 / (math.pi * h**3)
        if dim == 2:
            return 10.0 / (7.0 * math.pi * h**2)
        return 2.0 / (3.0 * h)

    @classmethod
    def w(cls, r, h, dim=3):
        q = r / h
        sigma = cls._sigma(h, dim)
        w1 = 1.0 - 1.5 * q**2 + 0.75 * q**3
        w2 = 0.25 * (2.0 - q) ** 3
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        return sigma * torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, zero))

    @classmethod
    def dw_over_r(cls, r, h, dim=3):
        """(1/r) dW/dr, finite at r=0."""
        q = r / h
        sigma = cls._sigma(h, dim)
        g1 = -3.0 + 2.25 * q
        safe_q = torch.clamp(q, min=1e-12)
        g2 = -0.75 * (2.0 - q) ** 2 / safe_q
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        g = torch.where(q < 1.0, g1, torch.where(q < 2.0, g2, zero))
        return sigma * g / (h * h)


class WendlandC2:
    """Wendland C2 kernel (2-D / 3-D), support radius 2h."""

    support_scale = 2.0

    @staticmethod
    def _sigma(h, dim):
        if dim == 3:
            return 21.0 / (16.0 * math.pi * h**3)
        if dim == 2:
            return 7.0 / (4.0 * math.pi * h**2)
        raise ValueError("WendlandC2 supports dim 2 or 3, got %r" % (dim,))

    @classmethod
    def w(cls, r, h, dim=3):
        q = r / h
        sigma = cls._sigma(h, dim)
        t = torch.clamp(1.0 - 0.5 * q, min=0.0)
        return sigma * t**4 * (2.0 * q + 1.0)

    @classmethod
    def dw_over_r(cls, r, h, dim=3):
        q = r / h
        sigma = cls._sigma(h, dim)
        t = torch.clamp(1.0 - 0.5 * q, min=0.0)
        # dW/dq = sigma * (-5 q) * t^3 ; divide by q*h^2 -> no singularity
        return sigma * (-5.0) * t**3 / (h * h)


#: kernel class -> the selector the CUDA pair kernels switch on
_KERNEL_CODES = {WendlandC2: 0, CubicSpline: 1}


def kernel_code(kernel):
    """The CUDA kernels' selector for ``kernel``; raises for a kernel
    class they do not implement."""
    try:
        return _KERNEL_CODES[kernel]
    except KeyError:
        raise ValueError(
            "the CUDA pair kernels implement WendlandC2 and CubicSpline; "
            "got %r" % (kernel,)
        ) from None
