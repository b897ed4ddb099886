"""Smoothing kernels of the torch port against the JAX package."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from tpgsd.sph import kernels as ref
from tpgsd_torch.sph import kernels as port

H = 0.104


def _radii():
    # r = 0 and r = 2h exactly, a dense sweep between, and points past 2h
    r = numpy.linspace(0.0, 2.0 * H, 513).astype(numpy.float32)
    r[-1] = numpy.float32(2.0 * H)
    return numpy.concatenate(
        [r, numpy.float32(H) * numpy.array([2.001, 2.5, 3.0], numpy.float32)]
    )


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("fn", ["w", "dw_over_r"])
@pytest.mark.parametrize("name", ["WendlandC2", "CubicSpline"])
def test_kernel_matches_reference(name, fn, dim):
    r = _radii()
    got = getattr(getattr(port, name), fn)(torch.from_numpy(r), H, dim=dim)
    want = getattr(getattr(ref, name), fn)(jnp.asarray(r), H, dim=dim)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), rtol=1e-6)


def test_kernel_code_rejects_unknown_kernel():
    assert port.kernel_code(port.WendlandC2) == 0
    assert port.kernel_code(port.CubicSpline) == 1
    with pytest.raises(ValueError, match="WendlandC2 and CubicSpline"):
        port.kernel_code(object)
