"""Spectral transforms: FFT-based filters and elliptic solves.

Counterpart of ``gt4py_tpu.models.spectral``: per-level 2D real FFTs over
the horizontal plane of physical (K, I, J) arrays, batched over K.  The JAX
package computes them with XLA's FFT, outside any Pallas kernel; here they
are ``torch.fft`` (cuFFT on the card).  The numpy versions are the port's
own copies of the reference's, for the tests.
"""

import numpy as np
import torch


def _wavenumbers(ni, nj, dx, dy, xp, **kw):
    kx = xp.fft.fftfreq(ni, d=dx, **kw) * 2.0 * np.pi
    ky = xp.fft.rfftfreq(nj, d=dy, **kw) * 2.0 * np.pi
    return kx.reshape(1, ni, 1), ky.reshape(1, 1, -1)


def _torch_wavenumbers(q, dx, dy):
    real = torch.float64 if q.dtype == torch.float64 else torch.float32
    _, ni, nj = q.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, torch, dtype=real, device=q.device)
    return kx ** 2 + ky ** 2


def spectral_filter(q: torch.Tensor, cutoff: float, dx: float = 1.0,
                    dy: float = 1.0) -> torch.Tensor:
    """Low-pass filter: zero every mode with |k| above ``cutoff`` (physical
    (K, NI, NJ) tensors, periodic)."""
    _, ni, nj = q.shape
    k2 = _torch_wavenumbers(q, dx, dy)
    spec = torch.fft.rfft2(q, dim=(1, 2))
    mask = (k2 <= cutoff ** 2).to(spec.dtype)
    return torch.fft.irfft2(spec * mask, s=(ni, nj), dim=(1, 2)).to(q.dtype)


def poisson_solve(rhs: torch.Tensor, dx: float = 1.0, dy: float = 1.0) -> torch.Tensor:
    """Solve lap(p) = rhs on a doubly periodic domain (zero-mean gauge)."""
    _, ni, nj = rhs.shape
    k2 = _torch_wavenumbers(rhs, dx, dy)
    spec = torch.fft.rfft2(rhs, dim=(1, 2))
    inv = torch.where(k2 > 0, -1.0 / torch.where(k2 > 0, k2, torch.ones_like(k2)),
                      torch.zeros_like(k2))
    return torch.fft.irfft2(spec * inv, s=(ni, nj), dim=(1, 2)).to(rhs.dtype)


def spectral_filter_numpy(q, cutoff: float, dx: float = 1.0, dy: float = 1.0):
    nk, ni, nj = q.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, np)
    spec = np.fft.rfft2(q, axes=(1, 2))
    mask = ((kx**2 + ky**2) <= cutoff**2).astype(spec.dtype)
    return np.fft.irfft2(spec * mask, s=(ni, nj), axes=(1, 2)).astype(q.dtype)


def poisson_solve_numpy(rhs, dx: float = 1.0, dy: float = 1.0):
    nk, ni, nj = rhs.shape
    kx, ky = _wavenumbers(ni, nj, dx, dy, np)
    k2 = kx**2 + ky**2
    spec = np.fft.rfft2(rhs, axes=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    return np.fft.irfft2(spec * inv, s=(ni, nj), axes=(1, 2)).astype(rhs.dtype)
