"""Exponential-integrator functions for UniPC (Hochbruck & Ostermann, 2005).

Noise-prediction side uses

    varphi_0(h) = e^h,   varphi_{k+1}(h) = (varphi_k(h) - 1/k!) / h
    phi_n(h)    = h^n * n! * varphi_{n+1}(h)                      (Thm 3.1)

Data-prediction side uses

    psi_0(h) = e^{-h},   psi_{k+1}(h) = (1/k! - psi_k(h)) / h
    g_n(h)   = h^n * n! * psi_{n+1}(h)                            (Eq. 10)

The recursions suffer catastrophic cancellation for small |h| (each step divides
an O(h) difference by h), so below a threshold we switch to the absolutely
convergent series

    varphi_k(h) = sum_{j>=0} h^j / (j + k)!
    psi_k(h)    = sum_{j>=0} (-h)^j / (j + k)!        [psi_k(h) = varphi_k(-h)]

All coefficient computation happens host-side in float64 (the quantities depend
only on the timestep grid, never on data). A copy of `repro.core.phi`.
"""

from __future__ import annotations

import math

import numpy as np

_SERIES_THRESHOLD = 0.5
_SERIES_TERMS = 24  # |h| <= 0.5 -> term j ~ 0.5^j / (j+k)! ; 24 terms is far below eps


def varphi(k: int, h) -> np.ndarray:
    """varphi_k(h), elementwise over h (float64)."""
    h = np.asarray(h, dtype=np.float64)
    small = np.abs(h) < _SERIES_THRESHOLD
    return np.where(small, _varphi_series(k, h), _varphi_recursive(k, h))


def psi(k: int, h) -> np.ndarray:
    """psi_k(h) = varphi_k(-h)."""
    return varphi(k, -np.asarray(h, dtype=np.float64))


def _varphi_series(k: int, h: np.ndarray) -> np.ndarray:
    acc = np.zeros_like(h)
    # Horner-style from the tail: sum_j h^j / (j+k)!
    for j in reversed(range(_SERIES_TERMS)):
        acc = acc * h + 1.0 / math.factorial(j + k)
    return acc


def _varphi_recursive(k: int, h: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.exp(h)
        for j in range(k):
            v = (v - 1.0 / math.factorial(j)) / h
    return v


def phi_vec(p: int, h) -> np.ndarray:
    """phi_p(h) = (phi_1..phi_p), phi_n = h^n n! varphi_{n+1}(h). Shape (p,) + h.shape."""
    h = np.asarray(h, dtype=np.float64)
    return np.stack([h**n * math.factorial(n) * varphi(n + 1, h) for n in range(1, p + 1)])


def g_vec(p: int, h) -> np.ndarray:
    """g_p(h) = (g_1..g_p), g_n = h^n n! psi_{n+1}(h). Shape (p,) + h.shape."""
    h = np.asarray(h, dtype=np.float64)
    return np.stack([h**n * math.factorial(n) * psi(n + 1, h) for n in range(1, p + 1)])


# Closed forms used only by tests (App. E.1 / E.4):
def varphi1_closed(h):
    return np.expm1(h) / h


def varphi2_closed(h):
    return (np.exp(h) - h - 1.0) / h**2


def varphi3_closed(h):
    return (np.exp(h) - h**2 / 2 - h - 1.0) / h**3


def psi1_closed(h):
    return -np.expm1(-h) / h


def psi2_closed(h):
    return (h - 1.0 + np.exp(-h)) / h**2


def psi3_closed(h):
    return (h**2 / 2 - h + 1.0 - np.exp(-h)) / h**3
