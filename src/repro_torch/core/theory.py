"""Theorem 1 convergence-bound calculator (paper Sec. IV / Appendix A;
``repro.core.theory``, copied: it is numpy).

Computes the right-hand side of Eq. (21) term by term so benchmarks can
report how each system knob (kappa0, kappa1, eta, weights) moves the bound,
and tests can check the claimed monotonicities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoundInputs:
    eta: float               # learning rate
    beta: float              # smoothness
    sigma2: float            # gradient-noise variance bound sigma^2
    eps0_2: float            # client<->ES divergence bound epsilon_0^2
    eps1_2: float            # ES<->CS divergence bound epsilon_1^2
    kappa0: int
    kappa1: int
    T: int                   # total SGD steps
    f0_minus_fT: float       # E[f(w^0)] - E[f(w^T)]
    alpha_u: np.ndarray      # (B, U_b) within-ES weights (rows sum to 1)
    alpha_b: np.ndarray      # (B,) CS weights (sum to 1)


def lr_limit(beta: float, kappa0: int, kappa1: int) -> float:
    """Theorem 1 requires eta < 1 / (2*sqrt(5)*beta*kappa1*kappa0)."""
    return 1.0 / (2.0 * math.sqrt(5.0) * beta * kappa1 * kappa0)


def _weight_sums(alpha_u: np.ndarray, alpha_b: np.ndarray):
    """sum_b a_b sum_u a_u^2  and  sum_b a_b^2 sum_u a_u^2."""
    au2 = (alpha_u ** 2).sum(axis=1)                      # (B,)
    s_ab_au2 = float((alpha_b * au2).sum())
    s_ab2_au2 = float(((alpha_b ** 2) * au2).sum())
    return s_ab_au2, s_ab2_au2


def bound_terms(bi: BoundInputs) -> dict:
    """Each additive term of Eq. (21); 'total' is the bound."""
    eta, beta, k0, k1 = bi.eta, bi.beta, bi.kappa0, bi.kappa1
    s_ab_au2, s_ab2_au2 = _weight_sums(bi.alpha_u, bi.alpha_b)
    b2e2 = beta ** 2 * eta ** 2

    gamma0 = 4 * b2e2 * k0 ** 2 * (1 - s_ab_au2) \
        + 80 * (k1 ** 2) * (beta ** 4) * (eta ** 4) * (k0 ** 4)
    gamma1 = 4 * k1 * k0 * b2e2 * (s_ab_au2 - s_ab2_au2) \
        - 80 * (k1 ** 2) * (beta ** 4) * (eta ** 4) * (k0 ** 4) * s_ab_au2

    terms = {
        "optimality": 2 * bi.f0_minus_fT / (eta * bi.T),
        "sgd_variance": beta * eta * bi.sigma2 * s_ab2_au2,
        "gamma0_variance": gamma0 * bi.sigma2,
        "gamma1_variance": gamma1 * bi.sigma2,
        "eps0_divergence": 12 * b2e2 * (k0 ** 2) * bi.eps0_2
        + 240 * bi.eps0_2 * (k1 ** 2) * (beta ** 4) * (eta ** 4) * (k0 ** 4),
        "eps1_divergence": 20 * b2e2 * (k1 ** 2) * (k0 ** 2) * bi.eps1_2,
    }
    terms["total"] = float(sum(terms.values()))
    terms["eta_ok"] = bi.eta < lr_limit(beta, k0, k1)
    return terms


def uniform_weights(B: int, Ub: int):
    return (np.full((B, Ub), 1.0 / Ub), np.full((B,), 1.0 / B))
