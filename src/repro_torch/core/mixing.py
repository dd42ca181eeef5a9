"""Mixing-matrix theory utilities (paper §2 matrix form + Appendix A), a
numpy copy of ``repro.core.mixing``.

The Overlap-Local-SGD boundary is X_{k+1} = [X_k − γ G_k] W_k with the
column-stochastic matrix

    P = [ (1−α)I          (1−α)1/m ]
        [ α·1ᵀ             α       ]      ∈ R^{(m+1)×(m+1)}

These helpers build P, its fixed vector v = [(1−α)1/m, α], the contraction
factor ζ = ‖P − v·1ᵀ‖₂ (Appendix A proves ζ ≤ 1−α), and a dense matrix-form
simulator that the tests hold the per-leaf Overlap-Local-SGD path against
(eq. 8, the virtual sequence of eq. 19).
"""
from __future__ import annotations

import numpy as np


def mixing_matrix(m: int, alpha: float) -> np.ndarray:
    P = np.zeros((m + 1, m + 1))
    P[:m, :m] = (1 - alpha) * np.eye(m)
    P[:m, m] = (1 - alpha) / m
    P[m, :m] = alpha
    P[m, m] = alpha
    return P


def fixed_vector(m: int, alpha: float) -> np.ndarray:
    v = np.full(m + 1, (1 - alpha) / m)
    v[m] = alpha
    return v


def zeta(P: np.ndarray, v: np.ndarray) -> float:
    one = np.ones(P.shape[0])
    return float(np.linalg.norm(P - np.outer(v, one), 2))


def easgd_mixing_matrix(m: int, alpha: float) -> np.ndarray:
    """EASGD's symmetric doubly-stochastic counterpart: x_i ← x_i − ρ(x_i − z),
    z ← z + ρ Σ_i (x_i − z), ρ = α/m."""
    rho = alpha / m
    P = np.zeros((m + 1, m + 1))
    P[:m, :m] = (1 - rho) * np.eye(m)
    P[:m, m] = rho
    P[m, :m] = rho
    P[m, m] = 1 - m * rho
    return P


class MatrixFormSim:
    """Dense simulator of eq. (8): X_{k+1} = (X_k − γ G_k) W_k, with
    X ∈ R^{d×(m+1)} the m local models and the anchor (last column)."""

    def __init__(self, x0: np.ndarray, m: int, alpha: float, tau: int, gamma: float):
        self.X = np.tile(x0[:, None], (1, m + 1))
        self.m, self.alpha, self.tau, self.gamma = m, alpha, tau, gamma
        self.P = mixing_matrix(m, alpha)
        self.k = 0

    def step(self, grads: np.ndarray) -> None:
        """grads: (d, m) per-worker stochastic gradients at the current X."""
        G = np.concatenate([grads, np.zeros((grads.shape[0], 1))], axis=1)
        Xh = self.X - self.gamma * G
        if (self.k + 1) % self.tau == 0:
            self.X = Xh @ self.P
        else:
            self.X = Xh
        self.k += 1

    @property
    def locals(self) -> np.ndarray:
        return self.X[:, : self.m]

    @property
    def anchor(self) -> np.ndarray:
        return self.X[:, self.m]

    def virtual_sequence(self) -> np.ndarray:
        """y_k = (1−α)/m Σ x_i + α z (paper, below eq. (12))."""
        return self.X @ fixed_vector(self.m, self.alpha)
