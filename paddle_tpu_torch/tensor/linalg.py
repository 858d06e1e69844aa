"""Linear algebra (``paddle_tpu/tensor/linalg.py`` counterpart).

The decompositions and solvers are ``torch.linalg``'s library calls, as the
JAX package's are ``jnp.linalg``'s: neither is a hand-written kernel.
"""

from __future__ import annotations

import builtins

import torch

from ..core.random import next_key, torch_generator

__all__ = [
    "cond", "pca_lowrank", "cov", "corrcoef", "matrix_exp", "pdist",
    "householder_product",
    "cholesky_solve", "eigvals", "eigvalsh", "lu", "lu_unpack",
    "matmul", "mm", "bmm", "dot", "t", "norm", "dist", "cross", "cholesky",
    "qr", "svd", "eig", "eigh", "inv", "pinv", "det", "slogdet", "solve",
    "triangular_solve", "lstsq", "matrix_power", "matrix_rank", "mv",
    "histogram", "bincount", "multi_dot", "einsum",
]


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    if transpose_x:
        x = torch.swapaxes(x, -1, -2)
    if transpose_y:
        y = torch.swapaxes(y, -1, -2)
    return torch.matmul(x, y)


mm = matmul


def bmm(x, y):
    return torch.matmul(x, y)


def dot(x, y):
    return torch.sum(x * y, dim=-1)


def t(x):
    if x.dim() < 2:
        return x
    return torch.swapaxes(x, -1, -2)


def norm(x, p="fro", axis=None, keepdim: bool = False):
    if isinstance(axis, list):
        axis = tuple(axis)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.linalg.norm(x, ord=None, dim=axis, keepdim=keepdim)
    return torch.linalg.norm(x, ord=p, dim=axis, keepdim=keepdim)


def dist(x, y, p: float = 2):
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def cross(x, y, axis: int = 9):
    return torch.linalg.cross(x, y, dim=-1 if axis == 9 else axis)


cholesky = torch.linalg.cholesky


def qr(x, mode: str = "reduced"):
    return tuple(torch.linalg.qr(x, mode=mode))


def svd(x, full_matrices: bool = False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def eig(x):
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO: str = "L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


inv = torch.linalg.inv
pinv = torch.linalg.pinv
det = torch.linalg.det
matrix_power = torch.linalg.matrix_power
einsum = torch.einsum


def slogdet(x):
    return tuple(torch.linalg.slogdet(x))


def solve(x, y):
    return torch.linalg.solve(x, y)


def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


def triangular_solve(x, y, upper: bool = True, transpose: bool = False,
                     unitriangular: bool = False):
    """Solve ``x @ out = y`` (``x.T`` with ``transpose``), x triangular."""
    if transpose:
        x, upper = torch.swapaxes(x, -1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None):
    """``(solution, residuals, rank, singular_values)``, LAPACK's gelsd
    (the driver that gives all four on the CPU; the card has one driver,
    which gives the solution)."""
    driver = "gelsd" if x.device.type == "cpu" else None
    return tuple(torch.linalg.lstsq(x, y, rcond=rcond, driver=driver))


def matrix_rank(x, tol=None, hermitian: bool = False):
    return torch.linalg.matrix_rank(x, atol=tol, hermitian=hermitian)


def mv(x, vec):
    return torch.matmul(x, vec)


def histogram(x, bins: int = 100, min: float = 0.0, max: float = 0.0):
    """Counts of ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0, as in Paddle), as float32, as JAX's."""
    return torch.histc(x.float(), bins=bins, min=min, max=max)


def bincount(x, weights=None, minlength: int = 0):
    return torch.bincount(x, weights=weights, minlength=minlength)


def cholesky_solve(x, y, upper: bool = False):
    """Solve ``A X = x`` given the Cholesky factor ``y`` of A."""
    return torch.cholesky_solve(x, y, upper=upper)


def eigvals(x):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO: str = "L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def lu(x, pivot: bool = True):
    """``(LU, pivots)``: L (unit lower) and U packed, pivots 1-based."""
    if not pivot:
        raise NotImplementedError(
            "lu(pivot=False) is not supported: LAPACK getrf always "
            "partial-pivots; reconstruct with lu_unpack's P instead")
    return tuple(torch.linalg.lu_factor(x))


def lu_unpack(lu_data, pivots, unpack_ludata: bool = True,
              unpack_pivots: bool = True):
    """``(P, L, U)`` from :func:`lu`'s output, batched: ``A = P L U``."""
    return tuple(torch.lu_unpack(lu_data, pivots.to(torch.int32)))


def cov(x, rowvar: bool = True, ddof: bool = True, fweights=None,
        aweights=None, name=None):
    """Covariance of rows (``rowvar``) or columns, with optional frequency
    and importance weights."""
    if x.dim() == 1:
        x = x[None, :]
    if not rowvar:
        x = x.T
    n = x.shape[1]
    w = None
    if fweights is not None:
        w = fweights.to(torch.float32)
    if aweights is not None:
        aw = aweights.to(torch.float32)
        w = aw if w is None else w * aw
    if w is None:
        w = torch.ones((n,), dtype=x.dtype, device=x.device)
    w_sum = torch.sum(w)
    avg = (x * w).sum(dim=1) / w_sum
    xc = x - avg[:, None]
    if not ddof:
        norm_ = w_sum
    elif aweights is None:
        norm_ = w_sum - 1
    else:
        norm_ = w_sum - torch.sum(w * aweights.to(torch.float32)) / w_sum
    c = (xc * w) @ torch.conj(xc.T) / norm_
    return c.squeeze() if c.shape == (1, 1) else c


def corrcoef(x, rowvar: bool = True, name=None):
    """Normalized covariance, clipped to [-1, 1]."""
    c = cov(x, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    c = c / d[:, None] / d[None, :]
    return torch.clamp(c.real if c.is_complex() else c, -1, 1)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


def pdist(x, p: float = 2.0, name=None):
    """Condensed pairwise distances of ``[N, D]``: ``[N (N - 1) / 2]`` in
    the row-major upper triangle's order."""
    return torch.pdist(x, p=p)


def householder_product(x, tau, name=None):
    """The first n columns of ``H_1 ... H_k`` from geqrf's reflectors."""
    return torch.linalg.householder_product(x, tau)


def cond(x, p=None, name=None):
    """The condition number in the norm ``p`` (None: 2)."""
    return torch.linalg.cond(x, p)


def pca_lowrank(x, q=None, center: bool = True, niter: int = 2, name=None):
    """Randomized low-rank PCA (Halko et al.): ``(U, S, V)`` with ``x ~ U
    diag(S) Vᵀ``, V's columns the principal directions. The test matrix is
    drawn from the port's key stream (not threefry's bits)."""
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = builtins.min(6, m, n)
    if center:
        x = x - torch.mean(x, dim=-2, keepdim=True)
    omega = torch.randn(x.shape[:-2] + (n, q), dtype=x.dtype,
                        device=x.device,
                        generator=torch_generator(next_key(), x.device))
    y = x @ omega
    qmat, _ = torch.linalg.qr(y)
    for _ in range(niter):
        z = torch.swapaxes(x, -1, -2) @ qmat
        w, _ = torch.linalg.qr(z)
        y = x @ w
        qmat, _ = torch.linalg.qr(y)
    b = torch.swapaxes(qmat, -1, -2) @ x
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    return qmat @ u_b, s, torch.swapaxes(vt, -1, -2)
