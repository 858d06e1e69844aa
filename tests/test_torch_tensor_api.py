"""Port parity: the tensor op surface (``paddle_tpu/tensor/*``).

Each of the 302 names in the ``__all__`` lists of JAX's nine tensor modules
is one case of ``test_tensor_op``: the same numpy inputs, made from one
seed, go through JAX's function and the port's function of the same module
and name, and the outputs are compared (float32 within the case's rtol and
atol, 1e-5 and 1e-6 unless stated; integers, booleans and shapes exactly).

Stated differences the comparison allows:
- **64-bit dtypes.** The JAX package runs with 64-bit types off, so an
  int64 or float64 it is asked for comes back as 32 bits; the port keeps
  Paddle's int64 (indices, integer sums, ``arange``). The values are
  compared at JAX's dtype, and the port's own dtype is checked apart: an
  output may be int64 where JAX's is int32 (float64/float32,
  complex128/complex64), no other difference.
- **Library calls.** The decompositions and solvers are ``torch.linalg``
  against ``jnp.linalg``, both LAPACK on the CPU: eigen- and singular
  vectors, and Q of QR, are compared up to each column's sign, ``eig``'s
  eigenvalues as sorted sets, ``lstsq`` by its solution.
- **Random draws** (``tensor/random.py``, ``extras.randint_like``,
  ``linalg.pca_lowrank``'s test matrix) cannot reproduce threefry's bits.
  They are held to JAX's shape and dtype, to their range, to determinism
  under ``seed``, and to the first two moments of their law (within five
  standard errors over 20,000 draws); ``pca_lowrank`` on a rank-2 matrix to
  JAX's two singular values.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import device as tdev
from paddle_tpu_torch.core import random as trng
from _torch_threads import one_torch_thread  # noqa: F401

MODULES = ("creation", "math", "manipulation", "linalg", "logic", "random",
           "stat", "search", "extras")
JM = {m: importlib.import_module(f"paddle_tpu.tensor.{m}") for m in MODULES}
TM = {m: importlib.import_module(f"paddle_tpu_torch.tensor.{m}")
      for m in MODULES}
PAIRS = [(m, n) for m in MODULES for n in JM[m].__all__]


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port's creation ops make tensors on this thread's device."""
    tdev.set_device("cpu")
    yield
    tdev._state.__dict__.pop("device", None)


# -- inputs -------------------------------------------------------------------

_r = np.random.default_rng(0)
X = _r.standard_normal((3, 4)).astype(np.float32)
Y = _r.standard_normal((3, 4)).astype(np.float32)
XR = np.round(X * 2).astype(np.float32)
YR = np.round(Y * 2).astype(np.float32)
POS = _r.uniform(0.5, 2.5, (3, 4)).astype(np.float32)
POS2 = _r.uniform(0.5, 2.5, (3, 4)).astype(np.float32)
U = _r.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
U01 = _r.uniform(0.05, 0.95, (3, 4)).astype(np.float32)
BIG = _r.uniform(1.2, 3.0, (3, 4)).astype(np.float32)
I1 = _r.integers(1, 20, (3, 4)).astype(np.int32)
I2 = _r.integers(1, 20, (3, 4)).astype(np.int32)
ISMALL = _r.integers(-3, 4, (3, 4)).astype(np.int32)
V3 = _r.standard_normal(3).astype(np.float32)
V4 = _r.standard_normal(4).astype(np.float32)
V12 = _r.standard_normal(12).astype(np.float32)
X3 = _r.standard_normal((2, 3, 4)).astype(np.float32)
Y3 = _r.standard_normal((2, 4, 3)).astype(np.float32)
X43 = _r.standard_normal((4, 3)).astype(np.float32)
Y43 = _r.standard_normal((4, 3)).astype(np.float32)
_m = _r.standard_normal((4, 4)).astype(np.float32)
A = (_m @ _m.T / 4 + np.eye(4, dtype=np.float32)).astype(np.float32)
A33 = _r.standard_normal((3, 3)).astype(np.float32)
B42 = _r.standard_normal((4, 2)).astype(np.float32)
L = np.linalg.cholesky(A).astype(np.float32)
B1 = X > 0
B2 = Y > 0
C = (X + 1j * Y).astype(np.complex64)
XN = X.copy()
XN[0, 1] = np.nan
XN[2, 3] = np.nan
XNI = XN.copy()
XNI[1, 0] = np.inf
XNI[1, 2] = -np.inf
SORTED = np.sort(_r.standard_normal(6)).astype(np.float32)
MODE = _r.integers(0, 3, (3, 6)).astype(np.float32)
UNQ = _r.integers(0, 5, (10,)).astype(np.int32)
UC = np.array([1, 1, 2, 2, 2, 3, 1, 1, 4], np.int32)
TALL = _r.standard_normal((5, 3)).astype(np.float32)
X6 = _r.standard_normal((6, 2)).astype(np.float32)
HX = _r.standard_normal((4, 3)).astype(np.float32)
TAU = _r.uniform(0.5, 1.5, 3).astype(np.float32)
HIST = _r.standard_normal(50).astype(np.float32)
NONNEG = _r.integers(0, 6, (20,)).astype(np.int32)
LOWRANK = (_r.standard_normal((6, 2)) @ _r.standard_normal((2, 5))).astype(
    np.float32)
IDX2 = np.array([[0, 2], [1, 1], [3, 0]], np.int64)


def _i(*v):
    return np.array(v, np.int64)


# -- the cases ------------------------------------------------------------------

def S(fn, rtol=1e-5, atol=1e-6, post=None):
    """A case: ``fn(f, T, mod)`` calls the package's function ``f`` on
    inputs converted by ``T`` (``jnp.asarray`` or ``torch.from_numpy``);
    ``mod`` is the package's module, ``post`` maps both results before they
    are compared."""
    return {"fn": fn, "rtol": rtol, "atol": atol, "post": post}


def _abs(r):
    return [np.abs(a) for a in r]


def _eig_values(r):
    return np.sort_complex(np.asarray(r[0]).astype(np.complex128))


SPEC = {
    # creation
    "to_tensor": S(lambda f, T, m: f([[1.5, 2.0], [3.0, 4.0]])),
    "zeros": S(lambda f, T, m: f([2, 3])),
    "ones": S(lambda f, T, m: f([2, 3], "int32")),
    "full": S(lambda f, T, m: f([2, 3], 1.5)),
    "zeros_like": S(lambda f, T, m: f(T(X))),
    "ones_like": S(lambda f, T, m: f(T(X), "float16")),
    "full_like": S(lambda f, T, m: f(T(X), 2.0)),
    "arange": S(lambda f, T, m: f(0, 10, 2)),
    "linspace": S(lambda f, T, m: f(0, 1, 5)),
    "eye": S(lambda f, T, m: f(3, 4)),
    "empty": S(lambda f, T, m: f([2, 3])),
    "empty_like": S(lambda f, T, m: f(T(X))),
    "diag": S(lambda f, T, m: f(T(V3), 1, 2.0)),
    "diagflat": S(lambda f, T, m: f(T(V3), -1)),
    "tril": S(lambda f, T, m: f(T(X), -1)),
    "triu": S(lambda f, T, m: f(T(X), 1)),
    "meshgrid": S(lambda f, T, m: f(T(V3), T(V4))),
    "assign": S(lambda f, T, m: f(T(X))),
    "clone": S(lambda f, T, m: f(T(X))),
    "numel": S(lambda f, T, m: f(T(X3))),
    "tolist": S(lambda f, T, m: f(T(X))),
    "logspace": S(lambda f, T, m: f(0, 2, 5), rtol=1e-5),
    "vander": S(lambda f, T, m: f(T(V3), 4)),
    "tril_indices": S(lambda f, T, m: f(4, 5, 1)),
    "triu_indices": S(lambda f, T, m: f(4, 5, -1)),
    # math
    "gammainc": S(lambda f, T, m: f(T(POS), T(POS2)), 1e-4, 1e-6),
    "gammaincc": S(lambda f, T, m: f(T(POS), T(POS2)), 1e-4, 1e-6),
    "igamma": S(lambda f, T, m: f(T(POS), T(POS2)), 1e-4, 1e-6),
    "igammac": S(lambda f, T, m: f(T(POS), T(POS2)), 1e-4, 1e-6),
    "multigammaln": S(lambda f, T, m: f(T(BIG), 3), 1e-5, 1e-5),
    "add": S(lambda f, T, m: f(T(X), T(Y))),
    "subtract": S(lambda f, T, m: f(T(X), T(Y))),
    "multiply": S(lambda f, T, m: f(T(X), T(Y))),
    "divide": S(lambda f, T, m: f(T(X), T(POS))),
    "floor_divide": S(lambda f, T, m: f(T(X), T(POS))),
    "mod": S(lambda f, T, m: f(T(X), T(POS))),
    "pow": S(lambda f, T, m: f(T(POS), T(Y))),
    "sqrt": S(lambda f, T, m: f(T(POS))),
    "rsqrt": S(lambda f, T, m: f(T(POS))),
    "square": S(lambda f, T, m: f(T(X))),
    "abs": S(lambda f, T, m: f(T(X))),
    "exp": S(lambda f, T, m: f(T(X))),
    "expm1": S(lambda f, T, m: f(T(X))),
    "log": S(lambda f, T, m: f(T(POS))),
    "log2": S(lambda f, T, m: f(T(POS))),
    "log10": S(lambda f, T, m: f(T(POS))),
    "log1p": S(lambda f, T, m: f(T(POS))),
    "sin": S(lambda f, T, m: f(T(X))),
    "cos": S(lambda f, T, m: f(T(X))),
    "tan": S(lambda f, T, m: f(T(U))),
    "asin": S(lambda f, T, m: f(T(U))),
    "acos": S(lambda f, T, m: f(T(U))),
    "atan": S(lambda f, T, m: f(T(X))),
    "sinh": S(lambda f, T, m: f(T(X))),
    "cosh": S(lambda f, T, m: f(T(X))),
    "tanh": S(lambda f, T, m: f(T(X))),
    "floor": S(lambda f, T, m: f(T(X * 3))),
    "ceil": S(lambda f, T, m: f(T(X * 3))),
    "round": S(lambda f, T, m: f(T(X * 3))),
    "trunc": S(lambda f, T, m: f(T(X * 3))),
    "sign": S(lambda f, T, m: f(T(XR))),
    "neg": S(lambda f, T, m: f(T(X))),
    "reciprocal": S(lambda f, T, m: f(T(POS))),
    "maximum": S(lambda f, T, m: f(T(X), T(Y))),
    "minimum": S(lambda f, T, m: f(T(X), T(Y))),
    "fmax": S(lambda f, T, m: f(T(XN), T(Y))),
    "fmin": S(lambda f, T, m: f(T(XN), T(Y))),
    "clip": S(lambda f, T, m: f(T(X), -0.5, 0.5)),
    "sum": S(lambda f, T, m: f(T(I1), axis=1)),
    "mean": S(lambda f, T, m: f(T(X), axis=1, keepdim=True)),
    "max": S(lambda f, T, m: f(T(X), axis=0)),
    "min": S(lambda f, T, m: f(T(X), axis=1, keepdim=True)),
    "prod": S(lambda f, T, m: f(T(X), axis=0)),
    "cumsum": S(lambda f, T, m: f(T(X), axis=1)),
    "cumprod": S(lambda f, T, m: f(T(X), dim=1)),
    "logsumexp": S(lambda f, T, m: f(T(X), axis=1)),
    "logcumsumexp": S(lambda f, T, m: f(T(X), axis=1)),
    "isnan": S(lambda f, T, m: f(T(XNI))),
    "isinf": S(lambda f, T, m: f(T(XNI))),
    "isfinite": S(lambda f, T, m: f(T(XNI))),
    "erf": S(lambda f, T, m: f(T(X))),
    "erfinv": S(lambda f, T, m: f(T(U)), 1e-5, 1e-5),
    "lerp": S(lambda f, T, m: f(T(X), T(Y), 0.3)),
    "addmm": S(lambda f, T, m: f(T(A33), T(X), T(Y.T.copy()), 0.5, 2.0)),
    "inner": S(lambda f, T, m: f(T(X), T(Y))),
    "outer": S(lambda f, T, m: f(T(V3), T(V4))),
    "trace": S(lambda f, T, m: f(T(X))),
    "kron": S(lambda f, T, m: f(T(X[:2, :2].copy()), T(Y[:2, :3].copy()))),
    "nan_to_num": S(lambda f, T, m: f(T(XNI))),
    "amax": S(lambda f, T, m: f(T(X), axis=1)),
    "amin": S(lambda f, T, m: f(T(X))),
    "diff": S(lambda f, T, m: f(T(X))),
    "angle": S(lambda f, T, m: f(T(C))),
    "frac": S(lambda f, T, m: f(T(X * 3))),
    "rad2deg": S(lambda f, T, m: f(T(X)), 1e-5, 1e-5),
    "deg2rad": S(lambda f, T, m: f(T(X))),
    "gcd": S(lambda f, T, m: f(T(I1), T(I2))),
    "lcm": S(lambda f, T, m: f(T(I1), T(I2))),
    "heaviside": S(lambda f, T, m: f(T(XR), T(Y))),
    "digamma": S(lambda f, T, m: f(T(POS)), 1e-5, 1e-5),
    "lgamma": S(lambda f, T, m: f(T(POS)), 1e-5, 1e-5),
    "multiplex": S(lambda f, T, m: f([T(X), T(Y)], T(_i(1, 0, 1)[:, None]))),
    "stanh": S(lambda f, T, m: f(T(X))),
    "atan2": S(lambda f, T, m: f(T(X), T(Y))),
    "logit": S(lambda f, T, m: f(T(U01), 0.1)),
    "scale": S(lambda f, T, m: f(T(X), 2.0, 1.0, False)),
    "increment": S(lambda f, T, m: f(T(X), 2.0)),
    "acosh": S(lambda f, T, m: f(T(BIG))),
    "asinh": S(lambda f, T, m: f(T(X))),
    "atanh": S(lambda f, T, m: f(T(U))),
    "conj": S(lambda f, T, m: f(T(C))),
    "real": S(lambda f, T, m: f(T(C))),
    "imag": S(lambda f, T, m: f(T(C))),
    "complex": S(lambda f, T, m: f(T(X), T(Y))),
    "i0": S(lambda f, T, m: f(T(X)), 1e-5, 1e-6),
    "i0e": S(lambda f, T, m: f(T(X)), 1e-5, 1e-6),
    "i1": S(lambda f, T, m: f(T(X)), 1e-5, 1e-6),
    "i1e": S(lambda f, T, m: f(T(X)), 1e-5, 1e-6),
    "polygamma": S(lambda f, T, m: f(T(POS), 1), 1e-4, 1e-5),
    "nextafter": S(lambda f, T, m: f(T(X), T(Y)), 0, 0),
    "remainder": S(lambda f, T, m: f(T(X), T(POS))),
    "cummax": S(lambda f, T, m: f(T(XR), axis=1)),
    "cummin": S(lambda f, T, m: f(T(XR), axis=0)),
    "renorm": S(lambda f, T, m: f(T(X), 2.0, 0, 1.0)),
    "add_n": S(lambda f, T, m: f([T(X), T(Y), T(X)])),
    "copysign": S(lambda f, T, m: f(T(X), T(Y))),
    "ldexp": S(lambda f, T, m: f(T(X), T(ISMALL))),
    "hypot": S(lambda f, T, m: f(T(X), T(Y))),
    # manipulation
    "masked_scatter": S(lambda f, T, m: f(T(X), T(B1), T(V12))),
    "reshape": S(lambda f, T, m: f(T(X), [4, 3])),
    "flatten": S(lambda f, T, m: f(T(X3), 1, 2)),
    "transpose": S(lambda f, T, m: f(T(X3), [2, 0, 1])),
    "concat": S(lambda f, T, m: f([T(X), T(Y)], axis=1)),
    "stack": S(lambda f, T, m: f([T(X), T(Y)], axis=1)),
    "unstack": S(lambda f, T, m: f(T(X), axis=1)),
    "split": S(lambda f, T, m: f(T(X), [1, -1], axis=1)),
    "chunk": S(lambda f, T, m: f(T(X), 3, axis=1)),
    "squeeze": S(lambda f, T, m: f(T(X[:, None].copy()), axis=1)),
    "unsqueeze": S(lambda f, T, m: f(T(X), [0, 2])),
    "expand": S(lambda f, T, m: f(T(X[None].copy()), [2, -1, -1])),
    "expand_as": S(lambda f, T, m: f(T(X[:1].copy()), T(X))),
    "tile": S(lambda f, T, m: f(T(X), [2, 1])),
    "broadcast_to": S(lambda f, T, m: f(T(V4), [3, 4])),
    "flip": S(lambda f, T, m: f(T(X), [0, 1])),
    "roll": S(lambda f, T, m: f(T(X), 1, axis=1)),
    "gather": S(lambda f, T, m: f(T(X), T(_i(2, 0, 2)), axis=0)),
    "gather_nd": S(lambda f, T, m: f(T(X), T(np.array([[0, 1], [2, 3]])))),
    "scatter": S(lambda f, T, m: f(T(X), T(_i(2, 0)), T(Y[:2].copy()))),
    "scatter_nd_add": S(lambda f, T, m: f(
        T(X), T(np.array([[0, 1], [2, 3], [0, 1]])),
        T(np.array([1.0, 2.0, 3.0], np.float32)))),
    "index_select": S(lambda f, T, m: f(T(X), T(_i(3, 1)), axis=1)),
    "masked_select": S(lambda f, T, m: f(T(X), T(B1))),
    "where": S(lambda f, T, m: f(T(B1), T(X), T(Y))),
    "take_along_axis": S(lambda f, T, m: f(T(X), T(IDX2), 1)),
    "put_along_axis": S(lambda f, T, m: f(T(X), T(_i(3, 0, 1)[:, None]), 9.0,
                                          1)),
    "slice": S(lambda f, T, m: f(T(X), [0, 1], [1, 0], [3, 2])),
    "strided_slice": S(lambda f, T, m: f(T(X), [1], [0], [4], [2])),
    "cast": S(lambda f, T, m: f(T(X * 3), "int32")),
    "repeat_interleave": S(lambda f, T, m: f(T(X), 2, axis=0)),
    "unbind": S(lambda f, T, m: f(T(X), 0)),
    "moveaxis": S(lambda f, T, m: f(T(X3), 0, 2)),
    "swapaxes": S(lambda f, T, m: f(T(X3), 0, 2)),
    "as_complex": S(lambda f, T, m: f(T(X.reshape(3, 2, 2).copy()))),
    "as_real": S(lambda f, T, m: f(T(C))),
    "unique": S(lambda f, T, m: f(T(UNQ), True, True, True)),
    "masked_fill": S(lambda f, T, m: f(T(X), T(B1), 0.5)),
    "index_put": S(lambda f, T, m: f(T(X), (T(_i(0, 2)), T(_i(1, 3))),
                                     T(np.array([5.0, 6.0], np.float32)))),
    "rot90": S(lambda f, T, m: f(T(X))),
    "atleast_1d": S(lambda f, T, m: f(T(np.array(2.0, np.float32)))),
    "atleast_2d": S(lambda f, T, m: f(T(V3))),
    "atleast_3d": S(lambda f, T, m: f(T(X), T(V3))),
    "diagonal": S(lambda f, T, m: f(T(X3), 0, 1, 2)),
    "diag_embed": S(lambda f, T, m: f(T(X), 1)),
    "fill_diagonal": S(lambda f, T, m: f(T(TALL), 7.0, wrap=True)),
    "index_add": S(lambda f, T, m: f(T(X), T(_i(0, 2)), 0,
                                     T(Y[:2].copy()))),
    "index_fill": S(lambda f, T, m: f(T(X), T(_i(1)), 1, 0.0)),
    "reverse": S(lambda f, T, m: f(T(X), 0)),
    "crop": S(lambda f, T, m: f(T(X), [2, -1], [1, 1])),
    "unique_consecutive": S(lambda f, T, m: f(T(UC), True, True)),
    # linalg
    "cond": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5),
    "pca_lowrank": S(lambda f, T, m: f(T(LOWRANK), q=3), 1e-3, 1e-4,
                     post=lambda r: r[1][:2]),
    "cov": S(lambda f, T, m: f(T(X))),
    "corrcoef": S(lambda f, T, m: f(T(X)), 1e-5, 1e-5),
    "matrix_exp": S(lambda f, T, m: f(T(A / 4)), 1e-4, 1e-5),
    "pdist": S(lambda f, T, m: f(T(X))),
    "householder_product": S(lambda f, T, m: f(T(HX), T(TAU)), 1e-4, 1e-5),
    "cholesky_solve": S(lambda f, T, m: f(T(B42), T(L)), 1e-4, 1e-5),
    "eigvals": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5,
                 post=lambda r: np.sort_complex(np.asarray(r).astype(
                     np.complex128))),
    "eigvalsh": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5),
    "lu": S(lambda f, T, m: f(T(A)), 1e-5, 1e-5),
    "lu_unpack": S(lambda f, T, m: f(*m.lu(T(A))), 1e-5, 1e-5),
    "matmul": S(lambda f, T, m: f(T(X), T(Y), transpose_y=True)),
    "mm": S(lambda f, T, m: f(T(X), T(Y.T.copy()))),
    "bmm": S(lambda f, T, m: f(T(X3), T(Y3))),
    "dot": S(lambda f, T, m: f(T(X), T(Y))),
    "t": S(lambda f, T, m: f(T(X))),
    "norm": S(lambda f, T, m: f(T(X), p=2, axis=1)),
    "dist": S(lambda f, T, m: f(T(X), T(Y), 3)),
    "cross": S(lambda f, T, m: f(T(X43), T(Y43))),
    "cholesky": S(lambda f, T, m: f(T(A)), 1e-5, 1e-6),
    "qr": S(lambda f, T, m: f(T(X43)), 1e-4, 1e-5, post=_abs),
    "svd": S(lambda f, T, m: f(T(X)), 1e-4, 1e-5, post=_abs),
    "eig": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5, post=_eig_values),
    "eigh": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5, post=_abs),
    "inv": S(lambda f, T, m: f(T(A)), 1e-4, 1e-5),
    "pinv": S(lambda f, T, m: f(T(X)), 1e-4, 1e-5),
    "det": S(lambda f, T, m: f(T(A)), 1e-5, 1e-6),
    "slogdet": S(lambda f, T, m: f(T(A)), 1e-5, 1e-6),
    "solve": S(lambda f, T, m: f(T(A), T(B42)), 1e-4, 1e-5),
    "triangular_solve": S(lambda f, T, m: f(T(np.triu(A)), T(B42), True,
                                            True), 1e-4, 1e-5),
    "lstsq": S(lambda f, T, m: f(T(X43), T(B42)), 1e-4, 1e-5,
               post=lambda r: r[0]),
    "matrix_power": S(lambda f, T, m: f(T(A), 3), 1e-5, 1e-5),
    "matrix_rank": S(lambda f, T, m: f(T(X))),
    "mv": S(lambda f, T, m: f(T(X), T(V4))),
    "histogram": S(lambda f, T, m: f(T(HIST), 5, -2.0, 2.0)),
    "bincount": S(lambda f, T, m: f(T(NONNEG))),
    "multi_dot": S(lambda f, T, m: f([T(X), T(X.T.copy()), T(X)])),
    "einsum": S(lambda f, T, m: f("ij,kj->ik", T(X), T(Y))),
    # logic
    "is_empty": S(lambda f, T, m: f(T(np.zeros((0, 3), np.float32)))),
    "equal": S(lambda f, T, m: f(T(XR), T(YR))),
    "not_equal": S(lambda f, T, m: f(T(XR), T(YR))),
    "greater_than": S(lambda f, T, m: f(T(XR), T(YR))),
    "greater_equal": S(lambda f, T, m: f(T(XR), T(YR))),
    "less_than": S(lambda f, T, m: f(T(XR), T(YR))),
    "less_equal": S(lambda f, T, m: f(T(XR), T(YR))),
    "logical_and": S(lambda f, T, m: f(T(B1), T(B2))),
    "logical_or": S(lambda f, T, m: f(T(B1), T(B2))),
    "logical_not": S(lambda f, T, m: f(T(B1))),
    "logical_xor": S(lambda f, T, m: f(T(B1), T(B2))),
    "equal_all": S(lambda f, T, m: f(T(X), T(X))),
    "allclose": S(lambda f, T, m: f(T(X), T(X + 1e-7))),
    "isclose": S(lambda f, T, m: f(T(X), T(X + 1e-3 * XR))),
    "is_tensor": S(lambda f, T, m: f(T(X))),
    "bitwise_and": S(lambda f, T, m: f(T(I1), T(I2))),
    "bitwise_or": S(lambda f, T, m: f(T(I1), T(I2))),
    "bitwise_xor": S(lambda f, T, m: f(T(I1), T(I2))),
    "bitwise_not": S(lambda f, T, m: f(T(I1))),
    "all": S(lambda f, T, m: f(T(B1), axis=1)),
    "any": S(lambda f, T, m: f(T(B1), axis=0, keepdim=True)),
    # stat
    "std": S(lambda f, T, m: f(T(X), axis=0)),
    "var": S(lambda f, T, m: f(T(X), unbiased=False)),
    "median": S(lambda f, T, m: f(T(X), axis=1)),
    "quantile": S(lambda f, T, m: f(T(X), 0.3, axis=0)),
    "nanmean": S(lambda f, T, m: f(T(XN))),
    "nansum": S(lambda f, T, m: f(T(XN), axis=1)),
    "nanmedian": S(lambda f, T, m: f(T(XN), axis=1)),
    "kthvalue": S(lambda f, T, m: f(T(X), 2, axis=1)),
    "mode": S(lambda f, T, m: f(T(MODE), axis=1)),
    # search
    "argmax": S(lambda f, T, m: f(T(X), axis=1)),
    "argmin": S(lambda f, T, m: f(T(X))),
    "argsort": S(lambda f, T, m: f(T(X), axis=-1, descending=True)),
    "sort": S(lambda f, T, m: f(T(X), axis=0)),
    "topk": S(lambda f, T, m: f(T(X), 2, axis=1)),
    "searchsorted": S(lambda f, T, m: f(T(SORTED), T(X))),
    "nonzero": S(lambda f, T, m: f(T(XR))),
    "index_sample": S(lambda f, T, m: f(T(X), T(IDX2))),
    "bucketize": S(lambda f, T, m: f(T(X), T(SORTED), right=True)),
    # extras
    "take": S(lambda f, T, m: f(T(X), T(_i(0, -1, 5)))),
    "scatter_nd": S(lambda f, T, m: f(T(np.array([[0, 1], [2, 3], [0, 1]])),
                                      T(np.array([1.0, 2.0, 3.0],
                                                 np.float32)), [3, 4])),
    "tensordot": S(lambda f, T, m: f(T(X), T(Y.T.copy()), axes=1)),
    "cdist": S(lambda f, T, m: f(T(X), T(Y)), 1e-5, 1e-5),
    "count_nonzero": S(lambda f, T, m: f(T(XR), axis=1)),
    "sgn": S(lambda f, T, m: f(T(C))),
    "trapezoid": S(lambda f, T, m: f(T(X))),
    "cumulative_trapezoid": S(lambda f, T, m: f(T(X), dx=0.5)),
    "unflatten": S(lambda f, T, m: f(T(X), 1, [2, -1])),
    "vsplit": S(lambda f, T, m: f(T(X6), [2, 4])),
    "frexp": S(lambda f, T, m: f(T(X))),
    "logaddexp": S(lambda f, T, m: f(T(X), T(Y))),
    "broadcast_tensors": S(lambda f, T, m: f([T(X), T(V4)])),
    "broadcast_shape": S(lambda f, T, m: f([3, 1], [1, 4])),
    "nanquantile": S(lambda f, T, m: f(T(XN), 0.5, axis=1)),
    "polar": S(lambda f, T, m: f(T(POS), T(X))),
    "as_strided": S(lambda f, T, m: f(T(X), [2, 2], [1, 2], 1)),
    "view": S(lambda f, T, m: f(T(X), "int32")),
    "view_as": S(lambda f, T, m: f(T(X), T(X.T.copy()))),
    "unfold": S(lambda f, T, m: f(T(X), 1, 2, 1)),
    "rank": S(lambda f, T, m: f(T(X3))),
    "shape": S(lambda f, T, m: f(T(X3))),
    "is_complex": S(lambda f, T, m: f(T(C))),
    "is_integer": S(lambda f, T, m: f(T(I1))),
    "is_floating_point": S(lambda f, T, m: f(T(X))),
    "floor_mod": S(lambda f, T, m: f(T(X), T(POS))),
    "iinfo": S(lambda f, T, m: f("int16")),
    "finfo": S(lambda f, T, m: f("bfloat16")),
}

#: the draws: (call, the law's mean and variance, the range [lo, hi))
N_DRAW = 20000
DRAWS = {
    "rand": (lambda f, T: f([N_DRAW]), (0.5, 1 / 12), (0, 1)),
    "randn": (lambda f, T: f([N_DRAW]), (0.0, 1.0), None),
    "standard_normal": (lambda f, T: f([N_DRAW]), (0.0, 1.0), None),
    "randint": (lambda f, T: f(0, 10, [N_DRAW]), (4.5, 99 / 12), (0, 10)),
    "uniform": (lambda f, T: f([N_DRAW], min=-2.0, max=2.0), (0.0, 16 / 12),
                (-2, 2)),
    "normal": (lambda f, T: f(1.0, 2.0, [N_DRAW]), (1.0, 4.0), None),
    "randperm": (lambda f, T: f(50), None, (0, 50)),
    "bernoulli": (lambda f, T: f(T(np.full(N_DRAW, 0.3, np.float32))),
                  (0.3, 0.21), (0, 2)),
    "multinomial": (lambda f, T: f(T(np.array([0.1, 0.2, 0.3, 0.4],
                                              np.float32)), N_DRAW, True),
                    (2.0, 1.0), (0, 4)),
    "poisson": (lambda f, T: f(T(np.full(N_DRAW, 3.0, np.float32))),
                (3.0, 3.0), (0, 1000)),
    "shuffle": (lambda f, T: f(T(np.arange(50, dtype=np.float32))), None,
                (0, 50)),
    "randint_like": (lambda f, T: f(T(np.zeros(N_DRAW, np.float32)), 0, 5),
                     (2.0, 2.0), (0, 5)),
}


# -- normalisation and comparison ------------------------------------------------

def _np(r):
    if isinstance(r, (list, tuple)):
        return [_np(x) for x in r]
    if isinstance(r, torch.Tensor):
        return r.detach().resolve_conj().numpy()
    if hasattr(r, "_value"):        # JAX's eager Tensor
        r = r._value
    if type(r).__name__ in ("finfo", "iinfo"):
        return {"bits": int(r.bits), "max": float(r.max),
                "min": float(r.min)}
    return np.asarray(r)


#: (port, JAX) dtype pairs the 64-bit difference allows
WIDER = {(np.dtype("int64"), np.dtype("int32")),
         (np.dtype("float64"), np.dtype("float32")),
         (np.dtype("complex128"), np.dtype("complex64"))}


def _cmp(p, j, rtol, atol, where="out"):
    if isinstance(j, list):
        assert isinstance(p, list) and len(p) == len(j), where
        for i, (a, b) in enumerate(zip(p, j)):
            _cmp(a, b, rtol, atol, f"{where}[{i}]")
        return
    if isinstance(j, dict):
        assert p == j, where
        return
    p, j = np.asarray(p), np.asarray(j)
    assert p.shape == j.shape, (where, p.shape, j.shape)
    assert p.dtype == j.dtype or (p.dtype, j.dtype) in WIDER, \
        (where, p.dtype, j.dtype)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(p.astype(j.dtype), j, err_msg=where)
    else:
        np.testing.assert_allclose(p.astype(j.dtype), j, rtol=rtol,
                                   atol=atol, equal_nan=True, err_msg=where)


def _draw_check(name, f_port, f_jax):
    call, law, bounds = DRAWS[name]
    jout = _np(call(f_jax, jnp.asarray))
    trng.seed(11)
    first = call(f_port, torch.from_numpy)
    trng.seed(11)
    again = call(f_port, torch.from_numpy)
    assert torch.equal(first, again)          # the same seed, the same draw
    trng.seed(12)
    other = call(f_port, torch.from_numpy)
    assert not torch.equal(first, other)
    pout = _np(first)
    assert pout.shape == jout.shape
    assert pout.dtype == jout.dtype or (pout.dtype, jout.dtype) in WIDER
    if bounds is not None:
        lo, hi = bounds
        assert pout.min() >= lo and pout.max() < hi
    if law is None:        # a permutation of 0..n-1
        np.testing.assert_array_equal(np.sort(pout), np.arange(50))
        return
    mean, var = law
    n = pout.size
    x = pout.astype(np.float64)
    assert abs(x.mean() - mean) <= 5 * (var / n) ** 0.5
    assert abs(x.var() - var) <= 5 * var * (2 / n) ** 0.5 + 5 * (
        (np.mean((x - mean) ** 4) - var ** 2) / n) ** 0.5


def test_every_name_has_a_case():
    assert len(PAIRS) == 302
    for m, n in PAIRS:
        assert n in SPEC or n in DRAWS or n == "set_printoptions", (m, n)
        assert n in TM[m].__all__, (m, n)
    for m in MODULES:
        assert TM[m].__all__ == JM[m].__all__, m


@pytest.mark.parametrize("module,name", PAIRS,
                         ids=[f"{m}.{n}" for m, n in PAIRS])
def test_tensor_op(module, name):
    f_jax, f_port = getattr(JM[module], name), getattr(TM[module], name)
    if name in DRAWS:
        _draw_check(name, f_port, f_jax)
        return
    if name == "set_printoptions":
        saved_np = np.get_printoptions()
        try:
            assert f_jax(precision=3) is None
            assert f_port(precision=3, sci_mode=False) is None
            assert np.get_printoptions()["precision"] == 3
            assert "1.235" in str(torch.tensor([1.23456]))
        finally:
            np.set_printoptions(**saved_np)
            torch.set_printoptions(profile="default")
        return
    spec = SPEC[name]
    got = _np(spec["fn"](f_port, torch.from_numpy, TM[module]))
    want = _np(spec["fn"](f_jax, jnp.asarray, JM[module]))
    if spec["post"] is not None:
        got, want = _np(spec["post"](got)), _np(spec["post"](want))
    _cmp(got, want, spec["rtol"], spec["atol"])


def test_creation_places_on_this_threads_device():
    """The port's creation ops take the device set_device chose (the CPU
    here); int64 where JAX's int32 (64-bit types on)."""
    for t in (TM["creation"].zeros([2]), TM["creation"].arange(3),
              TM["random"].rand([2]), TM["creation"].to_tensor([1, 2])):
        assert t.device.type == "cpu"
    assert TM["creation"].arange(3).dtype == torch.int64
    assert TM["creation"].to_tensor([1, 2]).dtype == torch.int64
    assert jnp.asarray(JM["creation"].arange(3)).dtype == jnp.int32
    t = TM["creation"].to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.dtype == torch.float32
