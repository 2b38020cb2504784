"""CUDA kernels: blocked Cholesky, batched solve and the fused γ sweep.

The ports of the Pallas TPU kernels ``repro.kernels.solve.blocked_cholesky``,
``cholesky_solve`` and ``multi_gamma_solve``, which serve systems narrower
than the streamed path's ``STREAM_MIN_DIM`` and the whole γ grid at any
width. Each is a schedule of grids over all SMs, for every system of the
call at once, launched from one C call. ``blocked_cholesky``: for each
panel of ``PANEL`` columns, a diagonal kernel (one block a system), a trsm
grid and a trailing-update grid (:func:`cuda_launches`).
``cholesky_solve``: one grid inverting every diagonal block, then the
forward and backward substitutions, two grids a panel each way
(:func:`solve_cuda_launches`). ``multi_gamma_solve``: the factor's schedule
over every γ at once, C read in place by all of them and γ_j added at the
first panel, then the substitutions with Q read in place
(:func:`sweep_cuda_launches`).

The kernels are ``csrc/blocked.cu`` (its header states the design and the
bounds on an H100), built by ``kernels.build`` and bound with ``ctypes``.
They take contiguous CUDA tensors, every operand of one call f32 or every
one f64 (each kernel has an instance of each), and read only the lower
triangle of a system or factor. ``kernels.solve`` dispatches between these
wrappers (CUDA tensors) and the plain versions in ``kernels.ref`` (CPU
tensors).
Each wrapper counts its calls in ``.launches``, one a call.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "blocked.cu"
PANEL = 128              # the panel width compiled into the kernels (kPanel)
MAX_SYSTEMS = 65535      # systems (γs) one call takes (a grid's y and z limit)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "afl_blocked_cholesky": [_P, _P, _P, _P, _I, _I, _P],
    "afl_cholesky_solve": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "afl_multi_gamma_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/blocked.cu`` (once per source content), load it and
    declare its entry points."""
    built = _build.load(SOURCE)[0]
    for name, argtypes in _SIGNATURES.items():
        for suffix in _build.SUFFIX.values():
            fn = getattr(built.lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return built


def _entry(name: str, dtype: torch.dtype):
    return getattr(build().lib, f"afl_{name}_{_build.SUFFIX[dtype]}")


def cuda_launches(d: int) -> int:
    """CUDA kernel launches of one ``blocked_cholesky`` call on d-wide
    systems: a diagonal kernel per panel, and a trsm and a trailing update
    per panel but the last."""
    n = -(-d // PANEL)
    return 3 * n - 2


def _substitution_launches(d: int) -> int:
    """The forward and backward substitutions: a grid applying each panel's
    inverse, and one updating the rows past it for every panel but the
    last, each way."""
    return 2 * (2 * -(-d // PANEL) - 1)


def solve_cuda_launches(d: int) -> int:
    """CUDA kernel launches of one ``cholesky_solve`` call on d-wide
    systems: one grid of the inverse diagonal blocks, then the
    substitutions."""
    return 1 + _substitution_launches(d)


def sweep_cuda_launches(d: int) -> int:
    """CUDA kernel launches of one ``multi_gamma_solve`` call on a d-wide
    C: the factor's schedule, whose diagonal kernels keep every inverse,
    then the substitutions."""
    return cuda_launches(d) + _substitution_launches(d)


def _operand(name: str, t: torch.Tensor, shape: tuple[int, ...],
             dtype: Optional[torch.dtype] = None) -> None:
    """Checks one operand; ``dtype`` is the call's (its first operand's)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the blocked kernels need CUDA tensors, got {t.device} "
                         "(kernels.solve takes the plain version for CPU tensors)")
    if t.dtype not in _build.SUFFIX or t.dtype != (dtype or t.dtype):
        raise TypeError(f"{name}: the blocked kernels take f32 or f64, every operand of "
                        f"one dtype, got {t.dtype}" + (f" beside {dtype}" if dtype else ""))
    if tuple(t.shape) != shape or 0 in shape:
        raise ValueError(f"{name}: expected a non-empty {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides {t.stride()}")


def _systems(name: str, a: torch.Tensor) -> tuple[int, int]:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"{name}: expected (m, d, d) systems, got {tuple(a.shape)}")
    if a.shape[0] > MAX_SYSTEMS:
        raise ValueError(f"{name}: {a.shape[0]} systems, more than {MAX_SYSTEMS} a call")
    return a.shape[0], a.shape[1]


def _same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"blocked kernels need one device, got {[t.device for t in ts]}")


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _scratch(*shape: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _inverses(n: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch for each system's inverse diagonal blocks, one per panel."""
    return _scratch(n, -(-d // PANEL), PANEL, PANEL, like=like)


def blocked_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (m, d, d) SPD systems, panels of 128;
    clean lower triangles. Only the lower triangle of ``a`` is read. A
    system that is not positive definite gives NaNs."""
    m, d = _systems("blocked_cholesky", a)
    _operand("blocked_cholesky a", a, (m, d, d))
    fn = _entry("blocked_cholesky", a.dtype)
    out = torch.empty_like(a)
    zs = _scratch(m, PANEL, PANEL, like=a)
    panels = _scratch(m, d, PANEL, like=a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), zs.data_ptr(), panels.data_ptr(), m, d,
                 stream)
    _check(err, "blocked_cholesky")
    blocked_cholesky.launches += 1
    return out


def cholesky_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L Lᵀ x = b`` for lower factors ``l`` (m, d, d) (the upper triangle
    is not read) and right-hand sides ``b`` (m, d, c) → x (m, d, c)."""
    m, d = _systems("cholesky_solve", l)
    _operand("cholesky_solve l", l, (m, d, d))
    if b.dim() != 3:
        raise ValueError(f"cholesky_solve: expected (m, d, c) right-hand sides, got "
                         f"{tuple(b.shape)}")
    c = b.shape[2]
    _operand("cholesky_solve b", b, (m, d, c), l.dtype)
    _same_device(l, b)
    fn = _entry("cholesky_solve", l.dtype)
    x = torch.empty_like(b)
    zs = _inverses(m, d, like=l)
    y = torch.empty_like(b)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(l.data_ptr(), b.data_ptr(), x.data_ptr(), zs.data_ptr(), y.data_ptr(),
                 m, d, c, stream)
    _check(err, "cholesky_solve")
    cholesky_solve.launches += 1
    return x


def multi_gamma_solve(c: torch.Tensor, q: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """The fused γ sweep: ``(C + γ_j I) W_j = Q`` for every γ of ``gammas``
    (n_g,), C (d, d) (lower triangle read), Q (d, c) → W (n_g, d, c). C
    and Q are read in place by every γ; the wrapper allocates each γ's
    (d, d) factor. A γ whose system is not positive definite gives NaNs in
    its W_j only."""
    if c.dim() != 2 or q.dim() != 2 or gammas.dim() != 1:
        raise ValueError(f"multi_gamma_solve: expected C (d, d), Q (d, c) and γ (n_g,), "
                         f"got {tuple(c.shape)}, {tuple(q.shape)}, {tuple(gammas.shape)}")
    d, n_cls = q.shape
    n_g = gammas.shape[0]
    if n_g > MAX_SYSTEMS:
        raise ValueError(f"multi_gamma_solve: {n_g} γs, more than {MAX_SYSTEMS} a call")
    _operand("multi_gamma_solve C", c, (d, d))
    _operand("multi_gamma_solve Q", q, (d, n_cls), c.dtype)
    _operand("multi_gamma_solve gammas", gammas, (n_g,), c.dtype)
    _same_device(c, q, gammas)
    fn = _entry("multi_gamma_solve", c.dtype)
    factors = _scratch(n_g, d, d, like=c)
    zs = _inverses(n_g, d, like=c)
    panels = _scratch(n_g, d, PANEL, like=c)
    y = _scratch(n_g, d, n_cls, like=c)
    w = _scratch(n_g, d, n_cls, like=c)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            c.data_ptr(), q.data_ptr(), gammas.data_ptr(), factors.data_ptr(), zs.data_ptr(),
            panels.data_ptr(), y.data_ptr(), w.data_ptr(), n_g, d, n_cls, stream)
    _check(err, "multi_gamma_solve")
    multi_gamma_solve.launches += 1
    return w


blocked_cholesky.launches = 0
cholesky_solve.launches = 0
multi_gamma_solve.launches = 0
