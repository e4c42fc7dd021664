"""Chebyshev matrix-function actions for Hermitian operators (PyTorch port
of ``exponentialutilities_jl_tpu/models/chebyshev.py``).

With [lo, hi] enclosing A's spectrum, A~ = (A - cI)/h (c, h the interval's
center and half-width) and U_k the Chebyshev polynomials of the second
kind,

    f(A) b = sum_k b_k U_k(A~) b,  u_{k+1} = 2 A~ u_k - u_{k-1},

a matvec-only recurrence with no inner products. For exp the coefficients
come from the modified-Bessel identity e^{zx} = sum_k (I_k(z) - I_{k+2}(z))
U_k(x), computed on the host with scaled ``scipy.special.ive`` so the
e^{t hi} magnitude factors out exactly; for any other f (the phi
functions, ``funm_chebyshev``) from a cosine transform of f sampled at
Chebyshev points. A (m, p) coefficient stack gives p combinations of the
same recurrence at once (all phi orders, all snapshot times).

On a CUDA device with a supported operator the recurrence runs in the
hand-written kernels: one real coefficient column through
``ops.kernels.dispatch.recurrence_engine`` (1-D stencil: B1; banded: B5;
small 2-D/3-D grid: B6; larger grids: B3, one sweep per degree), a real
(m, p) stack on a 1-D stencil through B4 when ``resident_multi_ok``
holds; otherwise it runs as the plain torch loop ``_chebyshev_apply_scan``
(whose matvecs reach the SpMV kernels B7-B9), one degree step replayed from
a CUDA graph on the card (``ops/krylov._run``: step 0 eagerly, the rest
through a ``utils/graphs.LoopRunner``; eagerly where autograd must see
the call). ``chebyshev_apply`` unwraps a
``SortedSellOperator`` on entry (``hoist_conjugation``). A row-sharded
operator (``parallel.shard_operator``) takes the plain loop on this rank's
rows; the recurrence has no reductions, and the drivers' finiteness check
is one over every rank (``utils/comm.py``), so a divergence raises on all
of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.kernels.dispatch import (chebyshev_rows, recurrence_engine,
                                    resident_multi_ok)
from ..ops.krylov import _run, _State, _term
from ..ops.sparse import hoist_conjugation
from ..utils.comm import all_finite, operator_comm
from ..utils.device import action_vector
from ..utils.linop import aslinearoperator
from ..utils.precision import full_precision

__all__ = ["spectral_bounds", "expv_chebyshev", "phiv_chebyshev",
           "funm_chebyshev", "chebyshev_apply", "phiv_timestep_chebyshev"]

_M_MAX = 4096


def spectral_bounds(A, probe=None, *, k: int = 30, seed: int = 0,
                    pad_rel: float = 1e-3, nprobe: int = 2):
    """Enclosure (lo, hi) of a Hermitian operator's spectrum from ``k``
    storage-free Lanczos steps: the extreme Ritz values padded by their
    per-pair residuals beta_k |s_k| plus ``pad_rel`` of the width, as the
    union over ``nprobe`` random probes (``torch.Generator`` seeded with
    seed, seed + 1, ...) or over the one given ``probe``. Returns host
    floats. A row-sharded operator takes this rank's rows of the same
    global probes (a given ``probe`` is this rank's rows)."""
    from ..ops.krylov import lanczos_coeffs

    op = aslinearoperator(A)
    if not op.is_hermitian:
        raise ValueError("spectral_bounds requires a Hermitian operator")
    n = op.shape[0]
    k = min(k, n)
    comm = operator_comm(op)
    nl = n if comm is None else n // comm.axis_size()
    lo_row = 0 if comm is None else comm.axis_index() * nl
    if probe is None:
        probes = []
        for i in range(max(1, nprobe)):
            g = torch.Generator().manual_seed(seed + i)
            probes.append(torch.randn(n, generator=g, dtype=torch.float64)
                          [lo_row:lo_row + nl]
                          .to(dtype=op.dtype, device=op.device))
    else:
        probes = [probe]

    lo = hi = None
    for pv in probes:
        alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, pv, k)
        a = alphas.detach().cpu().double().numpy()
        b = betas.detach().cpu().double().numpy()
        mu = int(m_used)
        if mu == 0:
            continue
        T = np.diag(a[:mu]) + np.diag(b[:mu - 1], 1) + np.diag(b[:mu - 1], -1)
        theta, S = np.linalg.eigh(T)
        # per-pair residual |A s - theta s| = beta_k |last eigvec component|
        resid = (float(b[mu - 1]) if mu < n else 0.0) * np.abs(S[-1, :])
        lo_i = float(theta[0] - resid[0])
        hi_i = float(theta[-1] + resid[-1])
        lo = lo_i if lo is None else min(lo, lo_i)
        hi = hi_i if hi is None else max(hi, hi_i)
    if lo is None:
        return 0.0, 0.0
    pad = pad_rel * max(hi - lo, abs(hi), abs(lo), 1e-300)
    return lo - pad, hi + pad


def _t_to_u(a):
    """Chebyshev-T series coefficients (a_0 not pre-halved) to the U basis:
    with T_0 = U_0 and T_k = (U_k - U_{k-2})/2,
    b_0 = a_0 - a_2/2 and b_k = (a_k - a_{k+2})/2 for k >= 1."""
    a = np.asarray(a)
    ext = np.concatenate([a, np.zeros((2,) + a.shape[1:], a.dtype)])
    b = (ext[:-2] - ext[2:]) / 2.0
    b[0] = a[0] - ext[2] / 2.0
    return b


def _exp_ucoeffs(z, tol: float, m_fixed: int | None = None):
    """U-basis coefficients of e^{zx} on [-1, 1], truncated so the dropped
    tail is <= tol * sum|coeffs|; returns (coeffs, scale_exponent) with the
    true coefficients = coeffs * e^{scale_exponent}. Raises if the tail
    has not decayed within the degree cap; ``m_fixed`` bypasses the
    selection and the raise."""
    import scipy.special as sps

    nmax = max(_M_MAX, (m_fixed or 0)) if m_fixed else _M_MAX
    orders = np.arange(nmax + 2)
    if np.iscomplexobj(np.asarray(z)):
        # scipy's ive scales by e^{-|Re z|} for complex arguments too
        iv = sps.ive(orders, complex(z))
        scale = abs(complex(z).real)
    else:
        iv = sps.ive(orders, float(z))
        scale = abs(float(z))
    b = iv[:-2] - iv[2:]                      # I_k - I_{k+2}, scaled
    if m_fixed is not None:
        return b[:m_fixed], scale
    mag = np.abs(b)
    total = mag.sum()
    if total == 0:
        return b[:1], scale
    # smallest m with tail below tolerance (superlinear decay past |z|)
    tail = np.cumsum(mag[::-1])[::-1]
    keep = np.nonzero(tail > tol * total)[0]
    m = int(keep[-1]) + 1 if keep.size else 1
    if m >= _M_MAX:
        raise ValueError(
            f"Chebyshev degree did not converge below the {_M_MAX} cap "
            f"at tol={tol:g} (|z| = {abs(z):.3g}; growth spectra need "
            "degree >~ |z|) - split t into substeps "
            "(exp(tA) = exp(t/q A)^q), pass a fixed degree m, or use "
            "the Krylov expv")
    return b[:m], scale


def _full_exp_coeffs(t, lo: float, hi: float, tol: float, m: int | None):
    """The true e^{t lambda} expansion coefficients on [lo, hi], with the
    e^{t c} amplitude and phase folded in overflow-safely: returns (numpy
    coeffs, center, halfwidth)."""
    tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    coeffs, scale = _exp_ucoeffs(tc * h, tol, m_fixed=m)
    amp = np.exp(np.real(tc) * c + scale)
    phase = (np.exp(1j * np.imag(tc) * c)
             if np.iscomplexobj(np.asarray(tc)) else 1.0)
    return coeffs * amp * phase, c, h


def _phi_scalar_np(z, p: int):
    """phi_0..phi_p at real/complex sample points z (numpy, f64), (p+1,) +
    z.shape: Taylor series for small |z| (the recurrence cancels there),
    the upward recurrence phi_j = (phi_{j-1} - 1/(j-1)!)/z otherwise."""
    z = np.atleast_1d(np.asarray(
        z, np.complex128 if np.iscomplexobj(z) else np.float64))
    out = np.zeros((p + 1,) + z.shape, z.dtype)
    small = np.abs(z) < 0.5
    zb = np.where(small, 1.0, z)
    out[0] = np.exp(z)
    acc = out[0]
    for j in range(1, p + 1):
        acc = (acc - 1.0 / math.factorial(j - 1)) / zb
        out[j] = acc
    if small.any():
        zs = z[small]
        for j in range(p + 1):
            s = np.zeros_like(zs)
            term = np.ones_like(zs) / math.factorial(j)
            for i in range(1, 30):
                s = s + term
                term = term * zs / (i + j)
            out[j][small] = s + term
    return out


def _fun_ucoeffs(f, tol: float, samples: int, m_fixed: int | None = None):
    """U-basis coefficients of f on [-1, 1] from a cosine transform of f at
    Chebyshev points (f may return a (p+1, samples) stack: (m, p+1)
    coefficients).

    A coefficient tail still above ``tol`` near the sample count means
    the transform is aliased: the sample count doubles, up to 8x, and then
    it raises rather than return an inaccurate expansion. ``m_fixed``
    bypasses the tail selection and the raise."""
    import scipy.fft as sfft

    M = samples
    if m_fixed is not None:
        M = max(M, 2 * m_fixed)
    for _ in range(4):
        theta = (np.arange(M) + 0.5) * np.pi / M
        fx = np.asarray(f(np.cos(theta)))             # (..., M)
        # a_k = (2/M) sum_j f(x_j) cos(k theta_j): DCT-II / M
        if np.iscomplexobj(fx):
            a = (sfft.dct(fx.real, type=2, axis=-1)
                 + 1j * sfft.dct(fx.imag, type=2, axis=-1)) / M
        else:
            a = sfft.dct(fx, type=2, axis=-1) / M
        a = np.moveaxis(np.atleast_2d(a), -1, 0)      # (M, p+1) or (M, 1)
        a[0] = a[0] / 2.0
        b = _t_to_u(a)
        mag = np.abs(b).max(axis=tuple(range(1, b.ndim)))
        if m_fixed is not None:
            # a fixed degree still needs unaliased leading coefficients
            if float(mag[-8:].max()) <= 1e-12 * float(mag.max()):
                return b[:m_fixed]
            M *= 2
            continue
        total = mag.sum()
        if total == 0:
            return b[:1]
        tail = np.cumsum(mag[::-1])[::-1]
        keep = np.nonzero(tail > tol * total)[0]
        m = int(keep[-1]) + 1 if keep.size else 1
        if m < M - 2:
            return b[:m]
        M *= 2                                        # aliased: resample
    if m_fixed is not None:
        return b[:m_fixed]          # the caller accepted truncation error
    raise ValueError(
        f"Chebyshev expansion did not converge below tol={tol:g} within "
        f"{M // 2} sample points - the function needs a higher degree "
        "than is practical on this interval (for stiff horizons use the "
        "substepped Krylov drivers)")


@full_precision
def _chebyshev_apply_scan(op, b, coeffs, center, inv_h):
    """w = sum_{k<m} coeffs[k] U_k(A~) b with A~ = inv_h (A - center I), as
    a plain torch matvec loop (no reductions). coeffs (m,) or (m, p).
    One degree step over state made before the loop, coeffs[k] read at the
    step counter (``ops/krylov._run``: a replayed graph on a CUDA device)."""
    cdt = coeffs.dtype
    z = (b * 0).to(cdt)
    w = z if coeffs.ndim == 1 else z[:, None].expand(
        b.shape + coeffs.shape[1:]).clone()
    # u_{-1} = 0; u_0 a copy, which the in-place steps overwrite
    S = _State(b.device, up=torch.zeros_like(b), uc=b.clone(), w=w)

    def step():
        S.apply("w", torch.add, S.w,
                _term(S.uc, coeffs.index_select(0, S.jj[:1])[0], cdt))
        # u_{k+1} = 2 A~ u_k - u_{k-1} (u_{-1} = 0: U_1 = 2 A~ U_0)
        y = (2.0 * inv_h) * (op.matvec(S.uc) - center * S.uc) - S.up
        S.set("up", S.uc)
        S.set("uc", y)
        S.step_on()

    _run("chebyshev_apply", op, S, step, coeffs.shape[0], b.device)
    return S.w


def chebyshev_apply(A, b, ucoeffs, bounds, *, fused: bool | None = None):
    """sum_k ucoeffs[k] U_k(A~) b for A~ the affine map of A onto the
    interval ``bounds``. ucoeffs (m,) or (m, p) (all p combinations in one
    matvec stream). On a CUDA device real (m,) coefficients take the
    engine of ``recurrence_engine`` and a real (m, p) stack takes B4 when
    ``resident_multi_ok`` holds; ``fused=True`` demands a kernel and
    ``fused=False`` forbids it."""
    from ..ops.kernels.resident import recurrence_apply_resident_multi

    op = aslinearoperator(A)
    b = action_vector(b, op)
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # sorted-conjugated container: the whole U_k recurrence runs in
        # the sorted basis (polynomials commute with the conjugation)
        return post(chebyshev_apply(op, b, ucoeffs, bounds, fused=fused))
    lo, hi = bounds
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        raise ValueError(f"empty spectral interval {bounds}")
    coeffs = torch.as_tensor(ucoeffs, device=b.device)
    if coeffs.ndim == 1 and not coeffs.is_complex():
        engine = recurrence_engine(op, b.dtype, fused, device=b.device,
                                   hermitian=True, operands=(b, coeffs))
        if engine is not None:
            return engine(op, b, chebyshev_rows(coeffs, c, h, b.dtype))
    elif (coeffs.ndim == 2 and fused is not False and not coeffs.is_complex()
          and resident_multi_ok(op, b.dtype, b.device, coeffs.shape[1],
                                (b, coeffs))):
        rows = chebyshev_rows(torch.zeros_like(coeffs[:, 0]), c, h, b.dtype)
        return recurrence_apply_resident_multi(op, b, rows, coeffs)
    elif fused:
        raise ValueError("fused=True: the CUDA engines take one real "
                         "coefficient column, or a real (m, p) stack on a "
                         "1-D stencil that passes resident_multi_ok")
    return _chebyshev_apply_scan(op, b, coeffs, c, 1.0 / h)


def _check_finite(U, what: str, comm=None):
    """No-silent-NaN guard of the Chebyshev drivers: a spectral interval
    that fails to enclose the spectrum makes the U_k recurrence diverge.
    The one host sync per driver call; with ``comm`` the check covers every
    rank's rows, so every rank raises."""
    if not bool(all_finite(U, comm)):
        raise FloatingPointError(
            f"{what} diverged (non-finite result): check that the "
            "spectral bounds enclose A's spectrum (pass bounds=(lo, hi) "
            "from a trusted source, or widen them), or use the Krylov "
            "path (expv)")
    return U


def _resolve_bounds(op, bounds):
    if bounds is not None:
        return float(bounds[0]), float(bounds[1])
    hint = getattr(op, "spectral_bounds_hint", None)
    if callable(hint):
        bh = hint()
        if bh is not None:
            return float(bh[0]), float(bh[1])
    return spectral_bounds(op)


def expv_chebyshev(t, A, b, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7, fused: bool | None = None):
    """exp(tA) b for Hermitian A by a Chebyshev expansion: one pass, no
    inner products (module doc). ``t`` may be complex (complex
    coefficients over the real recurrence, on the plain path).

    bounds: (lambda_min, lambda_max) enclosure of A's spectrum; None takes
      the operator's hint or a short-Lanczos estimate (``spectral_bounds``).
    m: fixed degree; None chooses it from the coefficient tail at ``tol``.
    fused: demand (True) or forbid (False) the CUDA kernels; None = auto.
    """
    op = aslinearoperator(A)
    if not op.is_hermitian:
        raise ValueError("expv_chebyshev requires a Hermitian operator "
                         "(use expv for general A)")
    b = action_vector(b, op)
    lo, hi = _resolve_bounds(op, bounds)
    if hi - lo <= 0:                           # A = cI exactly
        tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
        val = np.exp(tc * 0.5 * (hi + lo))
        return b * (complex(val) if np.iscomplexobj(val) else float(val))
    full, c, h = _full_exp_coeffs(t, lo, hi, tol, m)
    return _check_finite(
        chebyshev_apply(op, b, _coeffs_to(full, b), (lo, hi), fused=fused),
        "expv_chebyshev", operator_comm(op))


def _coeffs_to(C, b):
    """Host coefficients to b's device in b's dtype (complex when C is);
    pageable host memory: the copy is staged at once, no device sync."""
    cdt = b.dtype
    if np.iscomplexobj(C):
        cdt = torch.promote_types(b.dtype, torch.complex64)
    return torch.as_tensor(C).to(cdt).to(b.device, non_blocking=True)


def _hermitian_op(A, what: str):
    op = aslinearoperator(A)
    if not op.is_hermitian:
        raise ValueError(f"{what} requires a Hermitian operator")
    return op


def phiv_chebyshev(t, A, b, k: int, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7, samples: int = 1024,
                   fused: bool | None = None):
    """[phi_0(tA)b ... phi_k(tA)b] (n, k+1) for Hermitian A: every order is
    one more coefficient column of the same recurrence (one launch of B4
    on a 1-D stencil). ``fused`` as in ``chebyshev_apply``."""
    op = _hermitian_op(A, "phiv_chebyshev")
    b = action_vector(b, op)
    lo, hi = _resolve_bounds(op, bounds)
    tc = complex(t) if np.iscomplexobj(np.asarray(t)) else float(t)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        vals = _phi_scalar_np(np.asarray([tc * c]), k)[:, 0]
        return torch.stack([complex(v) * b if np.iscomplexobj(v)
                            else float(v) * b for v in vals], dim=-1)
    C = _fun_ucoeffs(lambda x: _phi_scalar_np(tc * (c + h * x), k),
                     tol, samples, m_fixed=m)          # (m, k+1)
    return _check_finite(
        chebyshev_apply(op, b, _coeffs_to(C, b), (lo, hi), fused=fused),
        "phiv_chebyshev", operator_comm(op))


def funm_chebyshev(f, A, b, *, bounds=None, m: int | None = None,
                   tol: float = 1e-7, samples: int = 1024,
                   fused: bool | None = None):
    """f(A) b for Hermitian A and any scalar function f (a numpy-vectorized
    callable, evaluated on the host at Chebyshev points of the spectral
    interval); the device work is the recurrence of ``expv_chebyshev``."""
    op = _hermitian_op(A, "funm_chebyshev")
    b = action_vector(b, op)
    lo, hi = _resolve_bounds(op, bounds)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)
    if h <= 0:
        val = np.asarray(f(np.asarray([c])))[..., 0]
        return torch.as_tensor(val).to(b.device) * b
    C = _fun_ucoeffs(lambda x: np.asarray(f(c + h * x)), tol, samples,
                     m_fixed=m)
    if C.ndim == 2 and C.shape[1] == 1:
        C = C[:, 0]
    return chebyshev_apply(op, b, _coeffs_to(C, b), (lo, hi), fused=fused)


@full_precision
def _chebyshev_combination_scan(op, Bt, C, center, inv_h):
    """W[s] = sum_k sum_j C[k, s, j] U_k(A~) Bt[j]: the stacked-column
    recurrence, one pass with p+1 matvecs per term and one small
    (nt, p+1) @ (p+1, n) product per step folding every snapshot. One
    degree step, C[k] read at the step counter (``ops/krylov._run``)."""
    cdt = C.dtype
    S = _State(Bt.device, Up=torch.zeros(Bt.shape, dtype=Bt.dtype,
                                         device=Bt.device),
               Uc=Bt.clone(memory_format=torch.contiguous_format),
               W=torch.zeros((C.shape[1], Bt.shape[1]), dtype=cdt,
                             device=Bt.device))

    def step():
        Ck = C.index_select(0, S.jj[:1])[0]
        S.apply("W", torch.add, S.W, Ck @ S.Uc.to(cdt))
        AU = torch.stack([op.matvec(u) for u in S.Uc])
        y = (2.0 * inv_h) * (AU - center * S.Uc) - S.Up
        S.set("Up", S.Uc)
        S.set("Uc", y)
        S.step_on()

    _run("chebyshev_combination", op, S, step, C.shape[0], Bt.device)
    return S.W


def phiv_timestep_chebyshev(ts, A, B, *, bounds=None, tol: float = 1e-7,
                            m: int | None = None, samples: int = 1024,
                            fused: bool | None = None):
    """u(t) = sum_j t^j phi_j(tA) b_j at the snapshot times ``ts`` for
    Hermitian A (the Niesen-Wright linear combination) in one Chebyshev
    pass: every snapshot is extra coefficient columns of the same
    recurrence, with a-priori (coefficient-tail) error control.

    ts: scalar or 1-D array of times. B: (n, p+1) columns b_0..b_p.
    Returns U (n, len(ts)), or (n,) for scalar ts. On a 1-D stencil that
    passes ``resident_multi_ok`` each input column b_j is one launch of B4
    (all snapshots share its chain); ``fused=False`` forbids that.
    """
    op = _hermitian_op(A, "phiv_timestep_chebyshev")
    B = action_vector(B, op)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, np.float64))
    nt = len(ts_arr)
    lo, hi = _resolve_bounds(op, bounds)
    c = 0.5 * (hi + lo)
    h = 0.5 * (hi - lo)

    if h <= 0:
        cols = []
        for t in ts_arr:
            vals = _phi_scalar_np(np.asarray([t * c]), p)[:, 0]
            cols.append(sum((t ** j) * float(vals[j]) * B[:, j]
                            for j in range(p + 1)))
        U = torch.stack(cols, dim=-1)
        return U[:, 0] if scalar_ts else U

    def f(x):
        # stacked (nt (p+1), M): rows (s, j) = t_s^j phi_j(t_s lambda(x))
        return np.concatenate([
            _phi_scalar_np(t * (c + h * x), p)
            * (t ** np.arange(p + 1))[:, None] for t in ts_arr], axis=0)

    C = _fun_ucoeffs(f, tol, samples, m_fixed=m)
    C = C.reshape(len(C), nt, p + 1)
    Cj = _coeffs_to(C, B)
    if (fused is not False and not np.iscomplexobj(C)
            and resident_multi_ok(op, B.dtype, B.device, nt, (B,))):
        from ..ops.kernels.resident import recurrence_apply_resident_multi

        rows = chebyshev_rows(torch.zeros_like(Cj[:, 0, 0]), c, h, B.dtype)
        U = None
        for j in range(p + 1):
            Uj = recurrence_apply_resident_multi(op, B[:, j], rows,
                                                 Cj[:, :, j])
            U = Uj if U is None else U + Uj
    else:
        U = _chebyshev_combination_scan(op, B.T, Cj, c, 1.0 / h).T
    U = _check_finite(U, "phiv_timestep_chebyshev",
                      operator_comm(op))                  # (n, nt)
    return U[:, 0] if scalar_ts else U
