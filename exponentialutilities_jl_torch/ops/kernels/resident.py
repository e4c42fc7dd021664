"""One-launch polynomial recurrences (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/resident.py``).

    omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
    w          += cw_k omega_k,      k = 0..m-1,  omega_0 = s x,  omega_{-1} = 0

with ``rows`` the (m, 4) per-step scalars (ca, cb, cc, cw) and the scale
``s`` as device data (s = 1 for B4-B6). The recurrence serves every
polynomial action (Chebyshev rows, the Lanczos replay rows of the
two-pass expv and phiv).

Five hand-written CUDA kernels carry it, each in one persistent
cooperative launch:

* B1 ``recurrence_apply_resident`` (``csrc/resident.cu``): A a 1-D
  constant stencil with Dirichlet ends; also returns sum w^2.
* B2 ``lanczos_coeffs_resident`` (``csrc/resident.cu``): Lanczos pass 1
  with alpha and beta reduced inside the kernel each step (deterministic
  fixed-order reductions), breakdown masking the remaining steps.
* B4 ``recurrence_apply_resident_multi`` (``csrc/resident_family.cu``):
  B1's operator with p accumulators over one shared omega chain,
  W[:, j] += cw[k, j] omega_k (all phi orders in one pass).
* B5 ``recurrence_apply_resident_banded``: A a ``BandedOperator``,
  z = sum_j D_j * shift(omega, o_j), zero outside the vector.
* B6 ``recurrence_apply_resident_grid``: A a 2-D/3-D constant stencil on
  the natural row-major grid with Dirichlet ends, for grids whose state
  fits the card's L2 (``L2_STATE_BUDGET``).

Each has a plain-torch twin (``resident_recurrence_ref``,
``resident_lanczos_ref``, ``resident_multi_ref``, ``resident_banded_ref``,
``resident_grid_ref``) computing the same contract. A wrapper runs the
twin only for CPU tensors; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sparse import BandedOperator
from ..stencil import StencilOperator, stencil_apply
from . import _build
from .spmv import banded_spmv_ref

__all__ = ["recurrence_apply_resident", "resident_recurrence",
           "resident_recurrence_ref", "lanczos_coeffs_resident",
           "resident_lanczos", "resident_lanczos_ref",
           "expv_two_pass_resident", "resident_supported",
           "recurrence_apply_resident_multi", "resident_multi_ref",
           "recurrence_apply_resident_banded", "resident_banded_ref",
           "resident_banded_supported", "recurrence_apply_resident_grid",
           "resident_grid_ref", "resident_grid_supported",
           "phiv_two_pass_resident", "L2_STATE_BUDGET"]

# B4 and B6 keep their whole state (3 recurrence vectors plus the
# accumulators) in the H100's 50 MB L2; 40 MB leaves room for the rows,
# coefficients and other traffic. Above it the one-launch kernels stream
# from HBM and B3's sweeps are the better 2-D/3-D engine: the B6-vs-B3
# times of chip_smoke.py (phase 5) are the measurement that should move
# this budget.
L2_STATE_BUDGET = 40 * 2 ** 20

def resident_supported(op) -> bool:
    """True when ``op`` is a 1-D real constant-coefficient StencilOperator
    the resident kernels take."""
    if not isinstance(op, StencilOperator) or len(op.grid_shape) != 1:
        return False
    if op.coeffs.is_complex():
        return False            # real kernels would drop imaginary parts
    n = op.grid_shape[0]
    return (0 < n and len(op.offsets) <= _build.MAX_POINTS
            and all(abs(off[0]) < n for off in op.offsets))


def resident_banded_supported(op) -> bool:
    """True for a real ``BandedOperator`` with at most MAX_POINTS
    diagonals, every offset inside the vector. No size cap: B5 streams its
    diagonals and state through HBM when they exceed L2."""
    if not isinstance(op, BandedOperator) or op.diags.is_complex():
        return False
    k, n = op.diags.shape
    return (0 < n and 0 < k <= _build.MAX_POINTS
            and all(abs(o) < n for o in op.offsets))


def resident_grid_supported(op, dtype=None) -> bool:
    """True for a real 2-D/3-D constant ``StencilOperator`` whose four
    state vectors (previous, current, next, w) in ``dtype`` (default: the
    operator's) fit ``L2_STATE_BUDGET``."""
    if not isinstance(op, StencilOperator) or len(op.grid_shape) not in (2, 3):
        return False
    if op.coeffs.is_complex() or not 0 < len(op.offsets) <= _build.MAX_POINTS:
        return False
    itemsize = torch.empty((), dtype=dtype or op.dtype).element_size()
    return 4 * op.shape[0] * itemsize <= L2_STATE_BUDGET


def _flat_offsets(op):
    return [off[0] for off in op.offsets]


def _stencil(x, offsets, cvals):
    return stencil_apply(x, [(o,) for o in offsets], cvals)


# --------------------------------------------------------------- twins --

def resident_recurrence_ref(x, rows, cvals, offsets, scale):
    """Plain twin of B1: (w, sum w^2) for the module-doc recurrence."""
    wc = scale * x
    wp = torch.zeros_like(x)
    w = torch.zeros_like(x)
    for k in range(rows.shape[0]):
        ca, cb, cc, cw = rows[k]
        w = w + cw * wc
        z = _stencil(wc, offsets, cvals)
        wp, wc = wc, ca * z + cb * wc + cc * wp
    return w, (w * w).sum()


def resident_lanczos_ref(v0, cvals, offsets, m: int, tol: float):
    """Plain twin of B2: the (m, 2) record of (alpha, beta) from the
    normalized start vector v0, zero after the first beta below tol."""
    vp = torch.zeros_like(v0)
    vc = v0
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alive = torch.ones((), dtype=torch.bool, device=v0.device)
    ab = torch.zeros((m, 2), dtype=v0.dtype, device=v0.device)
    for k in range(m):
        z = _stencil(vc, offsets, cvals)
        alpha = (vc * z).sum()
        y = (z - alpha * vc) - beta_prev * vp
        beta = torch.sqrt(torch.clamp_min((y * y).sum(), 0.0))
        ok = alive & (beta >= tol)
        ab[k, 0] = torch.where(alive, alpha, 0.0)
        ab[k, 1] = torch.where(ok, beta, 0.0)
        inv = torch.where(ok, 1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        vp, vc = vc, y * inv
        beta_prev = torch.where(ok, beta, 0.0)
        alive = ok
    return ab


def _chain_ref(x, rows, cw, apply):
    """(n, p) accumulators W[:, j] = sum_k cw[k, j] omega_k of the
    module-doc recurrence with omega_0 = x and A omega = apply(omega)."""
    wc = x
    wp = torch.zeros_like(x)
    W = torch.zeros(x.shape + cw.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(rows.shape[0]):
        W = W + wc[:, None] * cw[k][None, :]
        z = apply(wc)
        wp, wc = wc, rows[k, 0] * z + rows[k, 1] * wc + rows[k, 2] * wp
    return W


def resident_multi_ref(x, rows, cw, cvals, offsets):
    """Plain twin of B4: W (n, p) with W[:, j] = sum_k cw[k, j] omega_k for
    a 1-D constant stencil (rows' cw column unused)."""
    return _chain_ref(x, rows, cw, lambda v: _stencil(v, offsets, cvals))


def resident_banded_ref(x, rows, diags, offsets):
    """Plain twin of B5: w for A omega = sum_j D_j * shift(omega, o_j),
    zero outside the vector (B7's twin as the operator)."""
    return _chain_ref(x, rows, rows[:, 3:],
                      lambda v: banded_spmv_ref(diags, offsets, v))[:, 0]


def resident_grid_ref(x, rows, grid_shape, offsets, cvals):
    """Plain twin of B6: w for a constant stencil on the natural
    row-major ``grid_shape`` layout with Dirichlet ends."""
    def apply(v):
        return stencil_apply(v.reshape(grid_shape), offsets, cvals).reshape(-1)

    return _chain_ref(x, rows, rows[:, 3:], apply)[:, 0]


# ------------------------------------------------------------ wrappers --

def _check_launch(op, x):
    """Validate a CUDA launch of an (n,) vector against its operator."""
    if x.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"resident kernels take float32/float64, got {x.dtype}")
    if op.device != x.device:
        raise ValueError(f"operator on {op.device}, vector on {x.device}")
    n = op.shape[0]
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"expected an ({n},) vector, got {tuple(x.shape)}")


def _kernel_cvals(op, x):
    """Validate a CUDA launch; return the coefficients in x's dtype."""
    _check_launch(op, x)
    return op.coeffs.to(x.dtype).contiguous()


def _as_rows(rows, x):
    rows = torch.as_tensor(rows, dtype=x.dtype, device=x.device)
    if rows.ndim != 2 or rows.shape[1] != 4:
        raise ValueError(f"rows must be (m, 4), got {tuple(rows.shape)}")
    return rows


def _offsets_arg(offsets):
    return (ctypes.c_int * len(offsets))(*offsets)


@functools.cache
def _max_blocks(device_index: int, f64: bool) -> int:
    """Largest co-resident grid of the resident kernels on this card."""
    with torch.cuda.device(device_index):
        n = _build.library().eu_resident_max_blocks(int(f64))
    _build.check(-n if n < 0 else 0, "resident kernel occupancy query")
    return n


def _partials(x):
    n = 2 * _max_blocks(x.device.index or 0, x.dtype == torch.float64)
    return torch.empty(n, dtype=x.dtype, device=x.device), n


def _require_device(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel or twin for device {x.device}")


def resident_recurrence(op, x, rows, scale=1.0):
    """(w, sum w^2) of the module-doc recurrence for a 1-D constant
    ``StencilOperator``: kernel B1 on CUDA, its twin on CPU. ``rows`` is
    (m, 4) and ``scale`` a number or a one-element tensor, both on x's
    device."""
    if not resident_supported(op):
        raise ValueError("resident_recurrence requires a 1-D real constant "
                         f"StencilOperator (got {type(op).__name__})")
    _require_device(x, "resident_recurrence")
    rows = _as_rows(rows, x)
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=x.device, dtype=x.dtype).reshape(1)
    else:
        s = torch.full((1,), float(scale), dtype=x.dtype, device=x.device)
    offsets = _flat_offsets(op)
    if x.device.type == "cpu":
        return resident_recurrence_ref(x, rows, op.coeffs.to(x.dtype),
                                       offsets, s[0])
    cvals = _kernel_cvals(op, x)
    x = x.contiguous()
    rows = rows.contiguous()
    n = x.shape[0]
    w = torch.empty_like(x)
    buf = torch.empty(3 * n, dtype=x.dtype, device=x.device)
    partials, cap = _partials(x)
    nrm2 = torch.empty(1, dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = getattr(lib, f"eu_resident_recurrence_{_build.suffix(x.dtype)}")
    code = fn(_build.ptr(x), _build.ptr(rows), _build.ptr(cvals),
              _build.ptr(s), _offsets_arg(offsets), len(offsets), n,
              rows.shape[0], _build.ptr(w), _build.ptr(buf),
              _build.ptr(partials), cap, _build.ptr(nrm2),
              _build.raw_stream(x.device))
    _build.check(code, "resident recurrence kernel (B1)")
    _build.launches["resident_recurrence"] += 1
    return w, nrm2[0]


def recurrence_apply_resident(op, b, rows, *, scale=1.0):
    """w = sum_k cw_k omega_k (module doc) for a 1-D constant
    ``StencilOperator``: one launch of kernel B1 on CUDA. Returns (n,)."""
    return resident_recurrence(op, b, rows, scale)[0]


def recurrence_apply_resident_multi(op, b, rows, cw):
    """W[:, j] = sum_k cw[k, j] omega_k over the shared omega chain of the
    module-doc recurrence (omega_0 = b; rows' cw column is unused) for a
    1-D constant ``StencilOperator``: one launch of kernel B4 on CUDA
    whatever p, its twin on CPU. Returns (n, p)."""
    if not resident_supported(op):
        raise ValueError("recurrence_apply_resident_multi requires a 1-D real "
                         f"constant StencilOperator (got {type(op).__name__})")
    _require_device(b, "recurrence_apply_resident_multi")
    rows = _as_rows(rows, b)
    cw = torch.as_tensor(cw, dtype=b.dtype, device=b.device)
    if cw.ndim != 2 or cw.shape[0] != rows.shape[0] or cw.shape[1] < 1:
        raise ValueError(f"cw must be (m, p >= 1) with m = {rows.shape[0]}, "
                         f"got {tuple(cw.shape)}")
    offsets = _flat_offsets(op)
    if b.device.type == "cpu":
        return resident_multi_ref(b, rows, cw, op.coeffs.to(b.dtype), offsets)
    cvals = _kernel_cvals(op, b)
    b, rows, cw = b.contiguous(), rows.contiguous(), cw.contiguous()
    n, p = b.shape[0], cw.shape[1]
    W = torch.empty((p, n), dtype=b.dtype, device=b.device)
    buf = torch.empty(3 * n, dtype=b.dtype, device=b.device)
    fn = getattr(_build.library(), f"eu_resident_multi_{_build.suffix(b.dtype)}")
    code = fn(_build.ptr(b), _build.ptr(rows), _build.ptr(cw), p,
              _build.ptr(cvals), _offsets_arg(offsets), len(offsets), n,
              rows.shape[0], _build.ptr(W), _build.ptr(buf),
              _build.raw_stream(b.device))
    _build.check(code, "resident multi-column kernel (B4)")
    _build.launches["resident_multi"] += 1
    return W.T


def recurrence_apply_resident_banded(op, b, rows):
    """w = sum_k cw_k omega_k (module doc, omega_0 = b) for a
    ``BandedOperator``: one launch of kernel B5 on CUDA, its twin on CPU.
    Returns (n,)."""
    if not resident_banded_supported(op):
        raise ValueError("recurrence_apply_resident_banded requires a real "
                         f"BandedOperator with <= {_build.MAX_POINTS} "
                         f"diagonals (got {type(op).__name__})")
    _require_device(b, "recurrence_apply_resident_banded")
    rows = _as_rows(rows, b)
    if b.device.type == "cpu":
        return resident_banded_ref(b, rows, op.diags.to(b.dtype), op.offsets)
    _check_launch(op, b)
    b, rows = b.contiguous(), rows.contiguous()
    diags = op.diags.to(b.dtype).contiguous()
    n = b.shape[0]
    w = torch.empty_like(b)
    buf = torch.empty(3 * n, dtype=b.dtype, device=b.device)
    fn = getattr(_build.library(), f"eu_resident_banded_{_build.suffix(b.dtype)}")
    code = fn(_build.ptr(b), _build.ptr(rows), _build.ptr(diags),
              _offsets_arg(op.offsets), len(op.offsets), n, rows.shape[0],
              _build.ptr(w), _build.ptr(buf), _build.raw_stream(b.device))
    _build.check(code, "resident banded kernel (B5)")
    _build.launches["resident_banded"] += 1
    return w


def recurrence_apply_resident_grid(op, b, rows):
    """w = sum_k cw_k omega_k (module doc, omega_0 = b) for a 2-D/3-D
    constant ``StencilOperator`` on its natural row-major layout: one
    launch of kernel B6 on CUDA, its twin on CPU. Returns (n,)."""
    if not resident_grid_supported(op, b.dtype):
        raise ValueError("recurrence_apply_resident_grid requires a real "
                         "2-D/3-D constant StencilOperator whose state fits "
                         f"{L2_STATE_BUDGET >> 20} MB (got {type(op).__name__}"
                         f" {getattr(op, 'grid_shape', '')})")
    _require_device(b, "recurrence_apply_resident_grid")
    rows = _as_rows(rows, b)
    if b.device.type == "cpu":
        return resident_grid_ref(b, rows, op.grid_shape, op.offsets,
                                 op.coeffs.to(b.dtype))
    from .lanczos_fused import _geometry

    cvals = _kernel_cvals(op, b)
    b, rows = b.contiguous(), rows.contiguous()
    (nz, ny, nx), offs3 = _geometry(op)
    flat = [o for off in offs3 for o in off]
    w = torch.empty_like(b)
    buf = torch.empty(3 * b.shape[0], dtype=b.dtype, device=b.device)
    fn = getattr(_build.library(), f"eu_resident_grid_{_build.suffix(b.dtype)}")
    code = fn(_build.ptr(b), _build.ptr(rows), _build.ptr(cvals),
              _offsets_arg(flat), len(offs3), nz, ny, nx, rows.shape[0],
              _build.ptr(w), _build.ptr(buf), _build.raw_stream(b.device))
    _build.check(code, "resident grid kernel (B6)")
    _build.launches["resident_grid"] += 1
    return w


def resident_lanczos(op, v0, m: int, tol: float):
    """The (m, 2) (alpha, beta) record of Lanczos pass 1 from the
    normalized v0: kernel B2 on CUDA, its twin on CPU."""
    if not resident_supported(op):
        raise ValueError("resident_lanczos requires a 1-D real constant "
                         f"StencilOperator (got {type(op).__name__})")
    _require_device(v0, "resident_lanczos")
    offsets = _flat_offsets(op)
    if v0.device.type == "cpu":
        return resident_lanczos_ref(v0, op.coeffs.to(v0.dtype), offsets,
                                    int(m), float(tol))
    cvals = _kernel_cvals(op, v0)
    v0 = v0.contiguous()
    n = v0.shape[0]
    ab = torch.zeros((int(m), 2), dtype=v0.dtype, device=v0.device)
    buf = torch.empty(3 * n, dtype=v0.dtype, device=v0.device)
    partials, cap = _partials(v0)
    lib = _build.library()
    fn = getattr(lib, f"eu_resident_lanczos_{_build.suffix(v0.dtype)}")
    code = fn(_build.ptr(v0), _build.ptr(cvals), _offsets_arg(offsets),
              len(offsets), n, int(m), float(tol), _build.ptr(ab),
              _build.ptr(buf), _build.ptr(partials), cap,
              _build.raw_stream(v0.device))
    _build.check(code, "resident Lanczos kernel (B2)")
    _build.launches["resident_lanczos"] += 1
    return ab


def lanczos_coeffs_resident(op, b, m: int, *, tol: float = 1e-7):
    """(alphas, betas, beta0, m_used, broke): drop-in twin of
    ``ops.krylov.lanczos_coeffs`` for 1-D constant stencils, the whole
    pass in one launch of kernel B2 on CUDA."""
    beta0 = torch.linalg.vector_norm(b)
    v0 = torch.where(beta0 > 0, b / torch.where(beta0 > 0, beta0, 1.0), 0.0)
    ab = resident_lanczos(op, v0, m, tol)
    alphas, betas = ab[:, 0], ab[:, 1]
    # alpha_k is recorded through the first sub-tol beta (inclusive):
    # m_used = index of the first zero beta + 1, or m when none broke
    zero = betas == 0
    any0 = zero.any()
    first0 = torch.argmax(zero.to(torch.int32)).to(torch.int32)
    m_used = torch.where(any0, first0 + 1, m)
    m_used = torch.where(beta0 > 0, m_used, 0).to(torch.int32)
    broke = any0 | (beta0 == 0)
    return alphas, betas, beta0, m_used, broke


def _replay_rows(alphas, betas, cw):
    """(m, 4) rows regenerating the Lanczos basis from its record,
    v_{k+1} = (A v_k - alpha_k v_k - beta_{k-1} v_{k-1}) / beta_k, with
    accumulation weights ``cw`` (cc_0 multiplies omega_{-1} = 0)."""
    live = betas > 0
    safe = torch.where(live, betas, 1.0)
    bprev = torch.cat([torch.zeros_like(betas[:1]), betas[:-1]])
    ca = torch.where(live, 1.0 / safe, 0.0)
    cb = -alphas * ca
    cc = torch.where(live, -bprev / safe, 0.0)
    return torch.stack([ca, cb, cc, cw], dim=1)


def _inv_or_zero(beta0):
    return torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0),
                       0.0)


def expv_two_pass_resident(op, b, t, m: int, *, tol: float = 1e-7):
    """Storage-free 1-D Hermitian expv with both passes one launch each:
    pass 1 = ``lanczos_coeffs_resident`` (B2), the m x m reduced
    tridiagonal exponential (``torch.linalg.eigh``), pass 2 = the B1
    recurrence with the replay rows of the record."""
    from ...models.expv import _lanczos_reduced_coeffs

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_resident(
        op, b, m, tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t)
    rows = _replay_rows(alphas, betas, coeffs.to(b.dtype))
    w = recurrence_apply_resident(op, b, rows, scale=_inv_or_zero(beta0))
    return torch.where(beta0 > 0, w, 0.0)


def phiv_two_pass_resident(op, b, t, m: int, k: int, *, tol: float = 1e-7):
    """Storage-free 1-D Hermitian phi-actions (w (n, k+1), err): pass 1 =
    ``lanczos_coeffs_resident`` (B2), the reduced augmented exponential
    (``phiv_dense``), pass 2 = ONE launch of B4 accumulating every phi
    order from the shared regenerated basis chain. ``err`` is the
    a-posteriori estimate |beta0 h t C2[last, k]| of ``models.phiv``."""
    from ...models.phiv import _two_pass_reduced

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_resident(
        op, b, m, tol=tol)
    C2, err = _two_pass_reduced(alphas, betas, beta0, m_used, t, k, b.dtype)
    rows = _replay_rows(alphas, betas, torch.zeros_like(alphas))
    w = recurrence_apply_resident_multi(op, _inv_or_zero(beta0) * b, rows,
                                        C2 * beta0)
    live = beta0 > 0
    return torch.where(live, w, 0.0), torch.where(live, err, 0.0)
