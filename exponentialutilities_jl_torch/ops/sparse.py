"""Sparse operator containers (PyTorch port of
``exponentialutilities_jl_tpu/ops/sparse.py``).

Structured storage:

* ``BandedOperator``: diagonal storage, A[i, i+o] = diags[k][i]; matvec
  kernel B7 (``ops/kernels/spmv.banded_spmv``).
* ``SparseELLOperator``: padded ELLPACK, every row ``w`` (column, value)
  slots; its matvec is a plain torch gather and reduce (the JAX package
  has no kernel for it).
* ``BlockELLOperator``: blocked ELL with dense (br x bc) blocks; matvec
  kernel B8 (``ops/kernels/spmv.blockell_spmv``).

Unstructured storage (``ops/kernels/sell.py``, SELL-C-sigma):

* ``SellOperator``: built from COO or scipy, optionally RCM-permuted
  (``perm``), in the default, bucketed or segmented pack; matvec kernel B9,
  plus B10 for the segmented pack.
* ``SortedSellOperator`` (``mode="sorted"``): the conjugation
  A = P^T A_s P by a window-local stable degree sort. ``order`` is a plain
  int64 tensor and ``permute``/``unpermute`` are index gathers (the JAX
  package packed them as degree-1 SELL matrices only because an element
  gather is slow on the TPU). ``hoist_conjugation`` lets ``expv``, ``phiv``
  and ``chebyshev_apply`` run a whole solve in the sorted basis.
* ``HybridOperator``: dense diagonals on B7 plus a SELL residual on B9.

Every matvec on a CUDA tensor whose (promoted) dtype is float32 or float64
launches its kernel or raises (an operator stored in another dtype than
that casts its storage once, on first use, and keeps the copy); any other
dtype (complex) takes the plain
torch path through the dtype gate ``dispatch.kernel_device_ok``, and CPU
tensors take the plain twins. A kernel matvec that autograd must see (grad
mode on and x or the storage requires grad, or either wrapped by a
``torch.func`` transform) goes through ``_KernelMatvec``:

* forward mode: the same kernel on the tangent, so ``torch.func.jvp`` and
  ``JacobianOperator`` work over the kernel matvecs (B7 adds the plain
  twin's product of a diagonals tangent);
* reverse mode, B7 (``BandedOperator``): the x-gradient A^H g is one B7
  launch on the adjoint storage (offsets -o_k, diagonal k shifted by o_k,
  built once per operator and dtype and kept like the plans), and the
  diagonals' gradient dD[k, i] = g_i x_{i+o_k} is plain torch;
* reverse mode, B8, B9 (and B10 under a segmented pack): the x-gradient of
  a Hermitian container (A^H = A) is the same kernel on g. A non-Hermitian
  container's x-gradient raises NotImplementedError in the backward pass,
  and storage that requires grad raises NotImplementedError at the
  product, naming the container (the JAX package's Pallas SpMVs have no
  VJP either). ``SortedSellOperator`` and ``HybridOperator`` compose their
  parts' rules.

The host packers are the JAX package's own (``utils/native.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import action_vector, host_tensor
from ..utils.linop import LinearOperator
from .kernels.dispatch import kernel_device_ok
from .kernels.sell import (SellSeg, launch_plan, sell_spmv_ref,
                           sell_spmv_seg_ref)
from .kernels.spmv import (BandedPlan, banded_spmv_ref, blockell_spmv,
                           blockell_spmv_ref)

__all__ = ["SparseELLOperator", "BlockELLOperator", "BandedOperator",
           "SellOperator", "SortedSellOperator", "ell_from_scipy",
           "blockell_from_scipy", "banded_from_scipy", "HybridOperator",
           "hybrid_from_scipy", "hoist_conjugation"]


def _kernel(op_dtype, x):
    """(use the kernel, compute dtype) for a matvec of x."""
    rt = torch.promote_types(op_dtype, x.dtype)
    return kernel_device_ok(rt, x.device), rt


class _KernelMatvec(torch.autograd.Function):
    """y = A x through a container's kernel, seen by autograd (module doc).
    ``op`` is the container, ``storage`` the tensor whose gradient it
    defines (B7's diagonals) or None. The forward calls
    ``op._kernel_matvec(x, storage)``, which lands here again while x or the
    storage is still wrapped by an outer ``torch.func`` transform, and
    launches the kernel on plain tensors. The rules are the container's
    ``_kernel_vjp`` and ``_storage_jvp``."""

    @staticmethod
    def forward(x, op, storage):
        return op._kernel_matvec(x, storage)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, op, storage = inputs
        ctx.op, ctx.storage = op, storage
        ctx.save_for_backward(x, storage)
        ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, g):
        x, storage = ctx.saved_tensors
        gx, gs = ctx.op._kernel_vjp(x, storage, g, ctx.needs_input_grad[0],
                                    ctx.needs_input_grad[2])
        return gx, None, gs

    @staticmethod
    def jvp(ctx, x_t, _, s_t):
        out = None
        if x_t is not None:
            out = ctx.op._kernel_matvec(x_t, ctx.storage)
        if s_t is not None:
            (x,) = ctx.saved_tensors
            ds = ctx.op._storage_jvp(x, s_t)
            out = ds if out is None else out + ds
        return out


def _traced(x) -> bool:
    """x is wrapped by a ``torch.func`` transform (a primal or tangent
    under ``jvp``, a tracked tensor under ``grad``), whose state a kernel's
    raw pointer would drop."""
    return torch._C._functorch.is_functorch_wrapped_tensor(x)


def _graph_wanted(*tensors) -> bool:
    """Autograd must see a product of these tensors (None entries
    skipped): one is wrapped by a ``torch.func`` transform, or grad mode is
    on and one requires grad."""
    ts = [t for t in tensors if t is not None]
    return (any(_traced(t) for t in ts)
            or (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def _refuse_storage_grad(op, storage, kernel: str):
    """B8/B9 define no gradient of their storage: refuse a product that
    would silently drop it."""
    if _graph_wanted(storage):
        raise NotImplementedError(
            f"{type(op).__name__}: the gradient of its storage through the "
            f"kernel matvec ({kernel}) is not defined; only the x-gradient "
            "of a Hermitian container is (the JAX package's Pallas SpMVs "
            "have no VJP either)")


def _hermitian_vjp(op, g, kernel: str):
    """A^H g = A g on the container's kernel (the x-gradient of B8, B9)."""
    if not op.is_hermitian:
        raise NotImplementedError(
            f"{type(op).__name__}: reverse mode through the kernel matvec "
            f"({kernel}) needs A^H, which the kernel computes only for a "
            "Hermitian container (is_hermitian=True)")
    return op._kernel_matvec(g, None)


def _values(t):
    """The tensor whose values a cast of ``t`` copies: ``t`` itself, or a
    SELL pack's slot values (the segmented pack's base's)."""
    if isinstance(t, torch.Tensor):
        return t
    return (t.base if hasattr(t, "base") else t).vals


def _promoted(op, attr, dt):
    """``op.<attr>`` (a tensor or a SELL pack) in dtype ``dt``: the
    operator's own storage when the dtypes agree, else a copy made on first
    use and kept, so a float32 operator driven by float64 vectors does not
    copy its storage on every matvec. The copy lies on the storage's
    device; a reassigned ``op.<attr>`` (another device included), a
    reassigned pack's values and storage changed in place (its
    ``_version``, as ``BandedOperator.adjoint`` checks) are cast anew."""
    t = getattr(op, attr)
    if t.dtype == dt:
        return t
    casts = op.__dict__.setdefault("_casts", {})       # (source, copy)
    stamps = op.__dict__.setdefault("_cast_stamps", {})
    hit = casts.get((attr, dt))
    v = _values(t)
    stamp = (v, None if v.is_inference() else v._version)  # no counter there
    old = stamps.get((attr, dt))
    if (hit is None or hit[0] is not t or old[0] is not v
            or old[1] != stamp[1]):
        hit = casts[(attr, dt)] = (t, t.to(dtype=dt))
        stamps[(attr, dt)] = stamp
    return hit[1]


class SparseELLOperator(LinearOperator):
    """Padded-ELLPACK operator.

    data: (n, w) values, zero in padded slots.
    cols: (n, w) int32 column indices, 0 in padded slots (value 0).
    """

    def __init__(self, data, cols, is_hermitian: bool = False):
        self.data = host_tensor(data)
        self.cols = host_tensor(cols, device=self.data.device, dtype=torch.int32)
        self.is_hermitian = bool(is_hermitian)

    @property
    def shape(self):
        n = self.data.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    def matvec(self, x):
        return (self.data * x[self.cols]).sum(dim=1)

    def opnorm_hint(self):
        return self.data.abs().sum(dim=1).max()

    def to_dense(self):
        n, w = self.data.shape
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)[:, None].expand(n, w)
        return A.index_put_((rows, self.cols.long()), self.data,
                            accumulate=True)

    @classmethod
    def from_dense(cls, A, is_hermitian: bool = False, device=None):
        A = np.asarray(A)
        n = A.shape[0]
        nz = [np.nonzero(A[i])[0] for i in range(n)]
        w = max(1, max((len(z) for z in nz), default=0))
        data = np.zeros((n, w), dtype=A.dtype)
        cols = np.zeros((n, w), dtype=np.int32)
        for i, z in enumerate(nz):
            data[i, :len(z)] = A[i, z]
            cols[i, :len(z)] = z
        return cls(host_tensor(data, device), host_tensor(cols, device),
                   is_hermitian=is_hermitian)


def ell_from_scipy(A, is_hermitian: bool = False, dtype=None,
                   device=None) -> SparseELLOperator:
    """A ``scipy.sparse`` matrix in padded ELL (the native packer)."""
    from ..utils.native import csr_to_ell_arrays

    vals, cols = csr_to_ell_arrays(A, dtype=dtype)
    return SparseELLOperator(host_tensor(vals, device), host_tensor(cols, device),
                             is_hermitian=is_hermitian)


class BlockELLOperator(LinearOperator):
    """Blocked-ELLPACK (BSR-style) operator with dense (br x bc) blocks.

    blocks: (nbr, w, br, bc) values; zero blocks in padded slots.
    bcols:  (nbr, w) int32 block-column indices in [0, n / bc); 0 in
            padded slots. Checked once here, since B8 gathers x by them
            unchecked.

    ``use_pallas`` keeps the JAX signature and has no effect: on a CUDA
    device the matvec always runs the hand-written kernel B8
    (``ops/kernels/spmv.blockell_spmv``), on CPU its plain twin.
    """

    def __init__(self, blocks, bcols, is_hermitian: bool = False,
                 use_pallas: bool = True):
        self.blocks = host_tensor(blocks)
        self.bcols = host_tensor(bcols, device=self.blocks.device,
                             dtype=torch.int32)
        self.is_hermitian = bool(is_hermitian)
        self.use_pallas = bool(use_pallas)
        nbr, w, br, bc = self.blocks.shape
        if self.bcols.shape != (nbr, w) or (nbr * br) % bc:
            raise ValueError(f"blocks {tuple(self.blocks.shape)} and bcols "
                             f"{tuple(self.bcols.shape)} do not form a "
                             "square block-ELL matrix")
        if self.bcols.numel():
            lo, hi = torch.stack(torch.aminmax(self.bcols)).tolist()
            if lo < 0 or hi >= nbr * br // bc:
                raise ValueError(f"bcols in [{lo}, {hi}], outside "
                                 f"[0, {nbr * br // bc})")

    @property
    def block_shape(self):
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def shape(self):
        n = self.blocks.shape[0] * self.blocks.shape[2]
        return (n, n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def nnz(self) -> int:
        return int(self.blocks.numel())

    def matvec(self, x):
        kern, rt = _kernel(self.dtype, x)
        if not kern:
            return blockell_spmv_ref(self.blocks, self.bcols, x)
        _refuse_storage_grad(self, self.blocks, "B8")
        return self._kernel_matvec(x, None)

    def _kernel_matvec(self, x, _):
        if _graph_wanted(x):
            return _KernelMatvec.apply(x, self, None)
        rt = torch.promote_types(self.dtype, x.dtype)
        return blockell_spmv(_promoted(self, "blocks", rt), self.bcols,
                             x.to(rt))

    def _kernel_vjp(self, x, _, g, need_x, need_storage):
        return _hermitian_vjp(self, g, "B8").to(x.dtype), None

    def opnorm_hint(self):
        return self.blocks.abs().sum(dim=(1, 3)).max()      # (nbr, br) sums

    def to_dense(self):
        nbr, w, br, bc = self.blocks.shape
        n = nbr * br
        dev = self.device
        r = (torch.arange(nbr, device=dev)[:, None, None, None] * br
             + torch.arange(br, device=dev)[None, None, :, None])
        c = (self.bcols.long()[:, :, None, None] * bc
             + torch.arange(bc, device=dev)[None, None, None, :])
        r, c = torch.broadcast_tensors(r, c)
        A = torch.zeros((n, n), dtype=self.dtype, device=dev)
        return A.index_put_((r, c), self.blocks, accumulate=True)

    @classmethod
    def from_dense(cls, A, br: int, bc: Optional[int] = None,
                   is_hermitian: bool = False, device=None):
        A = np.asarray(A)
        bc = bc if bc is not None else br
        n = A.shape[0]
        if n % br or n % bc:
            raise ValueError(f"n={n} not divisible by block shape ({br},{bc})")
        nbr, nbc = n // br, n // bc
        blk = A.reshape(nbr, br, nbc, bc).transpose(0, 2, 1, 3)
        nzmask = np.abs(blk).sum(axis=(2, 3)) != 0       # (nbr, nbc)
        w = max(1, int(nzmask.sum(axis=1).max()))
        blocks = np.zeros((nbr, w, br, bc), dtype=A.dtype)
        bcols = np.zeros((nbr, w), dtype=np.int32)
        for i in range(nbr):
            z = np.nonzero(nzmask[i])[0]
            blocks[i, :len(z)] = blk[i, z]
            bcols[i, :len(z)] = z
        return cls(host_tensor(blocks, device), host_tensor(bcols, device),
                   is_hermitian=is_hermitian)


def blockell_from_scipy(A, br: int, bc: Optional[int] = None,
                        is_hermitian: bool = False, dtype=None,
                        device=None) -> BlockELLOperator:
    """A ``scipy.sparse`` matrix in blocked ELL with (br x bc) blocks (the
    native packer)."""
    from ..utils.native import bsr_to_blockell_arrays

    blocks, bcols = bsr_to_blockell_arrays(A, br, bc, dtype=dtype)
    return BlockELLOperator(host_tensor(blocks, device), host_tensor(bcols, device),
                            is_hermitian=is_hermitian)


def banded_from_scipy(A, offsets=None, is_hermitian: bool = False,
                      dtype=None, device=None) -> "BandedOperator":
    """A ``scipy.sparse`` matrix with banded structure in diagonal storage.
    Raises if the matrix has entries outside ``offsets`` (or more than 64
    distinct diagonals when the offsets are detected)."""
    from ..utils.native import csr_band_offsets, csr_to_banded_arrays

    A = A.tocsr()
    if offsets is None:
        offsets = csr_band_offsets(A)
        if offsets is None:
            raise ValueError(
                "matrix has >64 distinct diagonals; pass offsets explicitly "
                "or use ell_from_scipy")
    diags, dropped = csr_to_banded_arrays(A, offsets, dtype=dtype)
    if dropped:
        raise ValueError(
            f"{dropped} entries fall outside the given offsets {offsets}")
    return BandedOperator(host_tensor(diags, device), [int(o) for o in offsets],
                          is_hermitian=is_hermitian)


class BandedOperator(LinearOperator):
    """A[i, i+o] = diags[k][i] for each offset o = offsets[k].

    diags: (len(offsets), n); diags[k, i] is zero where i+offsets[k] falls
    outside [0, n). The matvec is kernel B7 on CUDA (at most
    ``_build.MAX_POINTS`` diagonals there) and shifted slices of a
    zero-padded x on CPU.
    """

    def __init__(self, diags, offsets, is_hermitian: bool = False):
        self.diags = host_tensor(diags)
        self.offsets = tuple(int(o) for o in offsets)
        self.is_hermitian = bool(is_hermitian)
        if self.diags.shape[0] != len(self.offsets):
            raise ValueError("diags rows must match number of offsets")

    @property
    def shape(self):
        n = self.diags.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def nnz(self) -> int:
        return int(self.diags.numel())

    def matvec(self, x):
        kern, rt = _kernel(self.dtype, x)
        if not kern:
            return banded_spmv_ref(self.diags, self.offsets, x)
        return self._kernel_matvec(x, self.diags)

    def matmat(self, X):
        """A applied to each row of X (batch, n): one launch of K1 (B7's
        batched form) on CUDA, the twin on CPU; autograd as ``matvec``."""
        kern, rt = _kernel(self.dtype, X)
        if not kern:
            return banded_spmv_ref(self.diags, self.offsets, X)
        return self._kernel_matvec(X, self.diags)

    def _kernel_matvec(self, x, D):
        """A(D) x on B7, or on K1 for a (batch, n) x; through
        ``_KernelMatvec`` when autograd must see it. D is the operator's
        diagonals (their plan) or, under a ``torch.func`` transform, their
        unwrapped value (a plan of its own)."""
        if _graph_wanted(x, D):
            return _KernelMatvec.apply(x, self, D)
        rt = torch.promote_types(D.dtype, x.dtype)
        if D is self.diags:
            plan = self.plan(rt, x.device)
        else:
            plan = BandedPlan(D.to(rt), self.offsets, rt, x.device)
        return (plan if x.dim() == 1 else plan.spmm)(x.to(rt))

    def _kernel_vjp(self, x, D, g, need_x, need_D):
        """(A^H g, dD): A^H g by one B7 (K1 for a block) launch on the
        adjoint storage; dD[k, i] = sum over rows of g_i x_{i+o_k} (zero
        where i + o_k leaves [0, n)) in plain torch."""
        gx = gD = None
        if need_x:
            adj = self.adjoint(D)
            gx = (adj.matvec(g) if g.dim() == 1
                  else adj.matmat(g)).to(x.dtype)
        if need_D:
            n = x.shape[-1]
            h = max((abs(o) for o in self.offsets), default=0)
            rt = torch.promote_types(D.dtype, x.dtype)
            xe = F.pad(x.to(rt).conj(), (h, h))
            terms = [g.to(rt) * xe[..., h + o:h + o + n]
                     for o in self.offsets]
            if x.dim() == 2:
                terms = [t.sum(0) for t in terms]
            gD = torch.stack(terms).to(D.dtype)
        return gx, gD

    def _storage_jvp(self, x, D_t):
        return banded_spmv_ref(D_t, self.offsets, x)

    def adjoint(self, D=None):
        """A^H as a ``BandedOperator``: (A^H)[j, j - o] = conj(A[j - o, j]),
        so offsets -o_k and diagonal k shifted by o_k, zero where it
        leaves the vector. Built from the diagonals ``D`` (the operator's
        own by default); kept per dtype and device with the diagonals, their
        version and the offsets it was built from, except while autograd
        must see D (then it is built anew, on D's graph)."""
        D = self.diags if D is None else D
        if _graph_wanted(D):
            return self._build_adjoint(D)
        cache = self.__dict__.setdefault("_adjoints", {})
        key = (D.dtype, D.device)
        hit = cache.get(key)
        if (hit is None or hit[0] is not D or hit[1] != D._version
                or hit[2] != self.offsets):
            hit = cache[key] = (D, D._version, self.offsets,
                                self._build_adjoint(D.detach()))
        return hit[3]

    def _build_adjoint(self, D):
        n = D.shape[1]
        rows = []
        for k, o in enumerate(self.offsets):
            d = D[k].conj()
            rows.append(F.pad(d[:max(n - o, 0)], (min(o, n), 0)) if o >= 0
                        else F.pad(d[min(-o, n):], (0, min(-o, n))))
        Dh = torch.stack(rows) if rows else D.clone()
        return BandedOperator(Dh, [-o for o in self.offsets],
                              is_hermitian=self.is_hermitian)

    def plan(self, dtype, device):
        """B7's ``BandedPlan`` for vectors of the compute dtype ``dtype`` on
        the CUDA device ``device``: kept per (dtype, device) with the
        diagonals (their ``_promoted`` form) and offsets it was built from,
        and rebuilt when either is reassigned or the cast copy is made anew
        (diagonals of another dtype changed in place)."""
        device = torch.device(device)
        plans = self.__dict__.setdefault("_plans", {})
        hit = plans.get((dtype, device))
        src = _promoted(self, "diags", dtype)
        if hit is None or hit[0] is not src or hit[1] != self.offsets:
            hit = plans[(dtype, device)] = (
                src, self.offsets,
                BandedPlan(src, self.offsets, dtype, device))
        return hit[2]

    def opnorm_hint(self):
        return self.diags.abs().sum(dim=0).max()

    def _gershgorin_real(self):
        """Per-row Gershgorin enclosure of the spectrum's real parts,
        computed where the diagonals live; returns host floats (one sync,
        two numbers copied)."""
        D = self.diags.detach()
        n = self.shape[0]
        i = torch.arange(n, device=D.device)
        d = torch.zeros(n, dtype=D.dtype, device=D.device)
        r = torch.zeros(n, dtype=torch.float64, device=D.device)
        for k, o in enumerate(self.offsets):
            row = torch.where((i + o >= 0) & (i + o < n), D[k], 0)
            if o == 0:
                d = d + row
            else:
                r = r + row.abs()
        lo, hi = torch.stack([(d.real - r).min(), (d.real + r).max()]).tolist()
        return lo, hi

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure for the Chebyshev actions;
        Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_dense(self):
        n = self.shape[0]
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for k, o in enumerate(self.offsets):
            lo = max(0, -o)
            i = torch.arange(lo, max(lo, min(n, n - o)), device=self.device)
            A[i, i + o] = self.diags[k, i]
        return A

    def to_ell(self) -> SparseELLOperator:
        n = self.shape[0]
        i = torch.arange(n, device=self.device)
        cols, data = [], []
        for k, o in enumerate(self.offsets):
            valid = (i + o >= 0) & (i + o < n)
            cols.append(torch.where(valid, i + o, 0))
            data.append(torch.where(valid, self.diags[k], 0))
        return SparseELLOperator(torch.stack(data, dim=1),
                                 torch.stack(cols, dim=1),
                                 is_hermitian=self.is_hermitian)

    @classmethod
    def from_dense(cls, A, offsets=None, is_hermitian: bool = False,
                   device=None):
        A = np.asarray(A)
        n = A.shape[0]
        if offsets is None:
            offsets = sorted({int(j - i) for i, j in zip(*np.nonzero(A))})
            if not offsets:
                offsets = [0]
        diags = np.zeros((len(offsets), n), dtype=A.dtype)
        for k, o in enumerate(offsets):
            i = np.arange(max(0, -o), min(n, n - o))
            diags[k, i] = A[i, i + o]
        return cls(host_tensor(diags, device), offsets, is_hermitian=is_hermitian)


def _rcm(rows, cols, vals, n):
    """(perm, rows, cols): the RCM permutation (perm[new] = old) and the
    COO indices relabelled by it."""
    import scipy.sparse as sp
    from ..utils.native import rcm_ordering

    perm = rcm_ordering(sp.csr_matrix((vals, (rows, cols)), shape=(n, n)))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return perm, inv[rows], inv[cols]


# the port's modes, then the JAX TPU pack modes (default pack here)
_SELL_MODES = (None, "bucketed", "seg", "sorted", "roll", "residue",
               "subroll", "chunked", "rowsel")


class SellOperator(LinearOperator):
    """Unstructured sparse operator in SELL-C-sigma form
    (``ops/kernels/sell.py``): matvec kernel B9 on CUDA (B9 then B10 for
    the segmented pack), the plain twins on CPU.

    Build with ``from_coo`` / ``from_scipy``. With ``rcm=True`` the
    operator acts in the permuted basis: ``perm`` (numpy, perm[new] = old)
    maps vectors in (``x[perm]``) and out.
    """

    def __init__(self, data, is_hermitian: bool = False, perm=None):
        self.data = data
        self.is_hermitian = bool(is_hermitian)
        self.perm = perm

    @property
    def shape(self):
        return (self.data.n, self.data.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        return self.data.nnz

    def matvec(self, x):
        kern, rt = _kernel(self.dtype, x)
        if not kern:
            return (sell_spmv_seg_ref if isinstance(self.data, SellSeg)
                    else sell_spmv_ref)(self.data, x)
        d = self.data
        _refuse_storage_grad(self, (d.base if isinstance(d, SellSeg)
                                    else d).vals, "B9")
        return self._kernel_matvec(x, None)

    def _kernel_matvec(self, x, _):
        if _graph_wanted(x):
            return _KernelMatvec.apply(x, self, None)
        rt = torch.promote_types(self.dtype, x.dtype)
        return launch_plan(_promoted(self, "data", rt))(x.to(rt))

    def _kernel_vjp(self, x, _, g, need_x, need_storage):
        return _hermitian_vjp(self, g, "B9").to(x.dtype), None

    def opnorm_hint(self):
        """max_i sum_j |A_ij|: the row sums of |A| as |A| applied to ones."""
        d = self.data
        seg = isinstance(d, SellSeg)
        vals = (d.base if seg else d).vals.abs()
        ones = torch.ones(d.n, dtype=vals.dtype, device=self.device)
        ref = sell_spmv_seg_ref if seg else sell_spmv_ref
        return ref(d.with_vals(vals), ones).max()

    @classmethod
    def from_coo(cls, rows, cols, vals, n, *, dtype=np.float32,
                 window: int = 2048, residue: bool = False,
                 mode: str | None = None, rcm: bool = False,
                 is_hermitian: bool = False, max_chunks: int = 4,
                 uniform_k: bool | None = None, device=None):
        """Pack COO into the SELL container. ``mode``: None (default
        pack), "bucketed", "seg" (segmented) or "sorted"
        (``SortedSellOperator``); the JAX TPU pack modes ("roll",
        "residue", "subroll", "chunked", "rowsel") take the default pack.
        ``window``, ``residue``, ``max_chunks`` and ``uniform_k`` have no
        effect (``ops/kernels/sell.py``)."""
        from .kernels.sell import sell_pack, sell_pack_bucketed, sell_pack_seg

        if mode not in _SELL_MODES:
            raise ValueError(f"unknown SELL mode {mode!r}")
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        perm = None
        if rcm:
            perm, rows, cols = _rcm(rows, cols, vals, n)
        if mode == "sorted":
            return SortedSellOperator._build(
                rows, cols, vals, n, dtype=dtype, is_hermitian=is_hermitian,
                rcm_perm=perm, device=device)
        if mode == "seg":
            data = sell_pack_seg((rows, cols, vals), n, dtype=dtype,
                                 device=device)
        elif mode == "bucketed":
            data = sell_pack_bucketed((rows, cols, vals), n, dtype=dtype,
                                      device=device)
        else:
            data = sell_pack((rows, cols, vals), n, dtype=dtype,
                             device=device)
        return cls(data, is_hermitian=is_hermitian, perm=perm)

    @classmethod
    def from_scipy(cls, A, **kwargs):
        A = A.tocoo()
        return cls.from_coo(A.row, A.col, A.data, A.shape[0], **kwargs)


class SortedSellOperator(LinearOperator):
    """Degree-sorted conjugated SELL: A = P^T A_s P with A_s = P A P^T,
    P the stable degree sort inside windows of ``sort_window`` rows.

    inner: ``SellOperator`` over A_s (bucketed pack).
    order: int64 tensor, order[new] = old in the caller's basis (the RCM
           relabelling composed in when built with ``rcm=True``), so
           ``permute(x) == x[order]`` always.

    ``matvec`` is the conjugated form (two gathers around one SpMV);
    ``expv``, ``phiv`` and ``chebyshev_apply`` hoist the conjugation
    (``hoist_conjugation``): matrix functions commute with it, so a solve
    pays one gather in and one out instead of two per matvec.
    """

    def __init__(self, inner, order, is_hermitian=False):
        self.inner = inner
        self.order = host_tensor(order, device=inner.device, dtype=torch.int64)
        self._inv = torch.empty_like(self.order)
        self._inv[self.order] = torch.arange(self.order.shape[0],
                                             device=self.order.device)
        self.is_hermitian = bool(is_hermitian)

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def nnz(self) -> int:
        return self.inner.nnz

    def permute(self, x):
        """x in the original order -> sorted order (rows of a 2-D x)."""
        return x[self.order]

    def unpermute(self, x):
        return x[self._inv]

    def matvec(self, x):
        return self.unpermute(self.inner.matvec(self.permute(x)))

    def opnorm_hint(self):
        return self.inner.opnorm_hint()          # conjugation keeps norms

    @classmethod
    def _build(cls, rows, cols, vals, n, *, dtype, is_hermitian,
               rcm_perm=None, sort_window: int = 256, device=None):
        from .kernels.sell import sell_pack_bucketed

        deg = np.bincount(rows, minlength=n)
        order = np.empty(n, np.int64)
        for w0 in range(0, n, sort_window):
            w1 = min(n, w0 + sort_window)
            order[w0:w1] = w0 + np.argsort(deg[w0:w1], kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(n, dtype=np.int64)
        inner = SellOperator(
            sell_pack_bucketed((inv[rows], inv[cols], vals), n, dtype=dtype,
                               device=device), is_hermitian=is_hermitian)
        if rcm_perm is not None:
            # x_sorted[i] = x_rcm[order[i]] = x[rcm_perm[order[i]]]
            order = np.asarray(rcm_perm, np.int64)[order]
        return cls(inner, order, is_hermitian=is_hermitian)

    def save(self, prefix: str) -> None:
        """``<prefix>_inner.npz`` (the pack) and ``<prefix>_order.npy``."""
        self.inner.data.save(f"{prefix}_inner.npz")
        np.save(f"{prefix}_order.npy", self.order.cpu().numpy())

    @classmethod
    def load(cls, prefix: str, *, is_hermitian: bool = False, device=None):
        from .kernels.sell import SellBucketed

        inner = SellOperator(SellBucketed.load(f"{prefix}_inner.npz",
                                               device=device),
                             is_hermitian=is_hermitian)
        return cls(inner, np.load(f"{prefix}_order.npy"),
                   is_hermitian=is_hermitian)


def hoist_conjugation(op, b):
    """(inner_op, permuted_b, postprocess) for a ``SortedSellOperator``;
    (op, b, None) otherwise. Matrix functions commute with the conjugation
    (f(P A P^T) = P f(A) P^T), so a solver calls this once and runs the
    whole solve in the sorted basis."""
    if isinstance(op, SortedSellOperator):
        return op.inner, op.permute(action_vector(b, op)), op.unpermute
    return op, b, None


class HybridOperator(LinearOperator):
    """A = banded + residual: the dense diagonals in a ``BandedOperator``
    (kernel B7) and the rest in a ``SellOperator`` (kernel B9). Build with
    ``hybrid_from_scipy``; either part may be None."""

    def __init__(self, banded, sell, is_hermitian: bool = False):
        self.banded = banded
        self.sell = sell
        self.is_hermitian = bool(is_hermitian)
        self.perm = None

    def _part(self):
        return self.banded if self.banded is not None else self.sell

    @property
    def shape(self):
        return self._part().shape

    @property
    def dtype(self):
        return self._part().dtype

    @property
    def device(self):
        return self._part().device

    @property
    def nnz(self) -> int:
        nb = (0 if self.banded is None
              else int(torch.count_nonzero(self.banded.diags)))
        return nb + (0 if self.sell is None else self.sell.nnz)

    def matvec(self, x):
        if self.banded is None:
            return self.sell.matvec(x)
        y = self.banded.matvec(x)
        if self.sell is not None:
            y = y + self.sell.matvec(x)
        return y

    def opnorm_hint(self):
        h = 0.0
        if self.banded is not None:
            h = h + self.banded.opnorm_hint()
        if self.sell is not None:
            h = h + self.sell.opnorm_hint()
        return h


def hybrid_from_scipy(A, *, min_fill: float = 0.4, max_offsets: int = 31,
                      dtype=np.float32, window: int = 2048,
                      mode: str | None = None, is_hermitian: bool = False,
                      rcm: bool = False, device=None) -> HybridOperator:
    """Split ``A`` into dense diagonals + SELL residual (``HybridOperator``).

    Diagonals whose fill (entries on the offset / n) is >= ``min_fill`` go
    to a ``BandedOperator`` (at most ``max_offsets``, densest first);
    everything else packs into a ``SellOperator`` with ``mode``.
    ``rcm=True`` RCM-permutes first; the operator then acts in the
    permuted basis (``perm``, as ``SellOperator``). ``window`` has no
    effect."""
    A = A.tocoo()
    n = A.shape[0]
    rows, cols, vals = (np.asarray(A.row, np.int64),
                        np.asarray(A.col, np.int64), np.asarray(A.data))
    perm = None
    if rcm:
        perm, rows, cols = _rcm(rows, cols, vals, n)

    off = cols - rows
    uniq, counts = np.unique(off, return_counts=True)
    dense = uniq[counts >= min_fill * n]
    if len(dense) > max_offsets:
        order = np.argsort(counts[np.isin(uniq, dense)])[::-1]
        dense = dense[order[:max_offsets]]
    offsets = np.sort(dense)

    banded = sell = None
    if len(offsets):
        sel = np.isin(off, offsets)
        diags = np.zeros((len(offsets), n),
                         dtype or np.result_type(vals.dtype, np.float32))
        np.add.at(diags, (np.searchsorted(offsets, off[sel]), rows[sel]),
                  vals[sel])
        banded = BandedOperator(host_tensor(diags, device),
                                offsets.tolist(), is_hermitian=is_hermitian)
        res = ~sel
    else:
        res = np.ones(len(off), bool)
    if res.any():
        sell = SellOperator.from_coo(rows[res], cols[res], vals[res], n,
                                     dtype=dtype, mode=mode,
                                     is_hermitian=is_hermitian, device=device)
    hy = HybridOperator(banded, sell, is_hermitian=is_hermitian)
    hy.perm = perm
    return hy

