"""One rank of the port's distributed CPU tests (gloo over a file store).

    python tests/torch_dist_worker.py STORE RANK WORLD INPUTS OUT SUITE

Imports torch and the PyTorch port only (no JAX): the parity tests
(tests/test_torch_parallel.py, test_torch_stencil_fused_sharded.py,
test_torch_multihost.py, test_torch_gspmd.py) start WORLD of these with ``subprocess``, each
joining the process group through ``init_method=file://STORE`` (no TCP
port, so concurrent test workers cannot collide). The rank reads the
seeded numpy inputs from INPUTS (an .npz), runs every case of SUITE on a
CPU mesh, and pickles {case: result} to OUT/SUITE_rankR.pkl. A result is
a dict of numpy arrays and Python values: this rank's rows, the
replicated scalars, the collective census of the case, or ``raised`` =
(exception type, message) for a case that raised.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch import parallel as par
from exponentialutilities_jl_torch.parallel import stencil_fused as sf
from torch_parity import GRAD_CASES

et.set_default_device("cpu")
torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


def t2n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def wide_star():
    """The offsets of the 19-point |o| <= 3 star of the JAX tests."""
    offs = [(0, 0, 0)]
    for ax in range(3):
        for o in (1, -1, 2, -2, 3, -3):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
    return offs


def sym_wide_star(shape, dtype=f64):
    offs, co = [(0, 0, 0)], [-3.0 * 49 / 18]
    for ax in range(3):
        for o, c in ((1, 1.5), (-1, 1.5), (2, -0.15), (-2, -0.15),
                     (3, 1 / 90), (-3, 1 / 90)):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
            co.append(c)
    return et.StencilOperator(shape, offs, np.asarray(co) / 4,
                              is_hermitian=True, dtype=dtype)


def h0_2_star(shape, dtype):
    offs, cs = [], []
    for ax in range(3):
        for o in (-2, -1, 1, 2):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
            cs.append(-1.0 / 12 if abs(o) == 2 else 4.0 / 3)
    offs.append((0, 0, 0))
    cs.append(-3 * 5.0 / 2)
    return et.StencilOperator(shape, offs, np.asarray(cs), is_hermitian=True,
                              dtype=dtype)


def nine_point(inp, dtype):
    offs = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)]
    return et.StencilOperator((24, 16), offs, inp["co9"], is_hermitian=True,
                              dtype=dtype)


# ------------------------------------------------------------------ suites --

def suite_parallel(mesh, inp):
    """float64, the plain sharded paths (the JAX XLA paths' counterparts)."""
    P = mesh.axis().axis_size()
    ax = mesh.axis()
    b256 = torch.as_tensor(inp["b256"])
    b128 = torch.as_tensor(inp["b128"])
    bst = torch.as_tensor(inp["b_st"])
    lap256 = et.laplacian_1d(256)
    lap128 = et.laplacian_1d(128)
    st = et.laplacian_nd_stencil(16, 4, 4)
    ad3 = et.advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0)
    cases = {}

    def banded_matvec():
        op = et.poisson_2d(16, 8)
        d, mk = par.shard_banded(op, mesh)
        return {"w": mk(d).matvec(par.shard_vector(b128, mesh))}
    cases["banded_matvec"] = banded_matvec

    def banded_halo_too_wide():
        nl = 128 // P
        D = torch.ones((3, 128), dtype=f64)
        op = et.BandedOperator(D, (-(nl + 1), 0, nl + 1))
        return {"w": par.expv_sharded(0.1, op, b128, mesh, m=10)}
    cases["banded_halo_too_wide"] = banded_halo_too_wide

    def expv_lanczos():
        w = par.expv_sharded(0.5, lap256, b256, mesh, m=40)
        return {"w": w, "gathered": par.gather_vector(w, mesh)}
    cases["expv_lanczos"] = expv_lanczos

    def lanczos_scalars():
        d, mk = par.shard_banded(lap256, mesh)
        a, bb, b0, mu, br = et.lanczos_coeffs(
            mk(d), par.shard_vector(b256, mesh), 40)
        return {"alphas": a, "betas": bb, "beta0": b0, "m_used": mu}
    cases["lanczos_scalars"] = lanczos_scalars

    cases["expv_arnoldi"] = lambda: {"w": par.expv_sharded(
        5e-4, et.advection_diffusion_1d(128, peclet=3.0), b128, mesh, m=40)}

    def expv_step():
        step, params = par.make_expv_step(lap128, mesh, m=30)
        bl = par.shard_vector(b128, mesh)
        return {"w1": step(0.1, params, bl), "w2": step(0.2, params, bl)}
    cases["expv_step"] = expv_step

    def phiv():
        w, err = par.phiv_sharded(0.2, lap128, b128, 3, mesh, m=40)
        return {"w": w, "err": err}
    cases["phiv"] = phiv

    def stencil_matvec():
        c, mk = par.shard_stencil(st, mesh)
        return {"w": mk(c).matvec(par.shard_vector(bst, mesh))}
    cases["stencil_matvec"] = stencil_matvec
    cases["stencil_expv"] = lambda: {"w": par.expv_sharded(
        0.1, st, bst, mesh, m=40)}

    def stencil_phiv():
        w, err = par.phiv_sharded(0.2, st, bst, 2, mesh, m=30)
        return {"w": w, "err": err}
    cases["stencil_phiv"] = stencil_phiv

    def stencil_wide_matvec():
        op = et.StencilOperator((32, 3, 5), wide_star(),
                                inp["co_wide"])
        c, mk = par.shard_stencil(op, mesh)
        return {"w": mk(c).matvec(par.shard_vector(
            torch.as_tensor(inp["x_wide"]), mesh))}
    cases["stencil_wide_matvec"] = stencil_wide_matvec
    cases["stencil_wide_expv"] = lambda: {"w": par.expv_sharded(
        0.3, sym_wide_star((32, 3, 5)), torch.as_tensor(inp["x_wide"]),
        mesh, m=40)}

    def stencil_halo_deeper():
        op = et.StencilOperator((2 * P, 4, 4),
                                [(3, 0, 0), (0, 0, 0), (-3, 0, 0)],
                                np.asarray([1.0, -2.0, 1.0]))
        c, mk = par.shard_stencil(op, mesh)
        return {"w": mk(c).matvec(torch.ones(32, dtype=f64))}
    cases["stencil_halo_deeper"] = stencil_halo_deeper

    cases["two_pass"] = lambda: {"w": par.expv_sharded(
        0.5, lap256, b256, mesh, m=40, two_pass=True)}
    cases["cheb_banded"] = lambda: {"w": par.expv_chebyshev_sharded(
        0.5, lap256, b256, mesh, tol=1e-12)}
    cases["cheb_stencil1d"] = lambda: {"w": par.expv_chebyshev_sharded(
        0.4, et.laplacian_nd_stencil(256), b256, mesh, tol=1e-12)}
    cases["leja"] = lambda: {"w": par.expv_leja_sharded(
        0.004, ad3, torch.as_tensor(inp["b_ad3"]), mesh)}
    cases["faber"] = lambda: {"w": par.expv_faber_sharded(
        0.004, ad3, torch.as_tensor(inp["b_ad3"]), mesh)}
    cases["zero_b"] = lambda: {"w": par.expv_sharded(
        0.5, lap256, torch.zeros(256, dtype=f64), mesh, m=20)}
    cases["complex_t"] = lambda: {"w": par.expv_sharded(
        0.1j, lap256, b256, mesh, m=30, two_pass=True)}
    cases["raise_two_pass_nonherm"] = lambda: par.expv_sharded(
        1e-4, et.advection_diffusion_1d(128), b128, mesh, two_pass=True)
    cases["raise_fused_no_two_pass"] = lambda: par.expv_sharded(
        0.1, st, bst, mesh, fused=True)
    cases["raise_cheb_nonherm"] = lambda: par.expv_chebyshev_sharded(
        0.1, et.advection_diffusion_1d(128), b128, mesh)
    cases["raise_no_rule"] = lambda: par.expv_sharded(
        0.1, et.DenseOperator(torch.eye(128, dtype=f64)), b128, mesh)
    cases["raise_not_divisible"] = lambda: par.expv_sharded(
        0.1, et.laplacian_1d(4 * P + 1), torch.ones(4 * P + 1, dtype=f64),
        mesh)

    def carried():
        """Operators carried across from the JAX package by their plain
        data (utils/convert.py), sharded as the port's own."""
        from exponentialutilities_jl_torch.utils.convert import \
            from_operator_data
        ops = {kind: from_operator_data({
            "type": kind, "offsets": inp[f"{key}_offsets"].tolist(),
            "is_hermitian": True, **extra}, device="cpu")
            for kind, key, extra in (
                ("BandedOperator", "cb", {"diags": inp["cb_diags"]}),
                ("StencilOperator", "cs", {"coeffs": inp["cs_coeffs"],
                                           "grid_shape": (16, 4, 4)}),
                ("VariableStencilOperator", "cv",
                 {"coeff_fields": inp["cv_fields"],
                  "grid_shape": (16, 6, 10)}))}
        d, mkb = par.shard_banded(ops["BandedOperator"], mesh)
        c, mks = par.shard_stencil(ops["StencilOperator"], mesh)
        return {"banded": mkb(d).matvec(par.shard_vector(b128, mesh)),
                "stencil": mks(c).matvec(par.shard_vector(bst, mesh)),
                "variable": par.expv_chebyshev_sharded(
                    0.05, ops["VariableStencilOperator"],
                    torch.as_tensor(inp["b_v"]), mesh, fused=True,
                    tol=1e-6)}
    cases["carried"] = carried

    def local_plain_path():
        from exponentialutilities_jl_torch.ops.kernels import dispatch
        from exponentialutilities_jl_torch.ops.kernels.lanczos_fused import \
            fused_supported
        from exponentialutilities_jl_torch.ops.kernels.resident import (
            resident_banded_supported, resident_supported)
        c, mk = par.shard_stencil(et.laplacian_nd_stencil(16, 4, 4), mesh)
        d, mkb = par.shard_banded(lap256, mesh)
        c1, mk1 = par.shard_stencil(et.laplacian_nd_stencil(256), mesh)
        out = {}
        for name, lop in (("stencil3d", mk(c)), ("banded", mkb(d)),
                          ("stencil1d", mk1(c1))):
            out[name + "_engine_none"] = dispatch.recurrence_engine(
                lop, f64, device="cuda", hermitian=True) is None
            out[name + "_not_fused"] = not fused_supported(lop)
            out[name + "_not_resident"] = not (resident_supported(lop) or
                                               resident_banded_supported(lop))
            try:
                dispatch.recurrence_engine(lop, f64, True, device="cuda")
                out[name + "_fused_true_raises"] = False
            except ValueError:
                out[name + "_fused_true_raises"] = True
        return out
    cases["local_plain_path"] = local_plain_path
    return cases


def suite_fused(mesh, inp):
    """The shard-local fused sweeps' plain twins (``fused=True``)."""
    P = mesh.axis().axis_size()
    cases = {}
    b3 = torch.as_tensor(inp["b3"])             # 16 x 12 x 10
    b2 = torch.as_tensor(inp["b2"])             # 24 x 16
    bv = torch.as_tensor(inp["bv"])             # 16 x 6 x 10
    for dt, dn in ((f32, "f32"), (f64, "f64")):
        lap3 = et.laplacian_nd_stencil(16, 12, 10, dtype=dt)
        lap2 = et.laplacian_nd_stencil(24, 16, dtype=dt)
        x3, x2, xv = b3.to(dt), b2.to(dt), bv.to(dt)
        cases[f"cheb3d_{dn}"] = (lambda op=lap3, x=x3: {
            "w": par.expv_chebyshev_sharded(0.2, op, x, mesh, fused=True)})
        cases[f"twopass3d_{dn}"] = (lambda op=lap3, x=x3: {
            "w": par.expv_sharded(0.3, op, x, mesh, m=25, two_pass=True,
                                  fused=True)})
        cases[f"cheb2d_{dn}"] = (lambda op=lap2, x=x2: {
            "w": par.expv_chebyshev_sharded(0.1, op, x, mesh, fused=True)})
        cases[f"twopass2d_{dn}"] = (lambda op=lap2, x=x2: {
            "w": par.expv_sharded(0.2, op, x, mesh, m=25, two_pass=True,
                                  fused=True)})

        def coeffs_replay(op=lap3, x=x3):
            plan = sf.fused_shard_plan(op, mesh, hermitian=True)
            bl = par.shard_vector(x, mesh)
            a, bb, b0, mu, br = sf.lanczos_coeffs_fused_sharded(plan, bl, 12)
            from exponentialutilities_jl_torch.models.expv import \
                _lanczos_reduced_coeffs
            co = _lanczos_reduced_coeffs(a, bb, b0, 0.3)
            # the replay's own alphas, betas (the public replay returns w)
            a2, b2_, _, _, _, w = sf._lanczos_sharded(plan, bl, 0, 1e-7, co)
            return {"alphas": a, "betas": bb, "beta0": b0, "m_used": mu,
                    "broke": br, "alphas2": a2, "betas2": b2_, "w": w}
        cases[f"coeffs_replay_{dn}"] = coeffs_replay
        cases[f"cheb_h0_2_{dn}"] = (lambda x=bv.to(dt), d_=dt: {
            "w": par.expv_chebyshev_sharded(
                0.05, h0_2_star((16, 6, 10), d_), x, mesh, fused=True)})
        cases[f"cheb2d_9pt_{dn}"] = (lambda x=x2, d_=dt: {
            "w": par.expv_chebyshev_sharded(
                0.05, nine_point(inp, d_), x, mesh, fused=True,
                bounds=(-4.0, 4.0), tol=1e-6)})
        ad = et.advection_diffusion_3d_stencil(16, 6, 10, peclet=1.5,
                                               dtype=dt)
        cases[f"leja_{dn}"] = (lambda op=ad, x=xv: {
            "w": par.expv_leja_sharded(0.002, op, x, mesh, tol=1e-6,
                                       fused=True)})
        cases[f"faber_{dn}"] = (lambda op=ad, x=xv: {
            "w": par.expv_faber_sharded(0.002, op, x, mesh, tol=1e-6,
                                        fused=True)})
        vop = et.variable_diffusion_nd_stencil(inp["a_var"], dtype=dt)
        cases[f"var_cheb_{dn}"] = (lambda op=vop, x=xv: {
            "w": par.expv_chebyshev_sharded(0.05, op, x, mesh, fused=True,
                                            tol=1e-6)})
    cases["zero_b"] = lambda: {"w": par.expv_sharded(
        0.3, et.laplacian_nd_stencil(16, 12, 10, dtype=f32),
        torch.zeros(1920, dtype=f32), mesh, m=10, two_pass=True,
        fused=True)}
    cases["complex_t_default"] = lambda: {"w": par.expv_sharded(
        0.1j, et.laplacian_nd_stencil(16, 12, 10, dtype=f32), b3.to(f32),
        mesh, m=30, two_pass=True)}
    cases["raise_complex_t_fused"] = lambda: par.expv_sharded(
        0.1j, et.laplacian_nd_stencil(16, 12, 10, dtype=f32), b3.to(f32),
        mesh, m=30, two_pass=True, fused=True)

    def halo_deeper():
        op = et.StencilOperator((P, 6, 10), [(0, 0, 0), (2, 0, 0),
                                             (-2, 0, 0), (0, 1, 0),
                                             (0, -1, 0)],
                                np.asarray([-2.0, 0.5, 0.5, 0.5, 0.5]),
                                is_hermitian=True, dtype=f32)
        from exponentialutilities_jl_torch.parallel.krylov import \
            _fused_shard_ok
        ok = _fused_shard_ok(op, mesh, None, torch.ones(60 * P, dtype=f32),
                             hermitian=True, fused=True) is None
        try:
            par.expv_chebyshev_sharded(0.05, op, torch.ones(60 * P,
                                                            dtype=f32), mesh)
            raised = None
        except ValueError as e:
            raised = str(e)
        return {"plan_none": ok, "auto_raised": raised}
    cases["halo_deeper"] = halo_deeper

    def plan_cache():
        # a second mesh over the same ranks reuses the operator's plan
        # (and its buffers) under its own axis: one cache entry
        op = et.laplacian_nd_stencil(16, 12, 10, dtype=f32)
        p1 = sf.fused_shard_plan(op, mesh, hermitian=True)
        again = sf.fused_shard_plan(op, mesh, hermitian=True) is p1
        mesh2 = par.make_mesh(device="cpu")
        p2 = sf.fused_shard_plan(op, mesh2, hermitian=True)
        out = {"same": again, "entries": len(op._shard_plans),
               "comm2": p2.comm is mesh2.axis(), "comm1": p1.comm is
               mesh.axis(), "ext_shared": p2.ext is p1.ext}
        out["w"] = par.expv_chebyshev_sharded(0.2, op, b3.to(f32), mesh2,
                                              fused=True)
        return out
    cases["plan_cache"] = plan_cache

    def dispatch_policy():
        from exponentialutilities_jl_torch.parallel.krylov import \
            _fused_shard_ok
        op = et.laplacian_nd_stencil(16, 12, 10, dtype=f32)
        auto = _fused_shard_ok(op, mesh, None, b3.to(f32), hermitian=True)
        forced = _fused_shard_ok(op, mesh, None, b3.to(f32), hermitian=True,
                                 fused=True)
        forced64 = _fused_shard_ok(op, mesh, None, b3, hermitian=True,
                                   fused=True)
        return {"auto_none": auto is None, "forced": forced is not None,
                "forced_f64": forced64 is not None}
    cases["dispatch_policy"] = dispatch_policy

    def census_rows():
        op = et.laplacian_nd_stencil(16, 12, 10, dtype=f32)
        plan = sf.fused_shard_plan(op, mesh, hermitian=True)
        rows = sf.chebyshev_rows(torch.linspace(1.0, 0.1, 9), -3.0, 3.0, f32)
        return {"w": sf.recurrence_apply_fused_sharded(
            plan, par.shard_vector(b3.to(f32), mesh), rows)}
    cases["census_rows"] = census_rows
    return cases


def suite_multihost(mesh, inp):
    """Layouts of parallel/multihost.py on WORLD ranks as two hosts."""
    from torch import distributed as dist
    cases = {}
    n = 64
    op = et.laplacian_1d(n)
    bb = torch.as_tensor(inp["B"])              # (2, 32)

    def global_mesh():
        g = par.make_global_mesh(n_hosts=2, device="cpu")
        step, params = par.make_expv_step(op, g, m=20)
        w = step(0.1, params, torch.as_tensor(inp["b64"]))
        return {"w": w, "size": g.axis().axis_size(), "census": dict(g.census)}
    cases["global_mesh"] = global_mesh

    def host_data_mesh():
        hd = par.make_host_data_mesh(n_hosts=2, device="cpu")
        data = hd.axis("data").axis_index()
        shard = hd.axis("shard").axis_index()
        b = bb[data]
        w = par.expv_sharded(0.1, et.laplacian_1d(32), b, hd, m=16,
                             axis_name="shard")
        return {"w": w, "data": data, "shard": shard,
                "shape": dict(hd.shape), "census": {
                    k: dict(v) for k, v in hd.census.items()},
                "data_ranks": hd.axis("data").ranks,
                "shard_ranks": hd.axis("shard").ranks}
    cases["host_data_mesh"] = host_data_mesh

    def subgroup_mesh():
        sub = par.make_mesh(2, device="cpu")
        if dist.get_rank() >= 2:
            return {"member": sub.axis().member}
        w = par.expv_sharded(0.1, et.laplacian_1d(32),
                             torch.as_tensor(inp["B"][0]), sub, m=16)
        return {"member": sub.axis().member, "w": w}
    cases["subgroup_mesh"] = subgroup_mesh

    def too_many():
        par.make_mesh(dist.get_world_size() + 1, device="cpu")
    cases["raise_too_many"] = too_many

    def nccl_same_device():
        from exponentialutilities_jl_torch.parallel.mesh import check_devices
        check_devices([0, 1], "cpu", "nccl")
    cases["raise_nccl_cpu"] = nccl_same_device

    def gather():
        x = torch.arange(4, dtype=f64) + 10 * dist.get_rank()
        return {"g": par.gather_vector(x, mesh)}
    cases["gather"] = gather

    def warmup_mesh():
        from exponentialutilities_jl_torch.utils.aot import warmup
        out = warmup(n=32, m=10, k=2, dtype=f64, mesh=mesh)
        return {"w": out["expv_sharded"], "names": sorted(out)}
    cases["warmup_mesh"] = warmup_mesh

    cases["reinit_is_noop"] = lambda: {"again": par.initialize_distributed(
        "file:///nonexistent/store", 2, 0, backend="gloo")}
    return cases


def carried_op(inp, key):
    """The port's operator from the plain data (utils/convert.py) that the
    test wrote under ``key__<field>``."""
    from exponentialutilities_jl_torch.utils.convert import \
        from_operator_data

    pre = key + "__"
    data = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    data["type"] = str(data["type"])
    h = int(data["is_hermitian"])
    data["is_hermitian"] = None if h < 0 else bool(h)
    if "offsets" in data:
        data["offsets"] = [tuple(int(x) for x in np.atleast_1d(o))
                           if np.ndim(o) else int(o) for o in data["offsets"]]
    if "grid_shape" in data:
        data["grid_shape"] = tuple(int(s) for s in data["grid_shape"])
    return from_operator_data(data, device="cpu")


def suite_gspmd(mesh, inp):
    """The GSPMD route (parallel.shard_operator): the ordinary drivers on
    sharded operators and this rank's rows, float64."""
    import dataclasses

    from torch import distributed as dist

    from exponentialutilities_jl_torch.models.expv_taylor import expv_taylor
    from exponentialutilities_jl_torch.models.integrators import (
        exprb43, exprb43_device)
    from exponentialutilities_jl_torch.models.kiops_device import \
        kiops_device
    from exponentialutilities_jl_torch.models.nw_device import \
        phiv_timestep_device
    from exponentialutilities_jl_torch.utils.comm import (AugmentedAxis,
                                                          vector_norm)

    ax = mesh.axis()
    ops = {k: carried_op(inp, k) for k in ("lap", "ell", "bell", "dense",
                                           "ad3", "lap128", "adv", "p2d6",
                                           "band3", "adv_ell", "adv_bell")}
    sh = {k: par.shard_operator(v, mesh) for k, v in ops.items()}

    def rows(key):
        return par.shard_vector(torch.as_tensor(inp[key]), mesh)

    def stats(s):
        return dataclasses.asdict(s)

    def f_ac(A):
        return lambda u: A.matvec(u) - u ** 3

    cases = {}
    cases["expv_banded"] = lambda: {"w": et.expv(0.5, sh["lap"], rows("b256"),
                                                 m=40)}
    cases["expv_ell"] = lambda: {"w": et.expv(0.5, sh["ell"], rows("b256"),
                                              m=40, hermitian=True)}
    cases["expv_blockell"] = lambda: {"w": et.expv(0.2, sh["bell"],
                                                   rows("b512"), m=20)}
    # the replicated reduced problem on each rank's host: no collective
    cases["expv_host"] = lambda: {"w": et.expv(0.5, sh["lap"], rows("b256"),
                                               m=40, reduced="host")}
    cases["expv_dense"] = lambda: {"w": et.expv(0.5, sh["dense"],
                                                rows("b64"), m=40)}
    cases["expv_arnoldi"] = lambda: {"w": et.expv(5e-4, sh["adv"],
                                                  rows("b128"), m=40)}
    # halos wider than a shard (k exchanges a matvec)
    cases["expv_p2d"] = lambda: {"w": et.expv(0.1, sh["p2d6"], rows("b12"),
                                              m=10)}
    cases["expv_band3"] = lambda: {"w": et.expv(0.05, sh["band3"],
                                                rows("b32"), m=20)}

    def grad(key, t, vec, m):
        # d/db of the sum over every rank's rows of expv: each rank's
        # backward on its own part (parallel/mesh.py)
        def case():
            b = rows(vec).clone().requires_grad_()
            et.expv(t, sh[key], b, m=m, differentiable=True).sum().backward()
            return {"w": b.grad}
        return case
    for key, (t, vec, m) in GRAD_CASES.items():
        cases[f"grad_{key}"] = grad(key, t, vec, m)

    def expv_timestep():
        U, st = et.expv_timestep([0.5], sh["lap"], rows("b256"),
                                 adaptive=True, return_stats=True)
        return {"w": U[:, 0], "stats": stats(st)}
    cases["expv_timestep"] = expv_timestep

    def kiops():
        w, st = et.kiops([0.5], sh["lap"], rows("b256")[:, None])
        return {"w": w.reshape(-1), "stats": stats(st)}
    cases["kiops"] = kiops

    def nw_device():
        U, st = phiv_timestep_device([0.5], sh["lap"], rows("b256")[:, None],
                                     m=20, return_stats=True)
        return {"w": U[:, 0], "stats": stats(st)}
    cases["nw_device"] = nw_device

    def kiops_dev():
        w, st = kiops_device([0.5], sh["lap"], rows("b256")[:, None])
        return {"w": w.reshape(-1), "stats": stats(st)}
    cases["kiops_device"] = kiops_dev

    def exprb43_dev():
        u, st = exprb43_device(f_ac(sh["lap"]), rows("u0"), (0.0, 0.05),
                               adaptive=True, m=12, rtol=1e-6, atol=1e-9,
                               return_stats=True, comm=ax)
        return {"w": u, "stats": stats(st)}
    cases["exprb43_device"] = exprb43_dev

    cases["expv_chebyshev"] = lambda: {"w": et.expv_chebyshev(
        0.5, sh["lap"], rows("b256"), tol=1e-12,
        bounds=ops["lap"].spectral_bounds_hint())}

    def leja_faber():
        B = rows("B_ad3")
        return {"leja": et.phiv_timestep_leja([0.003], sh["ad3"], B),
                "faber": et.phiv_timestep_faber([0.003], sh["ad3"], B)}
    cases["leja_faber"] = leja_faber

    def batched_data_shard():
        if dist.get_world_size() != 4:
            return {"skip": True}
        hd = par.make_host_data_mesh(n_hosts=2, device="cpu")
        d = hd.axis("data").axis_index()
        s = hd.axis("shard").axis_index()
        op_s = par.shard_operator(ops["lap128"], hd, "shard")
        Bl = torch.as_tensor(inp["B4"])[2 * d:2 * d + 2, 64 * s:64 * (s + 1)]
        hd.reset_census()
        W = et.expv_batched(0.3, op_s, Bl, m=30)
        return {"W": W, "data": d, "shard": s,
                "census": {k: dict(v) for k, v in hd.census.items()}}
    cases["batched_data_shard"] = batched_data_shard

    def kiops_tail():
        w, st = et.kiops([0.1, 0.3], sh["lap"], rows("U4"))
        # the augmented start [w; tail]: its norm with the tail counted once
        # (AugmentedAxis) and counted on every rank (the plain axis)
        x0 = torch.cat([rows("U4")[:, 0], torch.as_tensor(inp["tail"])])
        aug = AugmentedAxis(ax, x0.shape[0] - 3)
        return {"w": w, "stats": stats(st),
                "norm_once": vector_norm(x0, aug),
                "norm_every_rank": vector_norm(x0, ax)}
    cases["kiops_tail"] = kiops_tail

    cases["raise_cheb_diverges"] = lambda: et.expv_chebyshev(
        0.5, sh["lap"], rows("b256"), bounds=(-1.0, 0.0), m=400)

    def raise_sell():
        import scipy.sparse as sp
        A = sp.random(64, 64, density=0.1, random_state=3, format="csr")
        par.shard_operator(et.SellOperator.from_scipy(A, device="cpu"),
                           mesh)
    cases["raise_sell"] = raise_sell
    cases["raise_variable"] = lambda: par.shard_operator(
        et.variable_diffusion_nd_stencil(np.ones((8, 4, 4)), device="cpu"),
        mesh)

    # the other drivers, against the single-device port
    def phiv():
        w, err = et.phiv(0.2, sh["lap"], rows("b256"), 2, m=40, errest=True)
        return {"w": w, "err": err}
    cases["phiv"] = phiv
    cases["expv_two_pass"] = lambda: {"w": et.expv(
        0.5, sh["lap"], rows("b256"), m=40, two_pass=True)}
    cases["expv_iop_two_pass"] = lambda: {"w": et.expv(
        5e-4, sh["adv"], rows("b128"), m=30, iop=2, two_pass=True)}

    def expv_errest():
        w, it = et.expv(0.5, sh["lap"], rows("b256"), m=40,
                        mode="error_estimate", return_info=True)
        return {"w": w, "iters": it}
    cases["expv_error_estimate"] = expv_errest
    cases["make_expv"] = lambda: {"w": et.make_expv(sh["lap"], m=40)(
        0.5, rows("b256"))}
    cases["phiv_chebyshev"] = lambda: {"w": et.phiv_chebyshev(
        0.5, sh["lap"], rows("b256"), 2, tol=1e-12)}
    cases["phiv_timestep_chebyshev"] = lambda: {
        "w": et.phiv_timestep_chebyshev([0.25, 0.5], sh["lap"],
                                        rows("U4")[:, :3], tol=1e-12)}
    cases["cheb_ell_bounds"] = lambda: {"w": et.expv_chebyshev(
        0.5, sh["ell"], rows("b256"), tol=1e-10)}

    def phiv_timestep_two_pass():
        U, st = et.phiv_timestep([0.2, 0.5], sh["lap"], rows("U4")[:, :3],
                                 adaptive=True, two_pass=True,
                                 return_stats=True)
        return {"w": U, "stats": stats(st)}
    cases["phiv_timestep_two_pass"] = phiv_timestep_two_pass

    def phiv_timestep_negative():
        U, st = et.phiv_timestep([-0.2, 0.3], sh["lap"], rows("U4")[:, :2],
                                 adaptive=True, return_stats=True)
        return {"w": U, "stats": stats(st)}
    cases["phiv_timestep_negative"] = phiv_timestep_negative

    def fused_fixed():
        u, eps = et.phiv_timestep_fused(0.5, sh["lap"], rows("U4")[:, :2],
                                        nsteps=4, m=12)
        return {"w": u, "eps": eps}
    cases["phiv_timestep_fused"] = fused_fixed
    cases["expv_taylor"] = lambda: {"w": expv_taylor(
        0.5, sh["lap"], rows("b256"))}
    cases["expv_leja"] = lambda: {"w": et.expv_leja(
        0.004, sh["ad3"], rows("b_ad3"))}
    cases["expv_faber"] = lambda: {"w": et.expv_faber(
        0.004, sh["ad3"], rows("b_ad3"))}
    cases["phiv_faber"] = lambda: {"w": et.phiv_faber(
        0.004, sh["ad3"], rows("b_ad3"), 2)}

    def exprb43_host():
        u, st = exprb43(f_ac(sh["lap"]), rows("u0"), (0.0, 0.05), rtol=1e-6,
                        atol=1e-9, comm=ax)
        return {"w": u, "stats": stats(st)}
    cases["exprb43"] = exprb43_host

    cases["phiv_leja"] = lambda: {"w": et.phiv_leja(
        0.004, sh["ad3"], rows("b_ad3"), 1)}

    def etdrk4_host():
        u, st = et.etdrk4(sh["lap"], lambda u: -u ** 3, rows("u0"),
                          (0.0, 0.05), 0.025)
        return {"w": u, "stats": stats(st)}
    cases["etdrk4"] = etdrk4_host

    def exprb32_fixed():
        u, st = et.exprb32_device(f_ac(sh["lap"]), rows("u0"), (0.0, 0.05),
                                  0.0125, m=16, return_stats=True, comm=ax)
        return {"w": u, "stats": stats(st)}
    cases["exprb32_device"] = exprb32_fixed

    def etdrk4_dev():
        return {"w": et.etdrk4_device(sh["lap"], lambda u: -u ** 3,
                                      rows("u0"), (0.0, 0.05), 0.0125,
                                      m=20)}
    cases["etdrk4_device"] = etdrk4_dev

    def hints():
        op = sh["lap"]
        return {"bounds": op.spectral_bounds_hint(),
                "interval": et.real_interval(op),
                "ellipse": et.fov_ellipse(sh["ad3"]),
                "opnorm": op.opnorm_hint(), "shape": op.shape,
                "nnz": op.nnz, "n_local": op.n_local,
                "halo": op.halo, "dense_nnz": hasattr(sh["dense"], "nnz")}
    cases["hints"] = hints
    return cases


SUITES = {"parallel": suite_parallel, "fused": suite_fused,
          "multihost": suite_multihost, "gspmd": suite_gspmd}


def main(argv):
    store, rank, world, inputs, out, suite = argv
    rank, world = int(rank), int(world)
    if not par.initialize_distributed(f"file://{store}", world, rank,
                                      backend="gloo"):
        raise RuntimeError("initialize_distributed did not start the group")
    mesh = par.make_mesh(device="cpu")
    inp = dict(np.load(inputs))
    results = {}
    for name, fn in SUITES[suite](mesh, inp).items():
        mesh.reset_census()
        try:
            res = fn() or {}
            res = {k: t2n(v) for k, v in res.items()}
        except Exception as e:           # recorded: the tests assert on it
            res = {"raised": (type(e).__name__, str(e)),
                   "trace": traceback.format_exc()}
        res["census_case"] = {k: dict(v) for k, v in mesh.census.items()}
        results[name] = res
        torch.distributed.barrier()
    with open(os.path.join(out, f"{suite}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
