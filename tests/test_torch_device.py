"""Where the port puts tensors built from host data (utils/device.py): the
default device is CUDA, an explicit ``device=`` wins, a tensor keeps its
device, and without a GPU a CUDA default raises instead of carrying on on
the CPU. The parity tests ask for the CPU in tests/torch_parity.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops.kernels import sell as ts
from torch_parity import t2n

A2 = np.eye(4) * -1.0
CONSTRUCTORS = {
    "laplacian_nd_stencil": lambda: et.laplacian_nd_stencil(4, 5),
    "StencilOperator": lambda: et.StencilOperator(
        (8,), [(0,), (1,)], np.asarray([-1.0, 0.5])),
    "variable_diffusion_nd_stencil": lambda: et.variable_diffusion_nd_stencil(
        np.ones((3, 4))),
    "VariableStencilOperator": lambda: et.VariableStencilOperator(
        (6,), [(0,)], np.ones((1, 6))),
    "advection_diffusion_3d_stencil": lambda: et.advection_diffusion_3d_stencil(
        3, 3, 3),
    "poisson_2d": lambda: et.poisson_2d(4, 5),
    "advection_diffusion_1d": lambda: et.advection_diffusion_1d(10),
    "aslinearoperator": lambda: et.aslinearoperator(A2),
    "expm": lambda: et.expm(A2),
    "expv numpy": lambda: et.expv(0.5, A2, np.ones(4), m=3),
    "expv_chebyshev numpy": lambda: et.expv_chebyshev(0.5, A2, np.ones(4)),
    "expv_leja numpy": lambda: et.expv_leja(0.5, A2, np.ones(4)),
    "expv_faber numpy": lambda: et.expv_faber(0.5, A2, np.ones(4)),
    "expv_taylor numpy": lambda: et.expv_taylor(0.5, A2, np.ones(4)),
    "expv_taylor_batched numpy": lambda: et.expv_taylor_batched(
        0.5, A2[None], np.ones((1, 4))),
    "banded_from_scipy": lambda: et.banded_from_scipy(sp.eye(6, format="csr")),
    "SellOperator.from_scipy": lambda: et.SellOperator.from_scipy(
        sp.eye(40, format="csr")),
    "sell_pack": lambda: ts.sell_pack((np.arange(5), np.arange(5),
                                       np.ones(5)), 5),
}


@pytest.fixture
def cuda_default():
    """The default device left at CUDA, as a user's process has it; the
    CPU default of the parity tests restored afterwards."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    prev = et.set_default_device("cuda")
    try:
        yield
    finally:
        et.set_default_device(prev)


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_cuda_default_without_gpu_raises(cuda_default, name):
    assert et.default_device() == torch.device("cuda")
    with pytest.raises(RuntimeError) as info:
        CONSTRUCTORS[name]()
    msg = str(info.value)
    assert 'device="cpu"' in msg and 'set_default_device("cpu")' in msg


def test_explicit_device_and_tensors_win(cuda_default):
    op = et.laplacian_nd_stencil(4, 5, device="cpu")
    assert op.device.type == "cpu"
    vop = et.variable_diffusion_nd_stencil(torch.ones(3, 4))
    assert vop.device.type == "cpu"             # the tensor's device
    dop = et.aslinearoperator(torch.as_tensor(A2))
    assert dop.A.device.type == "cpu"
    # an action places a numpy b on the operator's device
    w = et.expv(0.5, op, np.ones(20), m=4)
    assert w.device.type == "cpu"
    w2 = et.expv(0.5, op, torch.ones(20, dtype=torch.float64), m=4)
    assert np.array_equal(t2n(w), t2n(w2))


def test_set_default_device_returns_previous():
    prev = et.set_default_device("cpu")
    try:
        assert et.default_device() == torch.device("cpu")
        assert et.laplacian_nd_stencil(6).device.type == "cpu"
    finally:
        assert et.set_default_device(prev) == torch.device("cpu")
