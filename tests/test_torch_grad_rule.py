"""The kernels' rule on gradients (``repro_torch.kernels._autograd``):
while grad mode is on, a wrapper refuses a CUDA input that requires grad,
because its kernel computes a forward only.  Here on the CPU: the rule
itself on CPU tensors, and each wrapper's CPU branch (its plain version)
staying differentiable."""
import numpy as np
import pytest
import torch

from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels.ops import (flash_attention, mlstm_chunk, rglru_scan,
                                     slstm_step_scan)


def _x(*shape, seed=0, grad=False):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(*shape).astype(np.float32),
                        requires_grad=grad)


def test_refuse_grad_raises_for_an_input_that_requires_grad():
    with pytest.raises(RuntimeError, match="ROADMAP B10"):
        refuse_grad("kernel", _x(2, 3), _x(2, 3, grad=True))


@pytest.mark.parametrize("case", ["no_grad", "inference_mode",
                                  "no_input_requires_grad"])
def test_refuse_grad_lets_the_rest_through(case):
    if case == "no_input_requires_grad":
        refuse_grad("kernel", _x(2, 3), _x(4))
        return
    ctx = torch.no_grad() if case == "no_grad" else torch.inference_mode()
    with ctx:
        refuse_grad("kernel", _x(2, 3, grad=True), _x(4))


def _wrapper_inputs(name):
    if name == "flash_attention":
        return [_x(1, 16, 2, 32, seed=1) * 32 ** -0.5, _x(1, 16, 2, 32, seed=2),
                _x(1, 16, 2, 32, seed=3)]
    if name == "mlstm_chunk":
        return [_x(1, 40, 2, 32, seed=4), _x(1, 40, 2, 32, seed=5),
                _x(1, 40, 2, 32, seed=6), _x(1, 40, 2, seed=7),
                _x(1, 40, 2, seed=8) + 2]
    if name == "rglru_scan":
        return [torch.sigmoid(_x(2, 24, 5, seed=9)) * 0.2 + 0.8,
                _x(2, 24, 5, seed=10) * 0.1]
    return [_x(1, 8, 1, 16, 4, seed=11) * 0.5,
            *(_x(1, 16, 16, seed=12 + g) * 0.05 for g in range(4))]


_WRAPPERS = {"flash_attention": flash_attention, "mlstm_chunk": mlstm_chunk,
             "rglru_scan": rglru_scan, "slstm_step_scan": slstm_step_scan}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_cpu_branch_stays_differentiable(name):
    """On CPU tensors a wrapper runs its plain version and never refuses:
    backward() through it gives its first input a finite, non-zero
    gradient, and launches nothing."""
    fn = _WRAPPERS[name]
    xs = [x.detach().requires_grad_(i == 0)
          for i, x in enumerate(_wrapper_inputs(name))]
    n0 = fn.launches
    fn(*xs).float().pow(2).sum().backward()
    assert fn.launches == n0
    grad = xs[0].grad
    assert grad is not None and grad.shape == xs[0].shape
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
