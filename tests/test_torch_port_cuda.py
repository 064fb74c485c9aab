"""colvo_torch's CUDA kernels on a card, against their plain versions.

Marked ``cuda``; each test skips without a CUDA device. The file imports
no JAX, so on a machine without it run it without the suite's conftest,
from the repository root:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.kernels import sampler, scatter


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coords(n, h, w, seed):
    """Smooth-ish random warps with out-of-bounds, ±1e20 and 3e9 coords."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    x = gx[None] + rng.normal(0, 8.0, (n, h, w)).astype(np.float32)
    y = gy[None] + rng.normal(0, 8.0, (n, h, w)).astype(np.float32)
    x[0, 1, 3], x[0, 2, 5], x[1, 5, 11] = 1e20, -1e20, 3e9
    y[0, 3, 7], y[0, 4, 9] = 1e20, -1e20
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
def test_kernels_match_plain_versions(device, c):
    """S (both variants): value ≤1e-5, d/dx, d/dy ≤1e-4 abs; T ≤1e-4 of
    max|d_src| (float atomics add in a run-dependent order)."""
    rng = np.random.default_rng(8)
    src = torch.tensor(rng.random((3, c, 40, 56), dtype=np.float32), device=device)
    x, y = (torch.tensor(a, device=device) for a in _coords(3, 36, 50, 9))
    for with_grad in (True, False):
        got = sampler.sample(src, x, y, with_grad)
        want = sampler.sample_plain(src, x, y, with_grad)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        for k, p in zip(got[1:], want[1:]):
            if with_grad:
                torch.testing.assert_close(k, p, atol=1e-4, rtol=0)
            else:
                assert k is None and p is None
    g = torch.randn((3, c, 36, 50), device=device)
    g[:, :, :4] = 0.0
    d = scatter.scatter(x, y, g, 40, 56)
    torch.testing.assert_close(d, scatter.scatter_plain(x, y, g, 40, 56),
                               atol=1e-4 * d.abs().max().item(), rtol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_autograd_goes_through_the_kernels(device):
    """The full-gradient sampler's forward is S with d/dx, d/dy and its
    backward T; gradients equal the CPU path's."""
    rng = np.random.default_rng(3)
    img = rng.random((2, 24, 32, 1), dtype=np.float32)
    x, y = _coords(2, 20, 28, 4)
    coords = np.stack([x, y], -1)
    kernels.reset_launch_counts()
    grads = {}
    for dev in (device, torch.device("cpu")):
        ti = torch.tensor(img, device=dev, requires_grad=True)
        tc = torch.tensor(coords, device=dev, requires_grad=True)
        torch.sum(torch.cos(3 * kernels.bilinear_sample_full(ti, tc))).backward()
        grads[dev.type] = (ti.grad.cpu(), tc.grad.cpu())
    assert kernels.launch_counts() == {"S/grad/C1": 1, "T/C1": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_cannot_launch(device):
    src = torch.zeros((1, 1, 4, 4), device=device, dtype=torch.float64)
    x = torch.zeros((1, 4, 4), device=device)
    with pytest.raises(TypeError):
        sampler.sample(src, x, x, True)
    with pytest.raises(ValueError):
        sampler.sample(src.float(), x.transpose(1, 2), x, True)
    with pytest.raises(ValueError):
        sampler.sample(torch.zeros((1, 2, 4, 4), device=device).transpose(2, 3), x, x, True)
