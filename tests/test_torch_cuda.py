"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture, which skips where
there is no card. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance atol 1e-5 (the kernel repeats the plain version's f32 arithmetic
in the same order; it has measured bit-equal on an H100).
"""

import numpy as np
import pytest
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.infer import build_models, coupled_forward
from tcsfm_torch.ops import grid_sample as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(shape, seed, device):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    img = rng.rand(b, h, w, c).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (b, h, w, 2)).astype(np.float32)
    coords[rng.rand(b, h, w) < 0.05] = 2.0          # the pushed-OOB rule
    return (torch.from_numpy(img).to(device),
            torch.from_numpy(coords).to(device))


@pytest.mark.parametrize("shape", [(2, 31, 45, 1), (2, 32, 64, 3),
                                   (3, 17, 23, 4), (1, 8, 9, 7),
                                   (24, 192, 640, 3), (24, 192, 640, 4)])
def test_kernel_matches_plain(cuda, shape):
    img, coords = _inputs(shape, 0, cuda)
    before = gs.LAUNCHES
    out = gs.grid_sample(img, coords)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + 1
    ref = gs.grid_sample_plain(img, coords)
    assert out.shape == img.shape
    assert (out - ref).abs().max().item() <= 1e-5


def test_kernel_refuses_grad(cuda):
    img, coords = _inputs((1, 8, 8, 3), 1, cuda)
    img.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        gs.grid_sample(img, coords)


def test_coupled_forward_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(iterations=4)
    depth_net, pose_net = build_models(cfg,
                                       generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    tgt = rng.rand(2, 64, 96, 3).astype(np.float32)
    src = rng.rand(2, 2, 64, 96, 3).astype(np.float32)
    K = np.broadcast_to(np.array([[57.6, 0, 48], [0, 57.6, 25.6], [0, 0, 1]],
                                 np.float32), (2, 3, 3)).copy()
    before = gs.LAUNCHES
    out = coupled_forward(depth_net, pose_net, tgt, src, K, cfg)
    torch.cuda.synchronize()
    assert gs.LAUNCHES - before == cfg.iterations - 1
    plain = coupled_forward(depth_net, pose_net, tgt, src, K, cfg,
                            sampler=gs.grid_sample_plain)
    for a, b in zip(out, plain):
        assert a.is_cuda and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5
