"""Card-only tests of the port's CUDA kernel: the kernel against its plain
PyTorch version at small shapes, the launch count, and the wrapper's
refusals. They skip where no CUDA card is present (the kernel has no CPU
mode); on a machine with a card run

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest imports JAX, which a card-only
machine need not have; this file imports only torch and numpy).
"""

import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.ops import subtile_max as sm
from rag_arc_tpu_torch.ops.two_level import two_level_topk
from rag_arc_tpu_torch.ops.topk import masked_topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, d, b, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) > 0.03
    x[~valid] = 0.0
    return (
        torch.from_numpy(q).to(device, dtype),
        torch.from_numpy(x).to(device, dtype),
        torch.from_numpy(valid).to(device),
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 7, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100)])  # ragged rows and d
@pytest.mark.parametrize("g", [16, 32])
def test_kernel_matches_plain(cuda, dtype, b, n, d, g):
    q, x, valid = _inputs(n, d, b, dtype, cuda)
    got = sm.subtile_max(q, x, valid, g)
    torch.cuda.synchronize()
    want = sm.subtile_max_plain(q, x, valid, g)
    # bf16 products are exact in f32; only the summation order differs
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_kernel_on_offset_views(cuda, offset):
    # contiguous views whose data starts `offset` elements into their
    # storage: off a 16-byte boundary unless offset % 8 == 0
    q, x, valid = _inputs(1024, 64, 5, torch.bfloat16, cuda)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    assert qv.is_contiguous() and xv.is_contiguous()
    assert qv.storage_offset() == xv.storage_offset() == offset
    got = sm.subtile_max(qv, xv, valid, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16), atol=1e-4, rtol=0)


def test_all_dead_subtile_is_neg(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    valid[32:48] = False
    got = sm.subtile_max(q, x, valid, 16)
    assert (got[:, 2] == sm.NEG).all()


def test_launch_count(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    before = sm.launches
    sm.subtile_max(q, x, valid, 16)
    sm.subtile_max_plain(q, x, valid, 16)
    assert sm.launches == before + 1


def test_wrapper_refuses(cuda):
    q, x, valid = _inputs(1024, 64, 4, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sm.subtile_max(q.T.contiguous().T, x, valid, 16)
    with pytest.raises(ValueError, match="differ"):
        sm.subtile_max(q.float(), x, valid, 16)
    with pytest.raises(ValueError, match="g must be"):
        sm.subtile_max(q, x, valid, 48)
    with pytest.raises(ValueError, match="f32 or bf16"):
        sm.subtile_max(q.half(), x.half(), valid, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_level_matches_direct_on_card(cuda, dtype):
    q, x, valid = _inputs(8192, 64, 33, dtype, cuda, seed=1)
    s1, p1 = two_level_topk(q.float(), x, valid, 10)
    s2, p2 = masked_topk(q.float(), x, valid, 10)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)
