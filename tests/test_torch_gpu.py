"""Card-only tests of the port's CUDA kernels (bf16/f32 with its l2 mode,
and int8): each kernel against its plain PyTorch version at small shapes
(int8 bit for bit), the launch counts, and the wrappers' refusals. They skip where no CUDA card is present (the kernel has no CPU
mode); on a machine with a card run

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest imports JAX, which a card-only
machine need not have; this file imports only torch and numpy).
"""

import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
from rag_arc_tpu_torch.ops import subtile_max as sm
from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
from rag_arc_tpu_torch.ops.two_level import quantize_rows_blocked, two_level_topk
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


# -- l2 mode ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100)])
def test_l2_kernel_matches_plain(cuda, dtype, b, n, d):
    q, x, valid = _inputs(n, d, b, dtype, cuda)
    sq = (x.float() * x.float()).sum(1)
    before = sm.launches_l2
    got = sm.subtile_max(q, x, valid, 16, sqnorm=sq)
    torch.cuda.synchronize()
    assert sm.launches_l2 == before + 1
    torch.testing.assert_close(got, sm.subtile_max_plain(q, x, valid, 16, sqnorm=sq),
                               atol=1e-4, rtol=0)


def test_l2_two_level_matches_direct_on_card(cuda):
    q, x, valid = _inputs(8192, 64, 33, torch.bfloat16, cuda, seed=2)
    sq = (x.float() * x.float()).sum(1)
    s1, p1 = two_level_topk(q.float(), x, valid, 10, metric="l2", sqnorm=sq)
    s2, p2 = masked_topk(q.float(), x, valid, 10, "l2", sq)
    torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-5, rtol=0)


# -- int8 ---------------------------------------------------------------------------


def _i8_inputs(n, d, b, device, block=True, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    if block:
        scale = np.repeat(rng.uniform(1e-3, 1e-2, n // 32), 32).astype(np.float32)
    else:
        scale = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    valid = rng.random(n) > 0.03
    codes[~valid] = 0
    q = rng.integers(-127, 128, (b, d), dtype=np.int8)
    return tuple(torch.from_numpy(a).to(device) for a in (q, codes, scale, valid))


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("b", [1, 7, 17, 130])
@pytest.mark.parametrize("n,d", [(4096, 64), (1056, 100), (2048, 1040)])
@pytest.mark.parametrize("g", [16, 32])
def test_i8_kernel_equals_plain(cuda, block, b, n, d, g):
    q, codes, scale, valid = _i8_inputs(n, d, b, cuda, block)
    got = smi8.subtile_max_i8(q, codes, scale, valid, g, block_scales=block)
    torch.cuda.synchronize()
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, g, block_scales=block)
    torch.testing.assert_close(got, want, atol=0, rtol=0)  # every step is exact


@pytest.mark.parametrize("offset", [1, 5, 16])
def test_i8_kernel_on_offset_views(cuda, offset):
    q, codes, scale, valid = _i8_inputs(1024, 64, 5, cuda)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    cv = torch.cat([codes.new_zeros(offset), codes.flatten()])[offset:].view(codes.shape)
    got = smi8.subtile_max_i8(qv, cv, scale, valid, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, smi8.subtile_max_i8_plain(q, codes, scale, valid, 16),
                               atol=0, rtol=0)


def test_i8_all_dead_subtile_and_launch_count(cuda):
    q, codes, scale, valid = _i8_inputs(1024, 64, 4, cuda)
    valid[32:48] = False
    before = smi8.launches
    got = smi8.subtile_max_i8(q, codes, scale, valid, 16)
    smi8.subtile_max_i8_plain(q, codes, scale, valid, 16)
    assert smi8.launches == before + 1
    assert (got[:, 2] == smi8.NEG).all()


def test_i8_wrapper_refuses(cuda):
    q, codes, scale, valid = _i8_inputs(1024, 64, 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        smi8.subtile_max_i8(q.T.contiguous().T, codes, scale, valid, 16)
    with pytest.raises(ValueError, match="1040"):
        big = torch.zeros((1024, 1056), dtype=torch.int8, device=cuda)
        smi8.subtile_max_i8(torch.zeros((4, 1056), dtype=torch.int8, device=cuda),
                            big, scale, valid, 16)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_i8_index_on_card_matches_cpu(cuda, metric):
    # every int8 search on the card takes the kernel path; its ids equal
    # the CPU index's direct path (exact under the quantized metric)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((5000, 64)).astype(np.float32)
    q = v[:9] + 0.05 * rng.standard_normal((9, 64)).astype(np.float32)
    idx = {dev: DeviceFlatIndex(dim=64, metric=metric, capacity=8192, dtype=torch.int8,
                                device=dev) for dev in ("cpu", cuda)}
    for index in idx.values():
        index.add(v)
        index.mark_deleted(np.arange(50, 90))
    before = smi8.launches
    s_gpu, p_gpu = idx[cuda].search(q, 10)
    assert smi8.launches == before + 1
    s_cpu, p_cpu = idx["cpu"].search(q, 10)
    np.testing.assert_array_equal(p_gpu, p_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)


def test_i8_blocked_codes_on_card(cuda):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 64)).astype(np.float32)
    codes, scale = quantize_rows_blocked(x, 32)
    q = torch.from_numpy(rng.integers(-127, 128, (33, 64), dtype=np.int8)).to(cuda)
    args = (q, torch.from_numpy(codes).to(cuda), torch.from_numpy(scale).to(cuda),
            torch.ones(2048, dtype=torch.bool, device=cuda), 16)
    torch.testing.assert_close(smi8.subtile_max_i8(*args), smi8.subtile_max_i8_plain(*args),
                               atol=0, rtol=0)
