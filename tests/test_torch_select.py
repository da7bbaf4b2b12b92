"""The sub-tile select on the CPU (``ops/subtile_select.py``): the plain
tournament, and the dispatching ``iterative_argmax_resid`` on CPU
tensors, against the JAX package's ``iterative_argmax_resid``; the
wrapper's refusals; and the int8 producer's TMA operand copy, which must
leave the plain version's result bit-equal. The kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_arc_tpu.ops import two_level as jtl
from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
from rag_arc_tpu_torch.ops import subtile_select as ss
from rag_arc_tpu_torch.ops import two_level as ttl
from rag_arc_tpu_torch.ops.subtile_max import tma_operands

NEG = np.float32(jtl.NEG)


def _slab(c: int, k: int, seed: int) -> np.ndarray:
    """(6, C) f32 rows of sub-tile maxima, one pattern each: random with
    ~3% dead entries; more ties at the k-th value than slots; -0.0 beside
    +0.0 around the k-th; all NEG; half NEG; three live entries."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 0.9, (6, c)).astype(np.float32)
    x[0, rng.random(c) < 0.03] = NEG
    x[1] = rng.uniform(-0.5, 0.4, c)
    x[1, rng.choice(c, min(c, 3 * k + 2), replace=False)] = 0.5
    x[1, rng.choice(c, k // 2, replace=False)] = 0.75
    x[2] = rng.uniform(-1.0, -0.1, c)
    zeros = rng.choice(c, min(c, 2 * k + 4), replace=False)
    x[2, zeros] = np.where(np.arange(len(zeros)) % 2, np.float32(-0.0), np.float32(0.0))
    x[2, rng.choice(c, k // 3, replace=False)] = 0.25
    x[3] = NEG
    x[4, : c // 2] = NEG
    x[5] = NEG
    x[5, rng.choice(c, 3, replace=False)] = rng.uniform(0.1, 0.9, 3)
    return x


def _assert_same_live(got, want):
    """Live picks, flags and residuals equal, tolerance 0."""
    gi, gl, gr = (np.asarray(t) for t in got)
    wi, wl, wr = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(np.where(wl, gi, -1), np.where(wl, wi, -1))
    np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("c, k", [
    (1000, 1), (1000, 10), (1000, 20), (1000, 100), (1000, 1000),  # C off every chunk width
    (4096, 1), (4096, 10), (4096, 20), (4096, 100),                # C a multiple of 512
    (1337, 20), (1337, 1337), (300, 100), (7, 7),                  # padded, k == C
])
def test_plain_select_matches_jax(c, k):
    x = _slab(c, k, seed=c + k)
    want = jtl.iterative_argmax_resid(jnp.asarray(x), k)
    plain = ss.iterative_argmax_resid_plain(torch.from_numpy(x), k)
    _assert_same_live(plain, want)
    before = ss.launches
    dispatched = ttl.iterative_argmax_resid(torch.from_numpy(x), k)  # CPU: the plain version
    assert ss.launches == before
    _assert_same_live(dispatched, want)
    for a, b in zip(dispatched, plain):
        assert torch.equal(a, b)


def test_ties_and_signed_zeros_break_toward_the_lower_index():
    x = np.full((2, 300), -1.0, dtype=np.float32)
    x[0, [250, 40, 41, 7]] = 0.5        # four ties for two slots
    x[1, [90, 12]] = np.float32(-0.0)   # -0.0 and +0.0 are one value
    x[1, [60, 30]] = np.float32(0.0)
    picked, live, resid = ss.iterative_argmax_resid(torch.from_numpy(x), 2)
    assert picked.tolist() == [[7, 40], [12, 30]]
    assert live.all()
    assert resid.tolist() == [0.5, 0.0]


@pytest.mark.parametrize("bad, k, match", [
    (np.zeros(10, np.float32), 1, "matrix"),
    (np.zeros((2, 3, 4), np.float32), 1, "matrix"),
    (np.zeros((2, 10), np.float64), 1, "float32"),
    (np.zeros((2, 10), np.float32), 0, "k must"),
    (np.zeros((2, 10), np.float32), 11, "k must"),
])
def test_select_refuses(bad, k, match):
    with pytest.raises(ValueError, match=match):
        ss.iterative_argmax_resid(torch.from_numpy(bad), k)


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("offset", [1, 16])
def test_i8_operand_copy_leaves_plain_result_bit_equal(block, offset):
    """d = 100 and a view ``offset`` bytes into its storage: the copy the
    int8 wrapper hands the kernel (aligned, zero-padded to 112 columns)
    gives the plain version the same result, bit for bit."""
    rng = np.random.default_rng(offset)
    n, d, b = 1024, 100, 9
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 128, (b, d), dtype=np.int8))
    scale = torch.from_numpy(np.repeat(rng.uniform(1e-3, 1e-2, n // 32), 32).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.05)
    cv = torch.cat([codes.new_zeros(offset), codes.flatten()])[offset:].view(codes.shape)
    qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
    qa, ca = tma_operands(qv, cv)
    assert ca.shape == (n, 112) and qa.shape == (b, 112)
    assert ca.data_ptr() % 16 == 0 and qa.data_ptr() % 16 == 0
    assert not ca[:, d:].any() and not qa[:, d:].any()
    got = smi8.subtile_max_i8_plain(qa, ca, scale, valid, 16, block)
    want = smi8.subtile_max_i8_plain(q, codes, scale, valid, 16, block)
    assert torch.equal(got, want)
