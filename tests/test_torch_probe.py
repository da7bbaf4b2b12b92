"""The port's kernel probe on the CPU at a small size, and the plain
version of its corpus-stream floor.

The JAX tool's ``_dma_kernel`` (``tools/kernel_probe.py``) is a Pallas
kernel built inside the tool with no interpret flag, so it cannot run
here; ``corpus_stream_plain`` is held against a numpy statement of what it
computes (the running max over (tile_n // 8, 8, d) reshapes of each tile).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from rag_arc_tpu_torch.ops import corpus_stream as cs
from rag_arc_tpu_torch.tools import kernel_probe as kp

ALL_KINDS = [
    {"kind": "fused", "tile_n": 2048, "q_block": 256},
    {"kind": "fused", "tile_n": 1024, "skip_tiles": False, "packed": False},
    {"kind": "two_level", "tile_n": 2048, "g": 128},
    {"kind": "two_level", "tile_n": 2048, "g": 256},
    {"kind": "stream", "tile_n": 1024, "g": 16, "producer": "stream"},
    {"kind": "stream", "tile_n": 1024, "g": 16, "producer": "stream_piped"},
    {"kind": "stream", "tile_n": 1024, "g": 16, "producer": "scan"},
    {"kind": "i8", "tile_n": 1024},
    {"kind": "i8_stream", "tile_n": 1024, "producer": "stream_piped"},
    {"kind": "dma_only", "tile_n": 1024},
    {"kind": "dma_only", "tile_n": 1024, "dtype": "int8"},
    {"kind": "xla_scan", "tile_n": 1024},
    {"kind": "p1_stream", "tile_n": 1024},
    {"kind": "p1_stream", "tile_n": 1024, "pipelined": True},
    {"kind": "select_only", "tile_n": 1024},
]
EXACT = ("two_level", "stream")  # exact top-k of the bf16 corpus


def _run(configs):
    buf = io.StringIO()
    spec = ";".join(json.dumps(c) for c in configs)
    with contextlib.redirect_stdout(buf):
        rc = kp.main(["--n", "4096", "--d", "32", "--b", "8", "--reps", "2", "--stream",
                      "2", "--device", "cpu", "--configs", spec])
    return rc, buf.getvalue().splitlines()


def test_probe_runs_every_kind():
    assert {c["kind"] for c in ALL_KINDS} == set(kp.KINDS)
    rc, lines = _run(ALL_KINDS)
    assert rc == 0 and lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["cfg"] for r in rows] == ALL_KINDS
    for r in rows:
        assert "error" not in r, r
        assert len(r["ms_all"]) == 2 and r["ms_min"] <= r["ms_median"]
        assert r["qps_at_median"] > 0
        kind = r["cfg"]["kind"]
        if kind in kp.NO_RECALL:
            assert r["recall"] is None
        elif kind in EXACT or (kind == "fused" and not r["cfg"].get("packed", True)):
            assert r["recall"] == 1.0, r
        else:
            assert r["recall"] >= 0.9, r


def test_probe_default_configs_and_errors():
    assert kp.parse_configs("") == kp.DEFAULT_CONFIGS
    rc, lines = _run([{"kind": "argmax_only", "tile_n": 1024},
                      {"kind": "fused", "tile_n": 3000}])
    rows = [json.loads(line) for line in lines[1:]]
    assert rc == 0 and len(rows) == 2
    assert "unknown kind" in rows[0]["error"]
    assert "multiple" in rows[1]["error"]  # 4096 rows are not 3000-row tiles


def test_probe_producers_agree_and_oracle():
    data = kp.make_data(4096, 32, 8, 2, 10, 0, torch.device("cpu"), int8=False)
    assert data["emb"].shape == (4096, 32) and int(data["valid"].sum()) == 4096
    ids = [kp.probe({"kind": "stream", "tile_n": 1024, "g": 16, "producer": p}, data, 10,
                    1, torch.device("cpu"))[1][1] for p in ("stream", "stream_piped", "scan")]
    assert all(np.array_equal(ids[0], i) for i in ids[1:])
    # the oracle is the f32 top-10 of the first queries, over live rows
    q = data["batches"][0]
    assert data["exact"].shape == (8, 10)
    assert (data["exact"][:, 0] == torch.argmax(
        q @ data["emb"].float().T, dim=1).numpy()).mean() >= 0.75


def test_probe_pads_rows_dead():
    data = kp.make_data(5000, 16, 4, 1, 5, 1, torch.device("cpu"), int8=True)
    assert data["emb"].shape[0] == 8192 and int(data["valid"].sum()) == 5000
    assert bool((data["emb"][5000:] == 0).all()) and data["emb_i8"].dtype == torch.int8


def _numpy_dma(corpus, tile_n):
    """The JAX tool's _dma_kernel in numpy: out (8, d) starts at -3e38 and
    takes the max of each tile widened to f32 and reshaped to
    (tile_n // 8, 8, d)."""
    n, d = corpus.shape
    out = np.full((8, d), -3e38, np.float32)
    for i in range(n // tile_n):
        t = corpus[i * tile_n : (i + 1) * tile_n].astype(np.float32)
        out = np.maximum(out, t.reshape(tile_n // 8, 8, d).max(axis=0))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_corpus_stream_plain_matches_numpy_statement(dtype):
    rng = np.random.default_rng(2)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (4096, 48)).astype(np.int8))
    else:
        x = torch.from_numpy(rng.standard_normal((4096, 48)).astype(np.float32)).to(dtype)
    want = _numpy_dma(x.float().numpy(), 1024)
    got = cs.corpus_stream(x)
    np.testing.assert_array_equal(got.numpy(), want)
    # the library yardstick computes the same function in the storage type
    np.testing.assert_array_equal(torch.amax(x.view(-1, 8, 48), dim=0).float().numpy(),
                                  want)


def test_corpus_stream_ragged_rows_and_no_count():
    x = torch.randn(1003, 16)
    before = cs.launches
    got = cs.corpus_stream_plain(x)
    assert cs.launches == before
    rows = x.numpy()
    for j in range(8):
        np.testing.assert_array_equal(got[j].numpy(), rows[j::8].max(axis=0))
    with pytest.raises(ValueError, match="corpus"):
        cs.corpus_stream(torch.zeros(4, 4, 4))
