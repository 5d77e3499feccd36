"""The port's roofline ledger (``paddle_tpu_torch.observability.roofline``)
against the JAX package's (``paddle_tpu.observability.roofline``), and its
PyTorch capture.

The same (FLOPs, bytes, measured seconds, peaks) give the same snapshot
rows — intensity, predicted time, achieved rates, overhead fraction and
verdict — exactly, and the same shape buckets and keys. Then the port's
own design: an instrumented callable's first call is counted (the FLOPs
of its products, the bytes its ops move) and later calls timed; the
Executor feeds the ledger; the decode engine's step and prefill land as
rows with a verdict; and the H100 rows of the peak tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.observability import mfu as jmfu
from paddle_tpu.observability import roofline as jroof
from paddle_tpu.tune import search as jsearch
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.observability import mfu as tmfu
from paddle_tpu_torch.observability import roofline as troof

PEAK_F, PEAK_B = 1e12, 1e11


@pytest.fixture(autouse=True)
def _clean():
    for roof, mfu in ((jroof, jmfu), (troof, tmfu)):
        roof.reset_ledger()
        mfu.set_peak_flops(PEAK_F)
        mfu.set_peak_hbm_bw(PEAK_B)
    yield
    for roof, mfu in ((jroof, jmfu), (troof, tmfu)):
        roof.reset_ledger()
        mfu.set_peak_flops(None)
        mfu.set_peak_hbm_bw(None)


# (key, flops, bytes, measured seconds): compute-, memory- and
# overhead-bound, never timed, and a byte-less entry
ENTRIES = [
    ("gemm|q1024|bfloat16|dev", 4e9, 1e6, [4.1e-3, 4.0e-3, 4.3e-3]),
    ("copy|q4096|float32|dev", 1e3, 2e8, [2.0e-3, 2.1e-3]),
    ("step|q128|float32|dev", 1e6, 1e5, [5e-3, 7e-3]),
    ("cold|q256|float32|dev", 2e9, 1e3, []),
    ("nobytes|q128|-|dev", 5e5, 0, [1e-3]),
]


def _fill(roof):
    for key, flops, nbytes, walls in ENTRIES:
        roof.note_compile(key, flops=flops, bytes_accessed=nbytes, arg_bytes=64, out_bytes=32)
        for w in walls:
            roof.observe_call(key, w)


def test_same_costs_give_same_rows_and_verdicts():
    _fill(jroof)
    _fill(troof)
    j, t = jroof.snapshot(), troof.snapshot()
    assert t == j
    verdicts = {r["kernel"]: r["verdict"] for r in t}
    assert verdicts == {"gemm": "compute_bound", "copy": "memory_bound",
                        "step": "overhead_bound", "cold": "compute_bound",
                        "nobytes": "overhead_bound"}
    assert troof.summary() == jroof.summary()
    assert [h[1:] for h in troof.history()] == [h[1:] for h in jroof.history()]


@pytest.mark.parametrize("flops, nbytes", [(1e9, 1e6), (1e3, 1e9), (0.0, 5e7)])
def test_predicted_seconds_match(flops, nbytes):
    assert troof.predicted_seconds(flops, nbytes, kind="dev") == \
        jroof.predicted_seconds(flops, nbytes, kind="dev")


@pytest.mark.parametrize("t_q, t_kv", [(1, None), (128, None), (129, None), (1000, 1000),
                                       (1024, 2048), (8192, 100), (32000, None)])
def test_shape_buckets_match_tune_search(t_q, t_kv):
    assert troof.shape_bucket(t_q, t_kv) == jsearch.shape_bucket(t_q, t_kv)


def test_call_keys_match():
    shapes = [((8, 1024), np.float32), ((8, 1024, 32000), np.float32), ((3,), np.int32)]
    jargs = tuple(jnp.zeros(s, d) for s, d in shapes)
    targs = tuple(torch.zeros(s, dtype=torch.from_numpy(np.zeros(1, d)).dtype) for s, d in shapes)
    assert troof.call_key("k", targs, kind="dev") == jroof.call_key("k", jargs, kind="dev") \
        == "k|q32768|float32|dev"


def test_instrument_counts_the_first_call_then_times():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    f = troof.instrument("mm", fn)
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    for _ in range(3):
        f(a, b)
    assert len(calls) == 3
    (row,) = troof.snapshot()
    assert row["flops"] == 2 * 64 * 32 * 16
    assert row["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4 and row["bytes_source"] == "counted"
    assert row["calls"] == 2 and row["verdict"] in ("compute_bound", "memory_bound",
                                                    "overhead_bound")
    assert row["peak_hbm_bytes"] is None  # "auto" captures no peak on the CPU


def test_instrument_off_under_the_flag():
    tconfig.set_flags(roofline=False)
    try:
        troof.instrument("off", lambda x: x + 1)(torch.ones(2))
        assert troof.snapshot() == []
    finally:
        tconfig.set_flags(roofline=True)


def test_executor_feeds_the_ledger():
    exe = Executor("cpu")

    def proj(x, w):
        return x @ w

    x, w = torch.ones(4, 8), torch.ones(8, 2)
    for _ in range(2):
        exe.run(proj, x, w)
    (row,) = [r for r in troof.snapshot() if r["kernel"] == "proj"]
    assert row["flops"] == 2 * 4 * 8 * 2 and row["calls"] == 1


def test_memory_capture_policy():
    assert troof.memory_capture_enabled("cuda") and not troof.memory_capture_enabled("cpu")
    for value, want in (("on", True), ("off", False)):
        tconfig.set_flags(roofline_memory=value)
        try:
            assert troof.memory_capture_enabled("cpu") is want
        finally:
            tconfig.set_flags(roofline_memory="auto")


@pytest.mark.parametrize("name, flops, bw", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12),
    ("NVIDIA_H100_80GB_HBM3", 989.4e12, 3.35e12),
    ("cpu", 5e10, 50e9),
    ("NVIDIA A100-SXM4-80GB", None, None),
])
def test_peak_tables(name, flops, bw):
    tmfu.set_peak_flops(None)
    tmfu.set_peak_hbm_bw(None)
    assert tmfu.peak_flops_for_kind(name.replace("_", " ")) == flops
    assert tmfu.peak_hbm_bw_for_kind(name.replace("_", " ")) == bw


def test_peak_override_order():
    tmfu.set_peak_flops(None)
    tconfig.set_flags(peak_flops=7e12)
    try:
        assert tmfu.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 7e12
        tmfu.set_peak_flops(3e12)
        assert tmfu.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 3e12
    finally:
        tconfig.set_flags(peak_flops=0.0)


def test_mfu_matches():
    for args in ((1e12, 0.5, 1, 989.4e12), (3e9, 0.01, 2, 5e10), (0.0, 1.0, 1, 1e12)):
        assert tmfu.mfu(*args) == jmfu.mfu(*args)


def test_decode_engine_rows():
    """The engine's step and prefill (tiny LM on the CPU) land in the
    ledger with counted FLOPs and bytes and a verdict."""
    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    spec = tmodels.get_model("transformer_lm", device="cpu", seq_len=64, vocab=97, d_model=32,
                             d_inner=64, num_heads=4, n_layers=2)
    ids = torch.randint(1, 97, (2, 64), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    params = spec.model.init(0, ids, ids, device="cpu").params
    eng = DecodeEngine(params, spec.extra["cfg"], device="cpu",
                       decode=DecodeConfig(max_slots=2, page_size=4, max_context=32,
                                           prefill_chunk=8))
    try:
        out = eng.submit(np.arange(1, 12, dtype=np.int32), 6).result(timeout=60)
    finally:
        eng.close(timeout=30)
    assert len(out.tokens) == 6
    rows = {r["kernel"]: r for r in troof.snapshot()}
    for kernel in ("serving.decode.step", "serving.decode.prefill"):
        assert rows[kernel]["flops"] > 0 and rows[kernel]["bytes"] > 0, kernel
        assert rows[kernel]["calls"] >= 1 and rows[kernel]["verdict"], kernel
