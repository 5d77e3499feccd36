"""The lock-discipline repairs that the concurrency lint asked of the port:
``warn_once``'s dedup set and the profiler's histogram extremes are guarded
by named ``core.locks`` locks (seen by the lock-order graph), an ``nvcc``
build waits at most its timeout and then raises (never falling back to the
plain version), and a point-to-point exchange under gloo waits at most
the process group's collective timeout and then raises the error the
elastic supervisor classifies as a lost rank (under NCCL only the stream
waits, and NCCL's watchdog bounds the exchange).
"""

import torch_threads  # noqa: F401  (first: its share of the cores)
import datetime
import os
import time

import pytest
import torch

from paddle_tpu_torch.core import locks
from paddle_tpu_torch.core import logging as ptlog
from paddle_tpu_torch.core import profiler as prof
from paddle_tpu_torch.ops.cuda import build
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.resilience.elastic import is_device_loss
from paddle_tpu_torch.resilience.faults import DeviceLostError


@pytest.fixture
def lock_check():
    locks.set_enabled(True)
    yield
    locks.set_enabled(None)


@pytest.mark.parametrize("module, attr, name, use", [
    (ptlog, "_warned_once_lock", "core.warn_once",
     lambda: ptlog.warn_once(("lock-repair-test", time.monotonic()), "lock repair test")),
    (prof, "_extremes_lock", "core.profiler_extremes",
     lambda: prof.observe("tests.lock_repair_seconds", 0.5)),
])
def test_core_locks_are_named_and_in_the_order_graph(lock_check, module, attr, name, use):
    lock = getattr(module, attr)
    assert isinstance(lock, locks.Lock) and lock.name == name
    with locks.Lock("tests.lock_repair_outer"):
        use()
    assert name in locks.graph_snapshot().get("tests.lock_repair_outer", {})


@pytest.fixture
def hung_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` that never exits, and a kernel not built yet."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\nexec sleep 600\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "hung.cu"
    source.write_text("// never compiled\n")
    kernel = build.CudaKernel("hung_test_kernel", str(source), "launch_hung", [])
    yield kernel
    build.KERNELS.pop("hung_test_kernel", None)


def test_nvcc_that_never_exits_raises_within_its_timeout(hung_nvcc, monkeypatch):
    monkeypatch.setattr(build, "BUILD_TIMEOUT_S", 1.5)
    running = hung_nvcc.start_build()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"hung_test_kernel .* did not finish within 1\.5 s"):
        running.finish()
    assert time.perf_counter() - t0 < 10
    assert running.proc.poll() is not None  # killed, not left running
    assert not running.tmp.exists() and not running.lib.exists()


def test_build_all_raises_and_leaves_no_nvcc(hung_nvcc, monkeypatch):
    monkeypatch.setattr(build, "KERNELS", {"hung_test_kernel": hung_nvcc})
    monkeypatch.setattr(build, "BUILD_TIMEOUT_S", 1.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not finish within 1 s"):
        build.build_all()
    assert time.perf_counter() - t0 < 10
    assert not any(p.suffix == ".tmp" for p in (build.BUILD_DIR).iterdir())


def test_launcher_build_raises_on_timeout_not_plain(hung_nvcc, monkeypatch):
    monkeypatch.setattr(build, "BUILD_TIMEOUT_S", 1.0)
    with pytest.raises(RuntimeError, match="did not finish within 1 s"):
        hung_nvcc.fn()
    assert hung_nvcc._fn is None and hung_nvcc.launches == 0


class _HungWork:
    """A point-to-point work handle whose peer never answers: it waits out
    the timeout it is given, as gloo's does, and refuses to park forever."""

    def __init__(self):
        self.timeouts = []

    def wait(self, timeout=None):
        assert timeout is not None, "an exchange waited with no timeout"
        self.timeouts.append(timeout)
        raise RuntimeError(f"[gloo/transport/tcp/unbound_buffer.cc:78] Timed out waiting "
                           f"{int(timeout.total_seconds() * 1000)}ms for recv operation to "
                           "complete")


class _Axis:
    index, ranks, group = 0, [0, 1], object()


def test_ppermute_timeout_raises_a_classified_loss(monkeypatch):
    work = _HungWork()
    monkeypatch.setattr(collective, "_route", lambda ax, x: "gloo")
    monkeypatch.setattr(collective.dist, "P2POp", lambda *a, **k: (a, k))
    monkeypatch.setattr(collective.dist, "batch_isend_irecv", lambda ops: [work])
    monkeypatch.setattr(mesh_mod, "collective_timeout_s", lambda: 2.5)
    with pytest.raises(DeviceLostError, match="within the collective timeout of 2.5 s") as err:
        collective._permuted(torch.ones(3), _Axis(), [(0, 1), (1, 0)])
    assert work.timeouts == [datetime.timedelta(seconds=2.5)]
    assert is_device_loss(err.value)


def test_other_exchange_errors_pass_through():
    class Broken:
        def wait(self, timeout=None):
            raise RuntimeError("Connection closed by peer [127.0.0.1]:1234")

    with pytest.raises(RuntimeError, match="Connection closed by peer") as err:
        collective._wait_all([Broken()], "gloo_host")
    assert not isinstance(err.value, DeviceLostError) and is_device_loss(err.value)


def test_nccl_exchange_waits_on_the_stream_not_the_host(monkeypatch):
    """Under NCCL a timed wait would block the host until the exchange
    ends; only the stream waits, and NCCL's watchdog bounds the exchange."""
    class StreamWork:
        synced = 0

        def wait(self, timeout=None):
            raise AssertionError("the host waited on an NCCL exchange")

        def synchronize(self):
            self.synced += 1

    work = StreamWork()
    monkeypatch.setattr(collective, "_route", lambda ax, x: "nccl")
    monkeypatch.setattr(collective.dist, "P2POp", lambda *a, **k: (a, k))
    monkeypatch.setattr(collective.dist, "batch_isend_irecv", lambda ops: [work])
    out = collective._permuted(torch.ones(3), _Axis(), [(0, 1), (1, 0)])
    assert work.synced == 1 and tuple(out.shape) == (3,)


def test_collective_timeout_is_the_groups(tmp_path):
    assert mesh_mod.collective_timeout_s() == mesh_mod._TIMEOUT_S
    mesh_mod.initialize_distributed(init_method=f"file://{tmp_path}/store", num_processes=1,
                                    process_id=0, device="cpu", timeout_s=7.0)
    try:
        assert mesh_mod.collective_timeout_s() == 7.0
    finally:
        mesh_mod.shutdown_distributed()
    assert mesh_mod.collective_timeout_s() == mesh_mod._TIMEOUT_S

