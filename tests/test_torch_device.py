"""Where the port builds and launches, on the CPU: `core.device.resolve`
gives the current CUDA card, every kernel launch goes through
`ops.cuda.launch`, which makes the operands' device current and refuses
operands on two devices, the scatter-add's card test holds the plain
version to a float64 sum, and `device_fields` names no card on the CPU.

Imports no JAX. `torch.cuda` is patched where a card would be needed.

The port's tests size torch's threads to the run (`torch_port_helpers`):
held here too.
"""
import inspect
import os
from contextlib import contextmanager
from types import SimpleNamespace

import pytest
import torch

import test_torch_kernels as tk
from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core import device as core_device
from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.ops import intersect as oi
from mafrixraytracing_torch.ops import unpack as ou
from torch_port_helpers import run_threads, worker_threads


def test_each_worker_takes_its_share_of_the_cpus():
    assert worker_threads(8, 6) == 1
    assert worker_threads(8, 1) == 8
    assert worker_threads(1, 6) == 1
    assert worker_threads(8, 3) == 2
    want = worker_threads(os.cpu_count() or 1,
                          int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    assert run_threads() == want
    assert torch.get_num_threads() == want
    # the processes a test starts inherit the count
    assert os.environ["OMP_NUM_THREADS"] == str(want)


def test_resolve_none_is_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve(None) == torch.device("cuda", 1)
    assert resolve() == torch.device("cuda", 1)
    assert resolve("cpu") == torch.device("cpu")
    assert resolve("cuda:3") == torch.device("cuda", 3)


def test_resolve_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    assert resolve("cpu") == torch.device("cpu")


def test_device_fields_on_the_cpu(monkeypatch):
    """A record made on the CPU names no card; `device_info` reads
    nvidia-smi's line, and without nvidia-smi falls back to torch's name."""
    cpu = {"device": "cpu", "power_limit": "not measured"}
    assert core_device.device_fields("cpu") == cpu
    assert core_device.device_fields(torch.device("cpu")) == cpu
    line = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(core_device.subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=line + "\n"))
    assert core_device.device_info() == {"name": "NVIDIA H100 80GB HBM3",
                                         "power_limit": "700.00 W", "nvidia_smi": line}

    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(core_device.subprocess, "run", no_smi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    assert core_device.device_info() == {"name": "a card", "power_limit": "not measured",
                                         "nvidia_smi": None}


class FakeLib:
    """Stands for the kernel library: records each call of an entry point
    and returns `err`."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mfx_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.err


@pytest.fixture
def fake_card(monkeypatch):
    """A fake library and `torch.cuda.device` / `current_stream` that record
    the device they are given; -> (library, devices entered, streams asked)."""
    lib = FakeLib()
    entered, streams = [], []

    @contextmanager
    def device(d):
        entered.append(d)
        yield

    def current_stream(d=None):
        streams.append(d)
        return SimpleNamespace(cuda_stream=4321)

    monkeypatch.setattr(cuda, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return lib, entered, streams


def test_launch_enters_the_operands_device(fake_card):
    lib, entered, streams = fake_card
    a, b, out = torch.zeros(4), torch.zeros(2, dtype=torch.int64), torch.empty(3)
    before = cuda.LAUNCHES["unpack"]
    cuda.launch("unpack", a, b, 7, 2, out)
    assert entered == [a.device] and streams == [a.device]
    assert lib.calls == [("mfx_unpack", (a.data_ptr(), b.data_ptr(), 7, 2,
                                         out.data_ptr(), 4321))]
    assert cuda.LAUNCHES["unpack"] == before + 1


def test_launch_raises_on_a_failed_launch_and_does_not_count(fake_card):
    lib, _, _ = fake_card
    lib.err = 700
    before = cuda.LAUNCHES["closest"]
    with pytest.raises(RuntimeError, match="closest failed to launch: error 700"):
        cuda.launch("closest", torch.zeros(1), 3)
    assert cuda.LAUNCHES["closest"] == before


def test_device_check_refuses_operands_on_two_devices(fake_card):
    lib, entered, _ = fake_card
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert cuda.same_device(cpu, torch.ones(3)) == torch.device("cpu")
    assert cuda.same_device(meta) == torch.device("meta")
    with pytest.raises(ValueError, match="different devices: cpu, meta"):
        cuda.same_device(cpu, meta)
    with pytest.raises(ValueError, match="different devices"):
        cuda.launch("cull", cpu, 5, meta)
    assert lib.calls == [] and entered == []


def test_every_wrapper_launches_through_the_helper():
    """No wrapper calls the library itself: each kernel of LAUNCHES has one
    `cuda.launch` call in ops/intersect.py, ops/unpack.py or core/rng.py."""
    src = inspect.getsource(oi) + inspect.getsource(ou) + inspect.getsource(rng)
    assert "lib()" not in src and "stream_of" not in src
    names = sorted(n for n in cuda.LAUNCHES if f'cuda.launch("{n}"' in src)
    assert names == sorted(cuda.LAUNCHES)
    assert src.count("cuda.launch(") == len(cuda.LAUNCHES)


def test_scatter_card_test_keeps_its_cases():
    fn = tk.test_scatter_kernel_matches_plain_version
    marks = {m.name: m for m in fn.pytestmark if m.name != "parametrize"}
    sizes = [len(m.args[1]) for m in fn.pytestmark if m.name == "parametrize"]
    assert "cuda" in marks and sizes == [7, 4]     # 28 cases
    src = inspect.getsource(fn)
    assert "assert_close" not in src and "scatter_rows_ordered_reference" in src


@pytest.mark.parametrize("cols", [1, 3, 16, 36])
@pytest.mark.parametrize("name", ["few_rows", "many_rows", "one_row", "tiny", "runs",
                                  "one_row_wavefront", "light_rows"])
def test_scatter_plain_version_within_float64_bound(name, cols):
    """The bound that the card test now holds the plain version to, on the
    CPU's `index_add_` for the same 28 inputs."""
    ct, idx, P = tk.scatter_case(name, cols, "cpu")
    oracle, tol = tk.float64_sum(ct, idx, P)
    plain = ou.scatter_rows_reference(ct, idx, P)
    assert bool(((plain.double() - oracle).abs() <= tol).all())
