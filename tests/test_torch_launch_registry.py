"""The kernels' launch registry and integer scratch (`kernels._build`),
and the launcher's streamed connectivity on the CPU (no launch counted).

Every wrapper counts its launches in one registry (`_build.counted`), and
takes its zeroed integer scratch from `_build.scratch`: the innermost
`own_scratch` scope on the launch's device (a captured CUDA graph's own,
`core.engine.CapturedRun`), else one shared Scratch a device.  Both are
plain host bookkeeping, so they run here on CPU tensors; the card tests
(`tests/test_torch_cuda.py::test_graph_keeps_its_scratch`,
`::test_graph_run_equals_eager_run_and_cpu`) hold the captured runs to
them.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, ops

KERNELS_DIR = Path(ops.__file__).resolve().parent


def test_launch_counts_read_the_one_registry():
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    for i, name in enumerate(ops.KERNELS):
        for _ in range(i + 1):
            _build.counted(name)
    assert ops.launch_counts() == {k: i + 1
                                   for i, k in enumerate(ops.KERNELS)}
    assert not _build.recorded          # nothing is being captured here
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_every_kernel_has_a_counting_wrapper():
    """Each name of `ops.KERNELS` is counted by a wrapper module, by a
    literal `_build.counted("name")` or a `name = "name"` it passes."""
    names = set()
    for path in KERNELS_DIR.glob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r'_build\.counted\("(\w+)"\)', text))
        if "_build.counted(name)" in text:
            names |= set(re.findall(r'^    name = "(\w+)"$', text, re.M))
    assert set(ops.KERNELS) <= names


def test_scratch_owned_scope_and_shared():
    shared = _build.scratch("cpu", "test_fill", 8)
    assert shared.dtype == torch.int32 and shared.numel() >= 8
    assert _build.scratch("cpu", "test_fill", 4) is shared
    own = _build.Scratch("cpu")
    with _build.own_scratch(own) as s:
        assert s is own
        mine = _build.scratch("cpu", "test_fill", 8)
        assert mine is own.buffers["test_fill"] and mine is not shared
        inner = _build.Scratch("cpu")
        with _build.own_scratch(inner):
            assert _build.scratch("cpu", "test_fill", 8) is not mine
        assert _build.scratch("cpu", "test_fill", 8) is mine
    # the scope is left: the shared buffer again
    assert _build.scratch("cpu", "test_fill", 8) is shared


def test_scratch_of_another_device_is_not_taken():
    own = _build.Scratch("meta")
    with _build.own_scratch(own):
        buf = _build.scratch("cpu", "test_other", 3)
    assert "test_other" not in own.buffers
    assert buf.device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scratch_grows_zeroed(dtype):
    own = _build.Scratch("cpu")
    small = own.get("counts", 2, dtype)
    small.fill_(7)
    assert own.get("counts", 2, dtype) is small
    big = own.get("counts", 5, dtype)
    assert big is not small and big.dtype == dtype
    assert big.numel() == 5 and not big.any()


def test_launcher_runs_streamed_on_cpu(capsys):
    """`--connectivity-mode streamed:chunk=2` runs a few steps on the CPU,
    through the plain versions (no kernel launch counted), with the rate
    and weights of the materialized run."""
    from repro_torch.launch import snn
    argv = ["--grid", "2x2", "--neurons-per-column", "60", "--synapses",
            "16", "--steps", "12", "--shards", "2", "--device", "cpu"]
    ops.reset_launch_counts()
    rate = snn.main(argv + ["--connectivity-mode", "streamed:chunk=2"])
    out = capsys.readouterr().out
    assert "streamed:chunk=2 connectivity" in out
    assert "[snn] streamed: 1 chunks of 2 column(s) a shard" in out
    assert "done at t=12 ms" in out
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert rate == snn.main(argv) > 0
