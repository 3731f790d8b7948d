"""The text anchors that checks on the card find in the CUDA sources.

The planted-fault checks (``chip_smoke.py`` and the ``cuda`` tests of
``tests/test_torch_kernels.py``) build a copy of a kernel source with one
line replaced, and the clock probes (``bench/flash_bwd_phases.py``,
``bench/flash_fwd_phases.py``) insert code around lines of the sources. A
line that moves or changes breaks them only on the card; these tests find
it here, on the CPU: every anchor occurs in its source exactly once.
"""

import importlib.util
import os

import pytest

from pytorch_distributed_training_example_tpu_torch.bench import (
    flash_bwd_phases, flash_fwd_phases)
from pytorch_distributed_training_example_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load("_chip_smoke_anchors", os.path.join(ROOT, "chip_smoke.py"))
KERNEL_TESTS = _load("_kernel_test_anchors", os.path.join(
    ROOT, "tests", "test_torch_kernels.py"))


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return f.read()


#: (where the fault is defined, its name, the source it edits).
PLANTED_FAULTS = [
    ("chip_smoke", "DROPPED_ROWS", "grouped_matmul"),
    ("chip_smoke", "DROPPED_SLICE", "grouped_matmul"),
    ("chip_smoke", "IGNORED_KV_LEN", "flash_fwd"),
    ("chip_smoke", "UNMASKED_DIAGONAL", "flash_fwd"),
    ("chip_smoke", "DROPPED_PARTIAL", "fused_bn_matmul"),
    ("kernel_tests", "IGNORED_KV_LEN", "flash_fwd"),
    ("kernel_tests", "UNMASKED_DIAGONAL", "flash_fwd"),
    ("kernel_tests", "_DROPPED_TILES:dq", "flash_bwd"),
    ("kernel_tests", "_DROPPED_TILES:dkv", "flash_bwd"),
    ("kernel_tests", "_DROPPED_ROWS", "grouped_matmul"),
    ("kernel_tests", "_DROPPED_SLICE", "grouped_matmul"),
    ("kernel_tests", "_DROPPED_PARTIAL", "fused_bn_matmul"),
]


def _fault(where: str, name: str):
    module = SMOKE if where == "chip_smoke" else KERNEL_TESTS
    attr, _, key = name.partition(":")
    value = getattr(module, attr)
    return value[key] if key else value


@pytest.mark.parametrize("where,name,source", PLANTED_FAULTS)
def test_planted_fault_anchor_occurs_once(where, name, source):
    old, new = _fault(where, name)
    src = _source(source)
    assert src.count(old) == 1, (where, name)
    assert src.replace(old, new) != src


def test_every_planted_fault_is_listed():
    """Each (line, replacement) pair the two files define is a case above,
    and a fault both define is the same edit in both."""
    listed = {(w, n.partition(":")[0]) for w, n, _ in PLANTED_FAULTS}
    for where, module in (("chip_smoke", SMOKE),
                          ("kernel_tests", KERNEL_TESTS)):
        for attr, value in vars(module).items():
            pairs = value.values() if isinstance(value, dict) else [value]
            if all(isinstance(p, tuple) and len(p) == 2
                   and all(isinstance(x, str) and x.endswith("\n")
                           for x in p) for p in pairs) and pairs:
                assert (where, attr) in listed, (where, attr)
    for attr in ("IGNORED_KV_LEN", "UNMASKED_DIAGONAL"):
        assert getattr(SMOKE, attr) == getattr(KERNEL_TESTS, attr)
    for attr in ("DROPPED_ROWS", "DROPPED_SLICE"):
        assert getattr(SMOKE, attr) == getattr(KERNEL_TESTS, "_" + attr)


@pytest.mark.parametrize("probe", range(len(flash_bwd_phases._PROBES)))
def test_flash_bwd_probe_anchor_occurs_once(probe):
    anchor = flash_bwd_phases._PROBES[probe][0]
    assert _source("flash_bwd").count(anchor) == 1


@pytest.mark.parametrize("probe", range(len(flash_fwd_phases._PROBES)))
def test_flash_fwd_probe_anchor_occurs_once(probe):
    anchor = flash_fwd_phases._PROBES[probe][0]
    assert _source("flash_fwd").count(anchor) == 1


def test_probed_sources_take_every_probe():
    """The whole probed copies come out with their counters and reader."""
    for module, name in ((flash_bwd_phases, "flash_bwd"),
                         (flash_fwd_phases, "flash_fwd")):
        probed = module.probed_source(_source(name))
        assert probed.count("__device__ unsigned long long g_probe[32];") == 1
        assert 'extern "C" int pdtx_probe(' in probed
