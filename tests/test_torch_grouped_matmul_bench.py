"""The grouped-matmul bench's routings, bounds and guard, on the CPU.

The bench itself times K4a and K4b on the card
(``bench/grouped_matmul_bench.py``); here its inputs are held to what it
says it measures: the llama_moe shapes, routings that tile all kT rows
(the skewed one the same as ``chip_smoke.py``'s check), and the card's
least time for each case.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_training_example_tpu_torch.bench import (
    grouped_matmul_bench as bench)


@pytest.mark.parametrize("name", bench.ROUTINGS)
def test_routings_tile_every_row(name):
    counts = bench.routing_counts(name)
    assert counts.dtype == np.int32 and counts.shape == (bench.E,)
    assert counts.sum() == bench.TK and (counts >= 0).all()


def test_routings_are_the_checks_and_the_training_steps():
    skewed = bench.routing_counts("skewed")
    # chip_smoke.py's moe_segments: expert 0 empty, expert 1 ends mid-tile
    # (8232 = 64 x 128 + 40) and is heavy enough for dw to split.
    assert skewed[0] == 0 and skewed[1] == 8232 and (skewed[2:] > 0).all()
    assert (bench.routing_counts("balanced") == bench.TK // bench.E).all()
    one = bench.routing_counts("one_expert")
    assert one[1] == bench.TK and one.sum() == one[1]
    with pytest.raises(ValueError, match="unknown routing"):
        bench.routing_counts("uniform")


def test_bounds_are_the_tensor_cores_at_the_moe_shapes():
    # 2 kT d f flops over 989 TF/s; the bytes (~0.1 GB) take a third of it.
    flops = 2.0 * bench.TK * bench.D * bench.F
    assert bench.bound_ms(1e8, flops) == pytest.approx(0.0694838, rel=1e-5)
    assert bench.bound_ms(1e9, 1.0) == pytest.approx(1e9 / 3.35e12 * 1e3)
    assert [c[0] for c in bench.GMM_CASES] == ["up", "down", "dx_up",
                                              "dx_down"]
    assert [c[0] for c in bench.DW_CASES] == ["up", "down"]


def test_bench_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        bench.main([])
