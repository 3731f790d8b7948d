"""The ResNet FLOPs table against a count of the port's own models.

``models/resnet.py``'s ``flops_per_image`` keeps the JAX package's table of
published figures (ResNet-50 4.09e9 at 224 x 224), which the MFU of both
packages is computed from. ``torch.utils.flop_counter.FlopCounterMode``
counts two flops a multiply-add over the convolutions and the head of one
forward; the count is twice the table's, so the table counts multiply-adds
(and an MFU on it is half the two-flop one). CPU only, one image, eval
mode.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pytorch_distributed_training_example_tpu_torch.models import registry
from pytorch_distributed_training_example_tpu_torch.models import resnet


@pytest.mark.parametrize("name", ["resnet50", "resnet18"])
def test_resnet_table_counts_multiply_adds(name):
    model = registry.create_model(name, dtype=torch.float32, device="cpu",
                                  seed=0).eval()
    image = torch.zeros(1, 224, 224, 3)  # NHWC, as the loader gives it
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(image)
    flops = counter.get_total_flops()
    table = resnet.flops_per_image(name, 224)
    # Two flops a multiply-add: the table's figure is the multiply-adds.
    assert flops == pytest.approx(2 * table, rel=1e-2), (flops, table)
