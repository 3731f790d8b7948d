"""PyTorch / CUDA port of ``pytorch_distributed_training_example_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout (``utils/``, ``models/``, ``ops/``, ``serve/``) and module names so
each module's counterpart is easy to find. It imports ``torch`` and never
``jax`` or the JAX package. The Pallas kernels of the JAX package become
hand-written CUDA kernels for Hopper (``csrc/``), each with a plain PyTorch
version beside its wrapper; the wrapper takes the plain version only for a
tensor on the CPU.

Entry point: ``python -m pytorch_distributed_training_example_tpu_torch.main``
(runs on the GPU unless ``--device cpu`` is given).
"""
