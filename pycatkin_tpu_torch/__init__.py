"""pycatkin_tpu_torch: the PyTorch / CUDA port of pycatkin_tpu.

The lane-batched steady-state sweep of the JAX package
(``pycatkin_tpu.parallel.batch``), ported to PyTorch for NVIDIA Hopper
cards: float64 throughout, an explicit leading lane dimension in place
of ``vmap``, and the batched-LU Pallas kernels of
``pycatkin_tpu/ops/pallas_linalg.py`` rewritten as hand-written CUDA
kernels (``csrc/linalg.cu``, bound in :mod:`.ops.cuda_linalg`).

Entry point: :func:`pycatkin_tpu_torch.parallel.batch.sweep_steady_state`
(``abi=True`` lowers the mechanism into its shape bucket first,
:mod:`.frontend.abi`); below it, :func:`~.parallel.batch.fused_sweep`.
Public entry points run on the CUDA card unless ``device="cpu"`` is
passed, and raise when no card is present.
"""

__version__ = "0.1.0"
