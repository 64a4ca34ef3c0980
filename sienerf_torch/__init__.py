"""sienerf_torch — the PyTorch/CUDA port of the JAX package, for NVIDIA Hopper.

Module names mirror the JAX package's (`sienerf_torch/ops/sweep.py` is the
port of its `ops/sweep.py`).  This package imports torch and never JAX or
the JAX package; what it needs from the JAX package it keeps as its own
copy.  Entry points run on the card (`device="cuda"`) unless the caller
passes another device.

Ported so far: the serving path (render-only snapshot -> baked int16
lattice -> slab-sweep frame, with the shade and sweep-composite kernels),
the live streaming ray-marched renderer with the quality measures, the
gather probe (`tools/bench_gather.py`) with its two row-gather kernels, and
the NeRF trainer (`engines/nerf.py::train_bundle`, `Session.train`), whose
trained field renders through the same sweep.  Every kernel is written by
hand in CUDA C++ (`csrc/`); the trainer runs none, as the JAX trainer runs
no Pallas code.
"""
