"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The port serves the same models with the same launch-reordering
scheduler as the JAX package beside it, and replaces each Pallas TPU
kernel on its path with a CUDA C++ kernel written for ``sm_90a``.  It
imports ``torch`` and NumPy, never JAX or ``repro``; its tests check it
against ``repro``.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``, where every kernel's plain PyTorch version runs.

Ported so far: configs, the dense GQA decode path
(:mod:`.models`), the RMSNorm and decode-attention kernels
(:mod:`.kernels`), the host scheduler (:mod:`.core`), observability
(:mod:`.obs`), the flat serving engine (:mod:`.serve`) and its
command-line entry point (:mod:`.launch.serve`).  ROADMAP.md lists the rest.
"""
