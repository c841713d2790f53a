"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The port serves the same models with the same launch-reordering
scheduler as the JAX package beside it, and replaces each Pallas TPU
kernel on its path with a CUDA C++ kernel written for ``sm_90a``.  It
imports ``torch`` and NumPy, never JAX or ``repro``; its tests check it
against ``repro``.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``, where every kernel's plain PyTorch version runs.

Ported so far: configs and shapes, the models (:mod:`.models`: GQA
decode and forward for every dense GQA arch, Mamba and MoE layers for
jamba and mixtral), all five TPU kernels as CUDA C++ for ``sm_90a``
(:mod:`.kernels`: RMSNorm, decode attention, flash attention, the event
scan and the selective scan), the host scheduler with its simulators,
refiners and design-space protocol (:mod:`.core`), observability
(:mod:`.obs`), the flat serving engine with refined composition
(:mod:`.serve`) and its command-line entry point (:mod:`.launch.serve`).
ROADMAP.md lists the rest (MLA, the dependency-aware composition, the
front end, xLSTM, training, distribution).
"""
