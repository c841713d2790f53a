"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The port serves the same models with the same launch-reordering
scheduler as the JAX package beside it, and replaces each Pallas TPU
kernel on its path with a CUDA C++ kernel written for ``sm_90a``.  It
imports ``torch`` and NumPy, never JAX or ``repro``; its tests check it
against ``repro``.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``, where every kernel's plain PyTorch version runs.

Ported so far: configs and shapes, the models (:mod:`.models`: GQA
decode and forward for every dense GQA arch, MLA for deepseek-v2, Mamba
and MoE layers for jamba, mixtral and deepseek-v2), all five TPU
kernels as CUDA C++ for ``sm_90a`` (:mod:`.kernels`: RMSNorm, decode
attention, flash attention, the event scan and the selective scan), the
host scheduler with its simulators,
refiners and design-space protocol (:mod:`.core`), the dependency-aware
kernel-DAG scheduler (:mod:`.graph`), observability (:mod:`.obs`), the
serving engine with refined and dependency-aware (unsliced) composition
(:mod:`.serve`) and its command-line entry point (:mod:`.launch.serve`).
ROADMAP.md lists the rest (kernel slicing and the live composition, the
front end, xLSTM, training, distribution).
"""
