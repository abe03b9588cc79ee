"""PyTorch/CUDA port of the UniPC sampler for one NVIDIA H100.

Mirrors the layout of the JAX package `repro` (the reference): `configs/`,
`diffusion/`, `core/`, `kernels/`, `models/`, `engine/` and `launch/`. The
port imports torch and numpy only. On a CUDA tensor every kernel op runs its
hand-written Hopper kernel (`kernels/csrc/*.cu`); on a CPU tensor it runs the
op's plain PyTorch version, which is what the CPU tests compare against the
JAX reference.
"""
