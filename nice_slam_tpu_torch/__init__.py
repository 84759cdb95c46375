"""nice_slam_tpu_torch — the PyTorch/CUDA port of `nice_slam_tpu`.

The same NICE-SLAM system (four feature-grid volumes decoded by small MLPs,
tracking and mapping as differentiable volume-rendering loops), written in
PyTorch for one NVIDIA H100.  The JAX package beside it is the reference:
every module here mirrors the one of the same path there, and the tests run
both on the same inputs.  This package imports neither JAX nor anything of
`nice_slam_tpu`.

Layer map (same as `nice_slam_tpu/__init__.py`):
  core/      L0  cameras, pixel/depth sampling, alpha compositing
  ops/       L0  trilinear grid interpolation; the corner-expand / fold
                 CUDA kernels (csrc/expand.cu) and their plain versions
  models/    L1  NICE grids and decoders (nn.Module), pretrained import
  render/    L2  volume renderer
  engine/    L3/L4 tracker, mapper, keyframes, strict-schedule orchestrator
  io/        L5  dataset ingest (the analytic `synthetic` scene)
  eval/      L7  ATE
  utils/     —   config views, masked Adam

Entry points run on CUDA unless the caller passes `device='cpu'`
(`SlamSystem(cfg, device=...)`, `python -m nice_slam_tpu_torch <cfg>`).
"""

__version__ = "0.1.0"
