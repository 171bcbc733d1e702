"""mq3d_tpu_torch — the PyTorch/CUDA port of mq3d_tpu for one NVIDIA H100.

Mirrors the layout of ``mq3d_tpu`` module for module, so each file here has a
counterpart of the same name there:

  geometry/  quaternion, SE(3), coordinate conventions (numpy or torch)
  models/    frame-table datasets and pose tables (numpy, npz IO)
  config/    YAML pipeline configs (yaml imported lazily) + project layout
  dataio/    project-directory IO: raw frames, PNG, npz, PLY
  ops/       compute on tensors: YUV->BGR, depth, TSDF integration/extraction,
             meshes, raycast, odometry, ICP, pose graphs
  kernels/   the nvcc build of csrc/*.cu, its ctypes binding, launch counts
  recon/     confidence, fragments and scene refinement, chunked integration,
             colour optimisation and the reconstruction orchestrator
  pipeline/  YUV->RGB, depth->linear and reconstruction stages

The package imports torch, numpy and the standard library only (scipy where
needed); it never imports jax or mq3d_tpu.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
