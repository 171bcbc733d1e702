"""CLI: the quality score Q of FBX meshes, under the reference's name.

    python -m mq3d_tpu_torch.scripts.evaluate_fbx_quality mesh1.fbx mesh2.fbx ...

Counterpart of scripts/evaluate_fbx_quality.py of the JAX build: the same
entry as evaluate_mesh_quality, which reads FBX (binary or ASCII) and PLY.
"""

from __future__ import annotations

from mq3d_tpu_torch.scripts.evaluate_mesh_quality import main

if __name__ == "__main__":
    main()
