"""CLI: OBJ (+MTL +texture) -> vertex-colored binary FBX, with a check.

    python -m mq3d_tpu_torch.scripts.convert_obj_to_fbx \
        --input <obj> --output <fbx> [--keep-ply]

Counterpart of scripts/convert_obj_to_fbx.py of the JAX build (host
numpy; --device is accepted, as by every CLI of the port, and nothing here
runs on it).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mq3d_tpu_torch.dataio.ply import write_ply_mesh
from mq3d_tpu_torch.export.fbx import convert_ply_to_fbx
from mq3d_tpu_torch.export.obj import convert_obj_to_mesh
from mq3d_tpu_torch.scripts._cli import add_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=Path, required=True, help="OBJ file")
    parser.add_argument("--output", type=Path, required=True, help="FBX file")
    parser.add_argument("--keep-ply", action="store_true",
                        help="keep the intermediate PLY next to the FBX")
    add_device(parser)
    args = parser.parse_args(argv)

    mesh = convert_obj_to_mesh(args.input)
    print(f"[Info] Parsed OBJ: {len(mesh.vertices)} vertices, "
          f"{len(mesh.triangles)} triangles, "
          f"colors={'yes' if mesh.vertex_colors is not None else 'no'}")

    ply_path = args.output.with_suffix(".ply")
    write_ply_mesh(ply_path, mesh)
    convert_ply_to_fbx(ply_path, args.output)

    # Verification pass: the FBX must exist, be non-trivial, and hold the
    # mesh's arrays.
    ok = args.output.exists() and args.output.stat().st_size > 100
    if ok:
        text = args.output.read_text(errors="replace")[:200_000]
        ok = f"*{mesh.vertices.size}" in text or "Vertices" in text
    if not args.keep_ply:
        ply_path.unlink(missing_ok=True)
    if not ok:
        print("[Error] FBX verification failed")
        sys.exit(1)
    print(f"[Info] FBX written and verified: {args.output}")


if __name__ == "__main__":
    main()
