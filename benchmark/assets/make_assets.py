"""Write the benchmark's mesh assets from the port's procedural meshes.

    python -m benchmark.assets.make_assets

Run once; the files it writes are committed, so no benchmark run repeats
the scan chain's host work and no later change to the port's decimator or
subdivider can change the traffic. See RECIPE.md.

- scan13k.ply + scan13k.png: ``scanned_blob(seed=3)`` (105,340 faces),
  written as a binary PLY and loaded back, decimated to 12,000 faces by
  vertex clustering, then ``subdivide_adaptive(max_faces=32_768,
  patch_k=4)``: 13,277 faces.
- cube8cm.ply + cube8cm.png: ``textured_cube(size=0.08)``, 12 faces, for the
  CPU tests (no cell runs it).
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent


def main() -> int:
    from foundationpose_cpp_tpu_torch.meshio import mesh_loader, procedural
    from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
    from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive

    with tempfile.TemporaryDirectory() as tmp:
        ply = pathlib.Path(tmp) / "scan.ply"
        procedural.write_ply(procedural.scanned_blob(seed=3), str(ply),
                             str(pathlib.Path(tmp) / "scan_tex.png"), binary=True)
        raw = mesh_loader.load_mesh("scan", str(ply))
    dec = decimate_vertex_clustering(raw, target_faces=12_000)
    final, info = subdivide_adaptive(dec, max_faces=32_768, patch_k=4)
    procedural.write_ply(final, str(HERE / "scan13k.ply"), str(HERE / "scan13k.png"), binary=True)
    cube = procedural.textured_cube(size=0.08)
    procedural.write_ply(cube, str(HERE / "cube8cm.ply"), str(HERE / "cube8cm.png"), binary=True)
    print(f"scan: raw {raw.num_faces} faces, decimated {dec.num_faces}, final {final.num_faces} "
          f"({info['rounds']} rounds); cube {cube.num_faces} faces")
    return 0


if __name__ == "__main__":
    sys.exit(main())
