"""Write the stand-in meshes of LM-O's eight objects from the port's scan chain.

    python -m benchmark.assets.make_lmo8

Run once; the files it writes are committed, as ``make_assets.py``'s are.
See RECIPE_lmo8.md. Each object: ``scanned_blob(seed=<its LINEMOD id>,
radius=<its diameter> / 2, tex_size=512, or 256 under 0.15 m)``, written as
a binary PLY and loaded back, decimated by vertex clustering, then
``subdivide_adaptive(max_faces=1.1 x its face target, patch_k=4)``: the
decimation target is searched so that the final faces land within 15% of the
target. Last, the vertices are scaled so that the loader's diameter is the
object's LINEMOD diameter, and the mesh is written as ``lmo8_<name>.ply`` +
``.png``.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

# name, LINEMOD object id (the blob's seed), diameter in mm, assumed faces
OBJECTS = (
    ("ape", 1, 102.1, 6_000),
    ("can", 5, 201.4, 18_000),
    ("cat", 6, 154.5, 12_000),
    ("driller", 8, 261.5, 26_000),
    ("duck", 9, 109.0, 7_000),
    ("eggbox", 10, 176.4, 14_000),
    ("glue", 11, 164.6, 13_000),
    ("holepuncher", 12, 148.2, 10_000),
)
LARGE_TEXTURE_M = 0.15  # 512x512 at this diameter or more, else 256x256
FACE_SLACK = 0.15


def texture_size(diameter_mm: float) -> int:
    return 512 if diameter_mm * 1e-3 >= LARGE_TEXTURE_M else 256


def make_object(name: str, seed: int, diameter_mm: float, target: int, tmp: pathlib.Path):
    """(asset, recipe) of one object: the scan chain at the decimation
    target whose final face count lies nearest ``target``."""
    from foundationpose_cpp_tpu_torch.meshio import mesh_loader, procedural
    from foundationpose_cpp_tpu_torch.meshio.decimate import decimate_vertex_clustering
    from foundationpose_cpp_tpu_torch.meshio.subdivide import subdivide_adaptive

    tex = texture_size(diameter_mm)
    ply = tmp / f"{name}_raw.ply"
    procedural.write_ply(
        procedural.scanned_blob(name, seed=seed, radius=diameter_mm * 1e-3 / 2, tex_size=tex),
        str(ply), str(tmp / f"{name}_raw.png"), binary=True)
    raw = mesh_loader.load_mesh(name, str(ply))
    best = None
    for frac in (0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.9, 1.0):
        dec_target = int(round(target * frac))
        dec = decimate_vertex_clustering(raw, target_faces=dec_target)
        final, info = subdivide_adaptive(dec, max_faces=int(target * 1.1), patch_k=4)
        miss = abs(final.num_faces - target) / target
        if best is None or miss < best[0]:
            best = (miss, final, dict(raw=raw.num_faces, dec_target=dec_target,
                                      decimated=dec.num_faces, final=final.num_faces,
                                      rounds=info["rounds"], tex=tex))
        if miss <= FACE_SLACK / 3:
            break
    miss, final, recipe = best
    if miss > FACE_SLACK:
        raise RuntimeError(f"{name}: {final.num_faces} faces, target {target}")
    scale = diameter_mm * 1e-3 / final.diameter
    scaled = mesh_loader.make_mesh_asset(
        name, (np.asarray(final.vertices, np.float64) * scale).astype(np.float32), final.faces,
        final.texcoords, final.vertex_normals, final.texture)
    recipe["scale"] = scale
    return scaled, recipe


def main() -> int:
    from foundationpose_cpp_tpu_torch.meshio import mesh_loader, procedural

    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, seed, diameter_mm, target in OBJECTS:
            asset, recipe = make_object(name, seed, diameter_mm, target, pathlib.Path(tmp))
            ply, png = HERE / f"lmo8_{name}.ply", HERE / f"lmo8_{name}.png"
            procedural.write_ply(asset, str(ply), str(png), binary=True)
            back = mesh_loader.load_mesh(name, str(ply))
            total += back.num_faces
            print(f"{name}: seed {seed}, {recipe}, loaded {back.num_faces} faces, diameter "
                  f"{back.diameter * 1e3:.3f} mm (want {diameter_mm}), "
                  f"{ply.stat().st_size + png.stat().st_size} bytes", flush=True)
    print(f"total faces {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
