#!/usr/bin/env python3
"""Convert Wavefront .obj meshes to the .geo format consumed by nart-jax.

Role parity with the reference asset converter (python/obj2geo.py): emits
  numFaces
  per-face vertex counts
  vertex indices, vertex coords
  normal indices, normal coords
  uv indices, uv coords          (omitted when the obj has no vt data)
All indices 0-based; coordinates are Z-up right-handed as authored.

This is a robust re-implementation (proper .obj parsing instead of string
splitting); output layout matches what scene.cpp:77-343 expects.
"""

from __future__ import annotations

import sys


def convert(obj_path: str, geo_path: str | None = None) -> str:
    if geo_path is None:
        geo_path = (
            obj_path[: -len(".obj")] + ".geo"
            if obj_path.endswith(".obj")
            else obj_path + ".geo"
        )
    verts, norms, uvs = [], [], []
    faces = []  # list of list of (vi, ti, ni)
    with open(obj_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append(parts[1:4])
            elif tag == "vn":
                norms.append(parts[1:4])
            elif tag == "vt":
                uvs.append(parts[1:3])
            elif tag == "f":
                corners = []
                for c in parts[1:]:
                    fields = c.split("/")
                    vi = int(fields[0]) - 1
                    ti = int(fields[1]) - 1 if len(fields) > 1 and fields[1] else -1
                    ni = int(fields[2]) - 1 if len(fields) > 2 and fields[2] else -1
                    corners.append((vi, ti, ni))
                faces.append(corners)

    has_uvs = uvs and all(t >= 0 for face in faces for _, t, _ in face)
    if not norms or any(n < 0 for face in faces for _, _, n in face):
        raise SystemExit("obj must contain per-corner vertex normals (vn)")

    out = [str(len(faces))]
    out.append(" ".join(str(len(face)) for face in faces))
    out.append(" ".join(str(v) for face in faces for v, _, _ in face))
    out.append(" ".join(c for v in verts for c in v))
    out.append(" ".join(str(n) for face in faces for _, _, n in face))
    out.append(" ".join(c for n in norms for c in n))
    if has_uvs:
        out.append(" ".join(str(t) for face in faces for _, t, _ in face))
        out.append(" ".join(c for t in uvs for c in t))
    with open(geo_path, "w") as g:
        g.write("\n".join(out) + "\n")
    print(
        f"Faces: {len(faces)}  Vertices: {len(verts)}  "
        f"Normals: {len(norms)}  UVs: {len(uvs) if has_uvs else 0}"
    )
    print(f"Created {geo_path}")
    return geo_path


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit("usage: obj2geo.py <mesh.obj> [out.geo]")
    convert(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
