#!/usr/bin/env python3
"""Generate the volume-integrator golden fixture.

The reference's only volume scene (handVolume.json) depends on hand.vol and
an env texture that are stripped large blobs, so this script builds a
self-contained substitute: a smooth radial-falloff density grid + a scene
with a constant-Le environment light, renders it with the reference binary
(tools/refbuild/nart_ref), and stores scene + volume + golden EXR in
tests/golden/.

Usage: python tools/gen_volume_golden.py
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def main():
    sys.path.insert(0, ROOT)
    from nart_jax.vol import VolGrid, write_vol

    res = 32
    z, y, x = np.mgrid[0:res, 0:res, 0:res].astype(np.float32)
    c = (res - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
    density = np.clip(1.0 - r, 0.0, 1.0) ** 2  # smooth blob
    grid = VolGrid(
        bounds_min=np.array([-1.0, -1.0, -1.0], np.float32),
        bounds_max=np.array([1.0, 1.0, 1.0], np.float32),
        density=density.astype(np.float32),
    )
    vol_path = os.path.join(GOLDEN, "blob.vol")
    write_vol(vol_path, grid)

    scene = {
        "renderSessions": [
            {
                "integrator": "volume",
                "imageWidth": 96,
                "imageHeight": 96,
                "bucketSize": 16,
                "spp": 32,
                "bounces": 16,
                "filterWidth": 1,
            }
        ],
        "camera": {
            "fov": 30.0,
            # camera at +z=4 looking down -z (identity rotation)
            "transform": [
                1.0, 0.0, 0.0, 0.0,
                0.0, 1.0, 0.0, 0.0,
                0.0, 0.0, 1.0, 4.0,
                0.0, 0.0, 0.0, 1.0,
            ],
            "medium": {
                "filePath": "tests//golden//blob.vol",  # under the repo root
                "sigma_a": 1.0,
                "sigma_s": 8.0,
                "Le": [0.4, 0.3, 0.2],
            },
        },
        "lights": [
            {
                "type": "environment",
                "Le": [0.8, 0.9, 1.0],
                "intensity": 1.0,
                "transform": [
                    1.0, 0.0, 0.0, 0.0,
                    0.0, 1.0, 0.0, 0.0,
                    0.0, 0.0, 1.0, 0.0,
                    0.0, 0.0, 0.0, 1.0,
                ],
            }
        ],
    }
    scene_path = os.path.join(GOLDEN, "volume_blob.json")
    with open(scene_path, "w") as f:
        json.dump(scene, f, indent=2)

    ref_bin = os.path.join(ROOT, "tools", "refbuild", "nart_ref")
    if not os.path.exists(ref_bin):
        subprocess.check_call(
            ["make", "-C", os.path.join(ROOT, "tools", "refbuild"), "-j8"]
        )
    out = os.path.join(GOLDEN, "volume_blob_96x96_32spp")
    subprocess.check_call([ref_bin, scene_path, out])
    print("golden written:", out + ".exr")


if __name__ == "__main__":
    main()
