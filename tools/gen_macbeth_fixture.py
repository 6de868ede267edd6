#!/usr/bin/env python3
"""Stage tests/fixtures/macbeth: the reference's macbeth.json color-chart
scene with its two stripped large blobs replaced by generated substitutes.

The reference repo ships macbeth.json, sphere.geo/plane.geo and the real
sRGB_ColorChecker2005.exr albedo texture, but .MISSING_LARGE_BLOBS strips
the env map (parking_garage_4k.exr) and the camera medium volume
(hand.vol).  This script copies the real assets and generates:

  * a small lat-long env map with a smooth sky gradient plus a bright sun
    disk (so environment importance sampling has structure to find), and
  * a tiny 2x2x2 .vol density grid (the camera medium is parsed but unused
    by the path integrator — macbeth renders with the default integrator).

Golden EXRs are then rendered by the reference binary from the fixture dir:

    cd tests/fixtures/macbeth
    ../../../tools/refbuild/nart_ref macbeth.json \
        ../../golden/macbeth_96x96_8spp -w 96 -h 96 -s 8
    ../../../tools/refbuild/nart_ref macbeth.json \
        ../../golden/macbeth_128x128_16spp -w 128 -h 128 -s 16
"""

import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference"
FIX = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "macbeth")


def main():
    for sub in ("meshes", "textures", "volumes"):
        os.makedirs(os.path.join(FIX, "input", sub), exist_ok=True)
    for rel in (
        "input/meshes/sphere.geo",
        "input/meshes/plane.geo",
        "input/textures/sRGB_ColorChecker2005.exr",
        "input/scenes/macbeth.json",
    ):
        dst = (
            os.path.join(FIX, "macbeth.json")
            if rel.endswith(".json")
            else os.path.join(FIX, rel)
        )
        shutil.copy(os.path.join(REF, rel), dst)

    # tiny .vol: boundsMin(3) boundsMax(3) res(3) then res^3 floats
    with open(os.path.join(FIX, "input/volumes/hand.vol"), "w") as f:
        f.write("0.0 0.0 0.0\n1.0 1.0 1.0\n2 2 2\n" + "0.1\n" * 8)

    # substitute env map: sky gradient + sun disk
    h, w = 64, 128
    th = (np.arange(h) + 0.5) / h * np.pi
    ph = (np.arange(w) + 0.5) / w * 2 * np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    sky = np.stack(
        [
            0.35 + 0.25 * np.cos(T),
            0.45 + 0.2 * np.cos(T),
            0.7 + 0.3 * np.cos(T),
        ],
        -1,
    )
    sun_dir = np.array(
        [np.sin(1.0) * np.cos(0.8), np.sin(1.0) * np.sin(0.8), np.cos(1.0)]
    )
    dirs = np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1
    )
    sun = np.clip(((dirs @ sun_dir) - 0.995) / 0.005, 0, 1)[..., None] * np.array(
        [40.0, 36.0, 30.0]
    )
    img = (sky + sun).astype(np.float32)
    rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], -1)

    from nart_jax import exr

    exr.write(os.path.join(FIX, "input/textures/parking_garage_4k.exr"), rgba)
    print("staged", FIX)


if __name__ == "__main__":
    main()
