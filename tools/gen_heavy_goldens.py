#!/usr/bin/env python3
"""Generate substitute scenes + reference goldens for the 3 heavy scenes.

cameraLens.json, glassIceWater.json and dragonBunnyGlass.json are the
reference's heaviest showcase scenes (large meshes, texture/normal
pipelines, deep dielectric nesting), but several of their assets are
stripped large blobs (/root/reference/.MISSING_LARGE_BLOBS): 6 of the 7
cameraLens textures, the 3 glassIceWater table textures, and the
dragon_lo/bunny meshes.  This script derives *_sub.json variants that
keep every surviving asset and substitute the missing ones with assets
that DO exist (so the reference binary and nart-jax read byte-identical
inputs), then renders the goldens with the reference binary
(tools/refbuild/nart_ref, run from /root/reference for relative paths).

Substitutions:
  cameraLens_sub:  missing textures -> uv/noise/ColorChecker/
                   lens_roughness.exr; missing env map ->
                   kloofendal_..._1k_clamped.exr; plastic normal map
                   dropped (no surviving normal texture of matching role;
                   iceCube_normal still covers normal mapping in
                   glassIceWater_sub).
  glassIceWater_sub: table rho_d -> ColorChecker, table roughness ->
                   iceCube_roughness, table normal -> iceCube_normal.
  dragonBunnyGlass_sub: dragon_lo.geo -> ring.geo (8k tris, re-posed),
                   bunny.geo -> monkey.geo (re-posed); materials,
                   lights, camera, glass sphere, backdrop unchanged.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
SCENES = os.path.join(REF, "input", "scenes")
GOLDEN = os.path.join(REPO, "tests", "golden")
NART_REF = os.path.join(REPO, "tools", "refbuild", "nart_ref")

CAMERALENS_TEX = {
    "input//textures//cameraLens//plastic_rho_d.exr":
        "input//textures//uv.exr",
    "input//textures//cameraLens//plastic_roughness.exr":
        "input//textures//cameraLens//lens_roughness.exr",
    "input//textures//cameraLens//metal_rho_s.exr":
        "input//textures//sRGB_ColorChecker2005.exr",
    "input//textures//cameraLens//metal_roughness.exr":
        "input//textures//cameraLens//lens_roughness.exr",
    "input//textures//cameraLens//aperture_rho_d.exr":
        "input//textures//noise.exr",
    "input//textures//photo_studio_broadway_hall_1k.exr":
        "input//textures//uv.exr",  # every 1k+ env map is a stripped blob
}

GLASSICE_TEX = {
    "input//textures//studio_small_09_4k.exr":
        "input//textures//uv.exr",  # stripped env map
    "input//textures//glassIceWater//table_rho_d.exr":
        "input//textures//sRGB_ColorChecker2005.exr",
    "input//textures//glassIceWater//table_roughness.exr":
        "input//textures//glassIceWater//iceCube_roughness.exr",
    "input//textures//glassIceWater//table_normal.exr":
        "input//textures//glassIceWater//iceCube_normal.exr",
}


def _walk_replace(node, table, drop_normal=False):
    if isinstance(node, dict):
        if drop_normal and "normal" in node:
            n = node["normal"]
            if (isinstance(n, dict)
                    and "plastic_normal" in str(n.get("filePath", ""))):
                del node["normal"]
        for k, v in list(node.items()):
            if k == "filePath" and v in table:
                node[k] = table[v]
            else:
                _walk_replace(v, table, drop_normal)
    elif isinstance(node, list):
        for v in node:
            _walk_replace(v, table, drop_normal)


def make_cameralens():
    doc = json.load(open(os.path.join(SCENES, "cameraLens.json")))
    _walk_replace(doc, CAMERALENS_TEX, drop_normal=True)
    out = os.path.join(GOLDEN, "cameraLens_sub.json")
    json.dump(doc, open(out, "w"), indent=1)
    return out


def make_glassicewater():
    doc = json.load(open(os.path.join(SCENES, "glassIceWater.json")))
    _walk_replace(doc, GLASSICE_TEX)
    out = os.path.join(GOLDEN, "glassIceWater_sub.json")
    json.dump(doc, open(out, "w"), indent=1)
    return out


def make_dragonbunny():
    doc = json.load(open(os.path.join(SCENES, "dragonBunnyGlass.json")))
    for m in doc["meshes"]:
        if "dragon_lo" in m["filePath"]:
            m["filePath"] = "input//meshes//ring.geo"
            # unit-bbox ring posed where the dragon stood (on the ground
            # plane, centre of frame)
            m["transform"] = [1.4, 0, 0, 0.0,
                              0, 1.4, 0, 0.0,
                              0, 0, 1.4, 1.4,
                              0, 0, 0, 1.0]
        elif "bunny" in m["filePath"]:
            m["filePath"] = "input//meshes//monkey.geo"
            m["transform"] = [0.8, 0, 0, 1.177,
                              0, 0.8, 0, -1.318,
                              0, 0, 0.8, 0.78,
                              0, 0, 0, 1.0]
    out = os.path.join(GOLDEN, "dragonBunnyGlass_sub.json")
    json.dump(doc, open(out, "w"), indent=1)
    return out


def render_golden(scene_path, name, w, h, spp):
    out = os.path.join(GOLDEN, f"{name}_{w}x{h}_{spp}spp")
    cmd = [NART_REF, scene_path, out, "-w", str(w), "-h", str(h),
           "-s", str(spp)]
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, cwd=REF, check=True)
    # multi-session scenes emit _0 suffixes; normalise to plain name
    if not os.path.exists(out + ".exr") and os.path.exists(out + "_0.exr"):
        os.rename(out + "_0.exr", out + ".exr")
    return out + ".exr"


def main():
    which = sys.argv[1:] or ["cameraLens", "glassIceWater",
                             "dragonBunnyGlass"]
    if "cameraLens" in which:
        p = make_cameralens()
        render_golden(p, "cameraLens_sub", 128, 128, 16)
    if "glassIceWater" in which:
        p = make_glassicewater()
        render_golden(p, "glassIceWater_sub", 128, 128, 16)
    if "dragonBunnyGlass" in which:
        p = make_dragonbunny()
        render_golden(p, "dragonBunnyGlass_sub", 128, 128, 16)


if __name__ == "__main__":
    main()
