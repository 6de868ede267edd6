"""Golden-image tests against the actual reference renderer's output.

The fixtures in tests/golden/ were rendered by the reference binary at the
given size/spp.  Per-pixel equality cannot hold — fp ordering differences
send chaotic (glass/caustic) paths to different outcomes — so the
comparison is statistical:

  * global image mean within a few percent (the Monte Carlo estimate of
    total flux agrees),
  * block means (16x16) mostly within a noise-scaled tolerance
    (structure agrees, not just the total).

Scenes whose meshes or textures are in the repository (volume blob,
macbeth, Cornell on the macbeth fixture's meshes) run here on the CPU.
The others need assets of the reference checkout, which the repository
does not hold; they skip, naming the first missing asset.  chip_smoke.py
runs the in-repo goldens on the card with the same tolerances.
"""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
MACBETH = os.path.join(HERE, "fixtures", "macbeth")
# the reference checkout's scenes and assets (not in the repository)
REF_ROOT = os.path.join(os.path.dirname(HERE), "reference")
REF_SCENES = os.path.join(REF_ROOT, "input", "scenes")


def _file_paths(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "filePath":
                yield v
            else:
                yield from _file_paths(v)
    elif isinstance(node, list):
        for v in node:
            yield from _file_paths(v)


def _require_assets(scene_path, asset_root):
    """Skip unless the scene file and every asset it names are present."""
    from nart_jax.scene import resolve_asset

    if not os.path.exists(scene_path):
        pytest.skip(f"needs {os.path.basename(scene_path)}, a reference "
                    "scene that is not in the repository")
    with open(scene_path) as f:
        doc = json.load(f)
    for path in _file_paths(doc):
        try:
            resolve_asset(path, asset_root)
        except FileNotFoundError:
            pytest.skip(f"needs the reference asset {path.replace('//', '/')}"
                        ", which is not in the repository")


def _render(scene_name, w, h, spp):
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene_path = os.path.join(REF_SCENES, scene_name)
    _require_assets(scene_path, REF_ROOT)
    scene = load_scene(scene_path, asset_root=REF_ROOT)
    params = render_mod.resolve_params(
        {}, dict(image_width=w, image_height=h, spp=spp)
    )
    sess = render_mod.RenderSession(scene, params)
    return sess.image()


def _render_session(scene_path, asset_root, overrides, session_index=0):
    """Render one renderSession of a scene file in this process."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    _require_assets(scene_path, asset_root)
    scene = load_scene(scene_path, asset_root=asset_root)
    params = render_mod.load_sessions(scene_path, overrides)[session_index]
    return render_mod.RenderSession(scene, params).image()


def _compare(ours, golden_path, mean_tol, block_tol, block_frac):
    from nart_jax import exr

    ref = exr.read(golden_path)
    assert ref.shape == ours.shape
    r = ref[..., :3]
    o = ours[..., :3]
    mean_rel = abs(o.mean() - r.mean()) / max(r.mean(), 1e-6)
    assert mean_rel < mean_tol, f"image mean off by {mean_rel:.3f}"

    bh, bw = 16, 16
    h, w = r.shape[:2]
    rb = r[: h - h % bh, : w - w % bw].reshape(h // bh, bh, w // bw, bw, 3)
    ob = o[: h - h % bh, : w - w % bw].reshape(h // bh, bh, w // bw, bw, 3)
    rm = rb.mean((1, 3, 4))
    om = ob.mean((1, 3, 4))
    rel = np.abs(om - rm) / np.maximum(rm, 0.05)
    frac_ok = (rel < block_tol).mean()
    assert frac_ok >= block_frac, (
        f"only {frac_ok:.2f} of blocks within {block_tol}: worst {rel.max():.3f}"
    )


def test_volume_golden():
    """Volume integrator vs the reference on the generated blob volume
    (tools/gen_volume_golden.py; the reference's own hand.vol is a stripped
    large blob)."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene_path = os.path.join(GOLDEN, "volume_blob.json")
    scene = load_scene(scene_path)
    params = next(iter(render_mod.load_sessions(scene_path)))
    sess = render_mod.RenderSession(scene, params)
    ours = sess.image()
    _compare(
        ours,
        os.path.join(GOLDEN, "volume_blob_96x96_32spp.exr"),
        mean_tol=0.02,
        block_tol=0.05,
        block_frac=0.95,
    )


def test_texture_env_golden():
    """Texture patterns end-to-end vs the reference binary: rho_d texture
    (ColorChecker), roughness texture (alpha squaring), tangent-space
    normal map (generated waves_normal.exr — reference decode n=2v-1,
    plasticmaterial.cpp:16-21), environment light with 2D-CDF importance
    sampling on uv.exr, plus a disk light for MIS, rougheningFactor 0.25."""
    ours = _render_session(
        os.path.join(GOLDEN, "texture_env.json"), REF_ROOT, None
    )
    _compare(
        ours,
        os.path.join(GOLDEN, "texture_env_128x128_16spp.exr"),
        mean_tol=0.03,
        block_tol=0.15,
        block_frac=0.9,
    )


def test_ring_golden():
    """Glossy near-mirror ring + two disk lights, vs the reference binary.

    Default-suite check is the TIGHT one: the two ROUGHENED renderSessions
    (rougheningFactor 0.2 / 0.3) at 64x64 @64spp vs the 512-spp reference
    goldens — roughening tames the caustic tail enough for a 5% mean bound
    (both sessions measured ~1.9% at this config).  The unroughened session 0's estimator is too heavy-
    tailed for tight bounds below 256 spp (the reference's OWN 16-spp mean
    deviates ~10% from its 512-spp mean at 64x64); it is covered at 256
    spp by test_ring_golden_tight."""
    scene_path = os.path.join(REF_SCENES, "ring.json")
    for si in (1, 2):
        ours = _render_session(
            scene_path, REF_ROOT,
            dict(image_width=64, image_height=64, spp=64), session_index=si,
        )
        _compare(
            ours,
            os.path.join(GOLDEN, f"ring_64x64_512spp_{si}.exr"),
            mean_tol=0.05,
            block_tol=0.25,
            block_frac=0.85,
        )


@pytest.mark.skipif(
    not os.environ.get("NART_SLOW_TESTS"), reason="slow: NART_SLOW_TESTS=1"
)
def test_ring_golden_loose():
    """Unroughened ring session 0 at 32 spp: noise-scaled (loose) bounds
    (~2.5x the reference's own measured 16-spp noise at this config)."""
    ours = _render_session(
        os.path.join(REF_SCENES, "ring.json"), REF_ROOT,
        dict(image_width=64, image_height=64, spp=32),
    )
    _compare(
        ours,
        os.path.join(GOLDEN, "ring_64x64_512spp_0.exr"),
        mean_tol=0.25,
        block_tol=0.5,
        block_frac=0.8,
    )


@pytest.mark.skipif(
    not os.environ.get("NART_SLOW_TESTS"), reason="slow: NART_SLOW_TESTS=1"
)
def test_ring_golden_tight():
    """All three ring renderSessions (rougheningFactor 0/0.2/0.3) at 256 spp
    vs 256-spp reference goldens — converged enough for tight bounds
    (measured: ours-vs-ref mean delta 1.5%, 98% of blocks within 15%)."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene_path = os.path.join(REF_SCENES, "ring.json")
    _require_assets(scene_path, REF_ROOT)
    scene = load_scene(scene_path, asset_root=REF_ROOT)
    sessions = render_mod.load_sessions(
        scene_path, dict(image_width=128, image_height=128, spp=256)
    )
    for i, params in enumerate(sessions):
        sess = render_mod.RenderSession(scene, params)
        _compare(
            sess.image(),
            os.path.join(GOLDEN, f"ring_128x128_256spp_{i}.exr"),
            mean_tol=0.04,
            block_tol=0.15,
            block_frac=0.93,
        )


def _render_macbeth(w, h, spp):
    """The reference's radiometric color-chart scene, staged in
    tests/fixtures/macbeth: real sRGB_ColorChecker2005.exr + the
    reference's sphere/plane meshes, with its two large blobs
    (parking_garage_4k.exr, hand.vol) replaced by generated substitutes
    (tools/gen_macbeth_fixture.py); the golden EXRs were rendered by the
    reference binary from the same fixture dir, so the comparison is
    exact-config."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene = load_scene(os.path.join(MACBETH, "macbeth.json"),
                       asset_root=MACBETH)
    params = render_mod.resolve_params(
        {}, dict(image_width=w, image_height=h, spp=spp)
    )
    sess = render_mod.RenderSession(scene, params)
    return sess.image()


def test_macbeth_golden():
    """Color-chart radiometry: 24-patch albedo texture + env light +
    glossy/plastic spheres (macbeth.json).  Measured agreement at this
    config: mean rel 3e-4, max 16x16-block rel 3.3%."""
    ours = _render_macbeth(96, 96, 8)
    _compare(
        ours,
        os.path.join(GOLDEN, "macbeth_96x96_8spp.exr"),
        mean_tol=0.03,
        block_tol=0.12,
        block_frac=0.95,
    )


@pytest.mark.skipif(
    not os.environ.get("NART_SLOW_TESTS"), reason="slow: NART_SLOW_TESTS=1"
)
def test_macbeth_golden_tight():
    """128x128 @16spp variant (measured: mean rel 3e-4, p95 block 1.5%)."""
    ours = _render_macbeth(128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "macbeth_128x128_16spp.exr"),
        mean_tol=0.01,
        block_tol=0.05,
        block_frac=0.95,
    )


def test_veach_golden():
    ours = _render("veach.json", 128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "veach_128x128_16spp.exr"),
        mean_tol=0.03,
        block_tol=0.15,
        block_frac=0.9,
    )


@pytest.mark.skipif(
    not os.environ.get("NART_SLOW_TESTS"), reason="slow: NART_SLOW_TESTS=1"
)
def test_glasssphere_golden():
    ours = _render("glassSphere.json", 128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "glassSphere_128x128_16spp.exr"),
        mean_tol=0.05,
        block_tol=0.35,
        block_frac=0.75,
    )


def _render_golden_scene(json_name, w, h, spp):
    return _render_session(
        os.path.join(GOLDEN, json_name), REF_ROOT,
        dict(image_width=w, image_height=h, spp=spp),
    )


def test_cameralens_golden():
    """cameraLens: 94k-triangle lens assembly, metal/plastic roughness +
    rho maps, env-map importance sampling — the largest-mesh reference
    scene.  Stripped textures are substituted by surviving ones in
    cameraLens_sub.json (tools/gen_heavy_goldens.py); the golden was
    rendered by the reference binary from the identical substitute scene."""
    ours = _render_golden_scene("cameraLens_sub.json", 128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "cameraLens_sub_128x128_16spp.exr"),
        mean_tol=0.05,
        block_tol=0.25,
        block_frac=0.85,
    )


def test_glassicewater_golden():
    """glassIceWater: glass/ice/water/bubbles nested-dielectric priority
    stack (priorities 1-4), roughness + normal maps, 32 bounces — the
    deepest dielectric nesting in the reference.  Table textures are
    substituted (tools/gen_heavy_goldens.py)."""
    ours = _render_golden_scene("glassIceWater_sub.json", 128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "glassIceWater_sub_128x128_16spp.exr"),
        mean_tol=0.06,
        block_tol=0.35,
        block_frac=0.75,
    )


def test_dragonbunnyglass_golden():
    """dragonBunnyGlass class: rough glass sphere + glossy + plastic
    meshes under 3 area lights.  The stripped dragon/bunny meshes are
    substituted by ring.geo/monkey.geo re-posed in the same frame
    (tools/gen_heavy_goldens.py)."""
    ours = _render_golden_scene("dragonBunnyGlass_sub.json", 128, 128, 16)
    _compare(
        ours,
        os.path.join(GOLDEN, "dragonBunnyGlass_sub_128x128_16spp.exr"),
        mean_tol=0.05,
        block_tol=0.25,
        block_frac=0.85,
    )


def test_cornell_golden():
    """Diffuse Cornell-style box (BASELINE config 2: lambert + disk light +
    MIS).  Scene JSON lives in tests/golden/cornell.json; its plane and
    sphere meshes are the reference's, copied into tests/fixtures/macbeth
    (tools/gen_macbeth_fixture.py); golden rendered by the reference
    binary.  Diffuse transport is non-chaotic, so tolerances are
    veach-grade."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene = load_scene(os.path.join(GOLDEN, "cornell.json"),
                       asset_root=MACBETH)
    params = render_mod.resolve_params(
        {}, dict(image_width=64, image_height=64, spp=8, bounces=6)
    )
    sess = render_mod.RenderSession(scene, params)
    _compare(
        sess.image(),
        os.path.join(GOLDEN, "cornell_64x64_8spp.exr"),
        mean_tol=0.02,
        block_tol=0.1,
        block_frac=0.9,
    )


@pytest.mark.skipif(
    not os.environ.get("NART_SLOW_TESTS"),
    reason="full config-2 spp (set NART_SLOW_TESTS=1)",
)
def test_cornell_golden_64spp():
    """BASELINE config 2 at its full 64 spp (tight tolerances)."""
    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene = load_scene(os.path.join(GOLDEN, "cornell.json"),
                       asset_root=MACBETH)
    params = render_mod.resolve_params(
        {}, dict(image_width=128, image_height=128, spp=64, bounces=6)
    )
    sess = render_mod.RenderSession(scene, params)
    _compare(
        sess.image(),
        os.path.join(GOLDEN, "cornell_128x128_64spp.exr"),
        mean_tol=0.015,
        block_tol=0.05,
        block_frac=0.95,
    )
