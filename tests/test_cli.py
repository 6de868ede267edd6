"""CLI smoke tests (main.cpp / ParseRenderParamArguments parity).

Runs the real CLI entry in-process on tiny configs (CPU platform comes from
conftest's jax_platforms flip, which the --platform default inherits).
"""

import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REF_SCENES = "/root/reference/input/scenes"


def _run(argv):
    from nart_jax.cli import main

    return main(argv)


def test_render_writes_exr(tmp_path):
    out = os.path.join(tmp_path, "img")
    rc = _run(
        [os.path.join(GOLDEN, "volume_blob.json"), out, "-w", "16", "-h",
         "16", "-s", "1"]
    )
    assert rc == 0
    from nart_jax import exr

    img = exr.read(out + ".exr")
    assert img.shape == (16, 16, 4)
    assert np.isfinite(img).all()


def test_multi_session_naming(tmp_path):
    scene = os.path.join(REF_SCENES, "ring.json")
    if not os.path.exists(scene):
        pytest.skip("reference scenes unavailable")
    out = os.path.join(tmp_path, "ring")
    rc = _run([scene, out, "-w", "16", "-h", "16", "-s", "1", "-o", "2"])
    assert rc == 0
    # ring.json has 3 renderSessions -> _0/_1/_2 suffixes (main.cpp:44-49)
    for i in range(3):
        assert os.path.exists(f"{out}_{i}.exr"), f"session {i} output missing"


def test_flag_precedence_cli_over_json():
    from nart_jax.render import resolve_params

    # JSON says 64 spp; CLI override wins (render.cpp:327-414 precedence)
    p = resolve_params({"spp": 64, "imageWidth": 32}, {"spp": 4})
    assert p.spp == 4 and p.image_width == 32
    # defaults fill the rest
    assert p.bounces == 10 and p.bucket_size == 16
    # rougheningFactor clamped to [0, 1]
    p = resolve_params({"rougheningFactor": 7.0}, {})
    assert p.roughening_factor == 1.0


def test_unknown_flag_errors():
    with pytest.raises(SystemExit):
        _run(["scene.json", "out", "--nonsense"])
