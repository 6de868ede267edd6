"""Checkpoint/resume: resumed render must equal uninterrupted render."""

import os

import numpy as np

from nart_jax import render as render_mod
from tests import scenes


def test_resume_bit_identical(tmp_path):
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=6, image_height=6, spp=4, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    full = sess.render()

    ck = str(tmp_path / "ck.npz")
    # run with checkpoint every 2 spp, then simulate a crash + resume
    sess2 = render_mod.RenderSession(scene, params)
    sess2.render(checkpoint_path=ck, checkpoint_every=2)
    assert os.path.exists(ck)
    sess3 = render_mod.RenderSession(scene, params)
    resumed = sess3.render(checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(full, resumed)


def test_checkpoint_param_mismatch(tmp_path):
    import dataclasses

    import pytest

    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=6, image_height=6, spp=4, bounces=3, filter_width=1.0
    )
    ck = str(tmp_path / "ck.npz")
    sess = render_mod.RenderSession(scene, params)
    sess.render(checkpoint_path=ck, checkpoint_every=2)
    from nart_jax import checkpoint as ckpt

    with pytest.raises(ValueError):
        ckpt.load(ck, dataclasses.replace(params, bounces=5))
