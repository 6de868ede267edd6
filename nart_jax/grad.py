"""Differentiable rendering: gradients w.r.t. scene/material/light params.

Role parity: the reference has no differentiable pass; BASELINE.json's north
star requires "path-replay backprop producing pixel gradients w.r.t. material
roughness/albedo, textures and light radiance".  Implementation (JAX-native
equivalent of path replay):

  * every sampling *decision* (directions, lobe/light choices, RR) is
    detached (stop_gradient) — the standard detached-sampling estimator:
    grad E[f/p] = E[grad f / p] with p and the sample fixed;
  * the bounce loop runs with a static trip count and `jax.checkpoint` on
    the bounce body, so the backward pass *replays* each bounce (recomputes
    it from the carried wavefront state) instead of storing intermediates —
    memory O(wavefront), one extra forward of compute, exactly the
    replay/recompute trade of path-replay backprop;
  * geometry (BVH traversal, hit positions) carries no tangents, so the
    `while_loop` traversal stays untouched by AD.

Trainable parameters: a dict pytree extracted from SceneData.  Gradients are
exact for the detached estimator and validated against finite differences in
tests/test_grad.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import camera, film, rng, sampling
from .accel import build_bvh
from .integrators import path as path_integrator
from .scene import SceneData

TRAINABLE_FIELDS = (
    "rho_d_const",
    "rho_s_const",
    "tau_const",
    "alpha_const",
    "eta_const",
    "tex_data",
)


def get_params(scene: SceneData):
    """Extract the trainable parameter pytree from a scene.

    Light radiance is fully trainable (north star: gradients w.r.t.
    "textures and light radiance"): per-light constant Le, the env-map
    Le TEXTURE image (None for constant lights — a None pytree entry
    carries no leaves), and the scalar intensity multiplier.  Note the
    env light's 2D importance CDF is built from the texture at scene load
    and intentionally NOT rebuilt per step: sampling pdfs are detached
    decisions, so the estimator stays unbiased (just progressively less
    importance-matched) as the texture trains away from its initial value.
    """
    theta = {f: jnp.asarray(getattr(scene, f)) for f in TRAINABLE_FIELDS}
    theta["light_le"] = [jnp.asarray(li.le_const) for li in scene.lights]
    theta["light_le_tex"] = [
        None if li.le_tex is None else jnp.asarray(li.le_tex)
        for li in scene.lights
    ]
    theta["light_intensity"] = [
        jnp.asarray(li.intensity) for li in scene.lights
    ]
    if scene.medium is not None:
        # differentiable volume rendering: event probabilities carry
        # p/detach(p) ratios (integrators/volume.py), so sigma_a/sigma_s/
        # density/Le all receive gradients.  The majorant is a static
        # detached bound — keep density under it when optimising.
        theta["medium"] = {
            "sigma_a": jnp.asarray(scene.medium.sigma_a),
            "sigma_s": jnp.asarray(scene.medium.sigma_s),
            "le": jnp.asarray(scene.medium.le),
            "density": jnp.asarray(scene.medium.density),
        }
    return theta


def put_params(scene: SceneData, theta):
    """Rebuild a scene with parameters replaced by theta."""
    kw = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    for f in TRAINABLE_FIELDS:
        kw[f] = theta[f]
    kw["lights"] = [
        dataclasses.replace(li, le_const=le, le_tex=le_tex, intensity=inten)
        for li, le, le_tex, inten in zip(
            scene.lights,
            theta["light_le"],
            theta["light_le_tex"],
            theta["light_intensity"],
        )
    ]
    if scene.medium is not None and "medium" in theta:
        kw["medium"] = dataclasses.replace(scene.medium, **theta["medium"])
    return SceneData(**kw)


def render_lanes(scene, bvh, params, width, height, spp, seed_base=0,
                 return_aux=False):
    """Differentiable per-pixel radiance (no film filter): (N, 3).

    Averages spp samples per pixel with the same RNG stream discipline as
    the forward renderer (seeds are y * totalWidth + x where totalWidth
    includes the filter border — render.cpp:81-82 / render._setup_jit).

    With return_aux=True also returns {"unfinished": int32} — the total
    volume-walk lanes that exceeded trace_diff's static step bound across
    all spp passes.  unfinished > 0 means radiance/gradients silently lost
    tail terms; callers should surface it (loss_and_grad raises).
    """
    n = width * height
    idx = jnp.arange(n, dtype=jnp.int32)
    px = idx % width
    py = idx // width
    total_w = width + 2 * int(np.ceil(params.filter_width))
    state = rng.seed(py * total_w + px + seed_base)
    samples, state = sampling.latin_square(state, spp)

    if params.integrator == "volume":
        from .integrators import volume as volume_integrator

        def tracer(o, d, state):
            # statically-bounded replayable walk (reverse AD cannot
            # transpose the production while_loop); 512 flight steps
            # covers any practical walk at reference majorants
            l, a, state, rays, unfinished = volume_integrator.trace_diff(
                scene, bvh, o, d, state, params
            )
            return l, a, state, unfinished
    else:
        def tracer(o, d, state):
            l, a, state, _ = path_integrator.trace(
                scene, bvh, o, d, state, params, differentiable=True
            )
            return l, a, state, jnp.zeros((), jnp.int32)

    def spp_body(i, carry):
        acc, state, unfinished = carry
        s = samples[:, i]
        o, d = camera.cast_rays(
            scene.cam_to_world, scene.fov, width, height, px, py, s
        )
        l, a, state, unf = tracer(o, d, state)
        return acc + l, state, unfinished + unf

    acc, _, unfinished = jax.lax.fori_loop(
        0, spp, spp_body,
        (jnp.zeros((n, 3)), state, jnp.zeros((), jnp.int32)),
    )
    out = acc / np.float32(spp)
    if return_aux:
        return out, {"unfinished": unfinished}
    return out


def radiance_weighted_loss_and_grad(
    scene,
    theta,
    bvh,
    samples,
    cot,
    params,
    width,
    height,
    chunk_base=0,
    lanes=0,
    n_rounds=None,
):
    """Value+grad of sum(cot * per-sample radiance) — balanced wavefront.

    The high-throughput fwd+bwd path: path-replay backprop over the
    work-queue wavefront.  Any image loss linearises to this form (the
    film splat is linear in the per-sample radiance, so cot = d loss /
    d la is computable from a forward render).

    Two-phase: a cheap non-differentiable forward (while_loop) measures
    the exact round count for this chunk, then a statically-bounded,
    per-round-checkpointed fori_loop runs under value_and_grad (reverse AD
    needs the static trip count; decisions are deterministic per work
    item, so the replay traces the identical paths).

    Pass n_rounds (from a previous call at the same scene/chunk shape — the
    round count is deterministic per theta) to skip the measuring forward.
    Round counts DRIFT with theta (lobe/RR decisions sample from
    theta-dependent distributions), so a stale cached n_rounds can be too
    small: the replay then reports unfinished lanes and this function
    re-measures and retries instead of failing — a training loop caching
    n_rounds across optimizer steps pays at most one extra recompile when
    the padded count grows.

    Returns (loss, grads, rays, n_rounds) where rays counts the AD
    forward's traced rays (one forward pass's worth).
    """
    scene = jax.tree_util.tree_map(jnp.asarray, scene)

    def measure():
        # measure at the CURRENT theta: round counts depend on it (lobe
        # choices sample u < fresnel(eta), RR on beta)
        _, _, rounds = _measure_rounds_jit(
            put_params(scene, theta), bvh, samples, params, width, height,
            chunk_base, lanes,
        )
        # pad up: fewer recompiles across chunks/steps (extra rounds are
        # cheap no-ops at the small auto lane counts)
        pad = 4 if int(rounds) < 64 else 16
        return int(np.ceil(max(int(rounds), 1) / pad) * pad)

    if n_rounds is None:
        n_rounds = measure()

    for attempt in range(3):
        (loss, (rays, unfinished)), grads = _balanced_grad_jit(
            scene,
            theta,
            bvh,
            samples,
            cot,
            params,
            width,
            height,
            n_rounds,
            chunk_base,
            lanes,
        )
        if not int(unfinished):
            return loss, grads, rays, n_rounds
        # theta drifted past the cached round count: re-measure against the
        # CURRENT scene (which embeds theta via the caller) and grow.  The
        # pow-of-pad n_rounds bounds recompiles across steps.
        n_rounds = max(measure(), 2 * n_rounds)
    raise AssertionError(
        f"balanced grad replay truncated: {int(unfinished)} lanes alive "
        f"after {n_rounds} rounds (3 regrow attempts)"
    )


def _measure_rounds_jit(
    scene, bvh, samples, params, width, height, chunk_base, lanes
):
    # shares render._trace_balanced_jit's cache entry: a flow that already
    # rendered forward (bench, training loop) measures rounds for free
    from . import render as render_mod

    return render_mod._trace_balanced_jit(
        samples, scene, bvh, params, width, height, chunk_base,
        n_lanes=lanes,
    )


def _balanced_loss_fn(params):
    if params.integrator == "volume":
        from .integrators import volume as volume_integrator

        # replay counterpart of the static-assignment forward the
        # measuring pass (_measure_rounds_jit -> trace_vol_static) ran
        return volume_integrator.trace_vol_static_loss
    return path_integrator.trace_balanced_loss


@functools.partial(
    jax.jit,
    static_argnames=("params", "width", "height", "n_rounds", "lanes"),
)
def _balanced_grad_jit(
    scene,
    theta,
    bvh,
    samples,
    cot,
    params,
    width,
    height,
    n_rounds,
    chunk_base,
    lanes,
):
    loss_fn = _balanced_loss_fn(params)

    def f(theta):
        scn = put_params(scene, theta)
        loss, rays, unfinished = loss_fn(
            scn, bvh, samples, cot, params, width, height, n_rounds,
            chunk_base=chunk_base, n_lanes=lanes,
        )
        return loss, (rays, unfinished)

    return jax.value_and_grad(f, has_aux=True)(theta)


def loss_and_grad(scene, params, width, height, spp, loss_fn, leaf_size=8,
                  volume_grad="balanced"):
    """Value+grad of loss_fn(image (H,W,3)) w.r.t. the trainable params.

    Volume scenes route through the balanced work-queue replay by default
    (volume_grad="balanced"): the image loss linearises exactly — the
    per-pixel image is the spp-mean of the per-sample radiance, so
    cot = d loss / d la comes from one cheap forward render — and the
    backward pass replays at full wavefront utilisation instead of the
    lockstep trace_diff's O(all-lanes x 512-step) walk (~20x wall on a
    128^2 volume scene; volume_grad="lockstep" keeps the old path, whose
    per-pixel RNG streams match the sequential reference exactly).

    Returns (loss, grads_dict).
    """
    bvh = build_bvh(np.asarray(scene.tri_v), leaf_size=leaf_size)
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    theta0 = get_params(scene)

    if params.integrator == "volume" and volume_grad == "balanced":
        return _volume_loss_and_grad_balanced(
            scene, theta0, bvh, params, width, height, spp, loss_fn
        )

    @jax.jit
    def f(theta):
        scn = put_params(scene, theta)
        lanes, aux = render_lanes(
            scn, bvh, params, width, height, spp, return_aux=True
        )
        return loss_fn(lanes.reshape(height, width, 3)), aux

    (loss, aux), grads = jax.value_and_grad(f, has_aux=True)(theta0)
    if int(aux["unfinished"]):
        raise AssertionError(
            f"volume trace_diff truncated: {int(aux['unfinished'])} walks "
            "exceeded the static step bound; radiance/gradients lost tail "
            "terms (raise n_steps or lower the majorant)"
        )
    return loss, grads


def _volume_loss_and_grad_balanced(
    scene, theta0, bvh, params, width, height, spp, loss_fn
):
    """Image-loss volume gradients via the balanced replay machine.

    Phase 1: one non-differentiable balanced forward gives the per-sample
    radiance la; the image is its spp-mean (matching render_lanes'
    no-filter semantics), so d loss / d la = (d loss / d image) / spp —
    the exact linearisation of any image loss.  Phase 2 hands that
    cotangent to radiance_weighted_loss_and_grad (trace_balanced_loss),
    which replays the identical per-item decisions under AD.
    """
    from . import render as render_mod

    n = width * height
    idx = jnp.arange(n, dtype=jnp.int32)
    px = idx % width
    py = idx // width
    total_w = width + 2 * int(np.ceil(params.filter_width))
    samples, _ = render_mod._setup_jit(px, py, total_w, spp)

    scn0 = put_params(scene, theta0)
    la, _, _ = render_mod._trace_balanced_jit(
        samples, scn0, bvh, params, width, height, jnp.int32(0)
    )
    image = jnp.mean(la[..., :3], axis=0).reshape(height, width, 3)
    loss, g_img = jax.value_and_grad(loss_fn)(image)
    cot = jnp.concatenate(
        [
            jnp.broadcast_to(
                g_img.reshape(1, n, 3) / np.float32(spp), (spp, n, 3)
            ),
            jnp.zeros((spp, n, 1)),
        ],
        axis=-1,
    )
    _, grads, _, _ = radiance_weighted_loss_and_grad(
        scene, theta0, bvh, samples, cot, params, width, height
    )
    return loss, grads
