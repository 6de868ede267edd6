#!/usr/bin/env python3
"""Count the balanced wavefront's rounds per device on a virtual CPU mesh.

A proxy for how evenly sharding.py spreads work over cards, made on the
8-virtual-device CPU mesh (the same device-count-invariant program
chip_smoke.py --cards runs on GPUs):

  * per-device balanced-wavefront ROUND COUNTS at a realistic config —
    if every round cost the same on every card, wall time per device
    would follow its round count, and mean/max rounds would bound the
    data-parallel efficiency from above (unmeasured on the GPU);
  * DRAIN-TAIL fraction — rounds a device spends after its queue empties
    (lanes finishing their last items), the only intrinsically serial
    part of the schedule;
  * PSUM byte volume — the only collectives in a render step are the slab
    film merge and (training) the parameter-gradient all-reduce, both
    O(output), independent of spp and bounce count.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/scaling_evidence.py [size] [spp]
(jax is forced to the cpu platform internally.)
"""

import json
import os
import sys

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import functools

import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from nart_jax import render as render_mod
from nart_jax import rng, sampling
from nart_jax.accel import build_bvh
from nart_jax.integrators import path as path_integrator
from nart_jax.sharding import make_mesh, _put
from nart_jax.testing import simple_scene


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    n_dev = len(jax.devices())
    scene = simple_scene(("glass", "glass", "lambert"), priorities=[2, 3, 0])
    params = render_mod.RenderParams(
        image_width=size, image_height=size, spp=spp, bounces=10,
        filter_width=2.0, roughening_factor=0.2, accel="brute",
    )
    bvh = build_bvh(np.asarray(scene.tri_v))
    mesh = make_mesh()
    axis = mesh.axis_names[0]
    rows = -(-size // n_dev)
    p_local = rows * size
    total_w = size + 4

    strip_rows = 8  # the production striped assignment (sharding.py)
    strips_per_dev = -(-(-(-size // strip_rows)) // n_dev)
    mode = os.environ.get("NART_SCALING_MODE", "striped")

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(), P(axis)), out_specs=P(axis),
        check_vma=False,
    )
    def shard_stats(scene, dev_ids):
        dev = dev_ids[0]
        local = jnp.arange(p_local, dtype=jnp.int32)
        px = local % size
        if mode == "striped":
            local_row = jnp.arange(rows, dtype=jnp.int32)
            row_map = (
                (local_row // strip_rows * n_dev + dev) * strip_rows
                + local_row % strip_rows
            )
            py = row_map[local // size]
        else:  # contiguous slabs (the pre-striping assignment)
            row_map = None
            py = dev * rows + local // size
        state = rng.seed(py * total_w + px)
        samples, _ = sampling.latin_square(state, spp)
        samples = jnp.swapaxes(samples, 0, 1)

        core0, step = path_integrator._balanced_machine(
            scene, bvh, samples, params, size, rows,
            chunk_base=0, n_lanes=0,
            pix_offset=dev * rows * size, n_pix_total=size * size,
            row_map=row_map,
        )
        total = spp * p_local

        def cond(carry):
            core, rounds, drain = carry
            return jnp.any(core[0].alive)

        def body(carry):
            core, rounds, drain = carry
            draining = core[3] >= total  # queue head past the last item
            core, dying, la, item = step(core)
            return core, rounds + 1, drain + draining.astype(jnp.int32)

        core, rounds, drain = jax.lax.while_loop(
            cond, body, (core0, jnp.int32(0), jnp.int32(0))
        )
        rays = core[0].rays
        return jnp.stack([rounds, drain])[None, :], rays[None]

    dev_ids = np.arange(n_dev, dtype=np.int32)
    stats, rays = jax.jit(shard_stats)(
        _put(mesh, jax.tree_util.tree_map(np.asarray, scene), P()),
        _put(mesh, dev_ids, P(axis)),
    )
    stats = np.asarray(stats)  # (n_dev, 2)
    rays = np.asarray(rays)
    rounds = stats[:, 0].astype(float)
    drain = stats[:, 1].astype(float)

    # psum volumes (per step, per device)
    k = 2 * int(np.ceil(params.filter_width)) + 1
    film_bytes = (rows * n_dev + k) * (total_w + k) * 5 * 4
    from nart_jax import grad as grad_mod

    theta = grad_mod.get_params(
        jax.tree_util.tree_map(jnp.asarray, scene)
    )
    grad_bytes = sum(
        x.size * 4 for x in jax.tree_util.tree_leaves(theta)
    )

    out = {
        "config": f"{size}x{size}@{spp}spp bounces=10 (glass nested scene)",
        "row_assignment": mode,
        "n_devices": n_dev,
        "rounds_per_device": rounds.tolist(),
        "rounds_mean": float(rounds.mean()),
        "rounds_max": float(rounds.max()),
        "round_balance_efficiency": float(rounds.mean() / rounds.max()),
        "drain_tail_rounds": drain.tolist(),
        "drain_tail_fraction": float((drain / rounds).mean()),
        "rays_per_device": rays.tolist(),
        "psum_film_bytes_per_step": film_bytes,
        "psum_grad_bytes_per_step": grad_bytes,
        "note": (
            "round counts on the CPU mesh, a proxy for balance: "
            "efficiency bound = mean/max rounds if rounds cost the same; "
            "collectives are O(output), independent of spp"
        ),
    }
    print(json.dumps(out, indent=1))

if __name__ == "__main__":
    main()
