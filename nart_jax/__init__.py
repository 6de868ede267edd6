"""nart-jax: a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the nart
renderer (a C++14 CPU path tracer).  The compute
path is a wavefront architecture: SoA ray/hit/shade buffers advanced by a
per-bounce pipeline under `lax.fori_loop`, fully jit-compiled, sharded over a
`jax.sharding.Mesh` for multi-device scaling, and differentiable via
path-replay-style rematerialised backprop.

Layer map (bottom → top), mirroring the reference's layering (SURVEY.md §1):

  rng.py          counter/state-based Xorshift32 streams (rng.h parity)
  sampling.py     sampling warps (sampling.cpp parity)
  exr.py          EXR image I/O (OpenEXR lib via ctypes + pure-Python codec)
  geo.py          .geo mesh parsing + fan triangulation (scene.cpp parity)
  vol.py          .vol density-grid parsing
  scene.py        JSON scene -> frozen SoA pytree of device arrays
                  (texture patterns live in materials.py; the env-map 2D
                  CDF build/sample/pdf in scene.py + lights.py)
  camera.py       pinhole ray generation
  geometry.py     watertight ray-triangle intersection (vectorised)
  select.py       small-K one-hot select/update helpers (gather-free)
  accel.py        LBVH build (Morton) + wavefront traversal
  pallas_accel.py the LBVH walk as one Pallas kernel (GPU, Triton route)
  bxdf.py         5 BSDF lobes + aggregation (branchless, differentiable)
  lights.py       disk / ring / environment / distant lights + MIS pdfs
  media.py        density grids, majorants, delta tracking
  film.py         Gaussian filter splatting (scatter-add film)
  integrators/    wavefront path + volume integrators
  render.py       render session orchestration (spp loop, jit)
  sharding.py     device-mesh sharding of pixels/film, psum merges
  grad.py         differentiable rendering entry points
  cli.py          `nart-jax <scene.json> <out>` flag-compatible CLI
"""

__version__ = "0.1.0"

import os as _os

# the checkout's own compile cache (listed in .gitignore)
CACHE_ROOT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _host_key() -> str:
    """Stable digest of the host CPU's model and feature flags.

    XLA's cache key does not cover host CPU features, and CPU executables
    compiled for one host generation crash when loaded on another, so
    entries live under a directory named by this key."""
    import hashlib
    import platform

    bits = [platform.machine(), platform.processor()]
    seen = set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:  # the first core's lines identify the host
                k = line.split(":", 1)[0].strip()
                if k in ("flags", "model name", "Features") and k not in seen:
                    seen.add(k)
                    bits.append(line.strip())
    except OSError:
        pass
    return hashlib.sha1("|".join(bits).encode()).hexdigest()[:8]


def compile_cache_dir() -> str:
    """Where this checkout keeps compiled programs when
    JAX_COMPILATION_CACHE_DIR is not set."""
    return _os.path.join(CACHE_ROOT, "host-" + _host_key())


def _enable_persistent_compile_cache() -> None:
    """Point JAX's persistent compilation cache at a fixed directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX's own config already holds
    it and nothing is set here.
    """
    import jax

    if jax.config.jax_compilation_cache_dir is not None:
        return
    cache = compile_cache_dir()
    try:
        _os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except OSError:
        pass  # the cache is an optimisation only: never fail import


_enable_persistent_compile_cache()
