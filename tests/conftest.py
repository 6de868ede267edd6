"""Test configuration: run on CPU with 8 virtual devices.

This is the standard JAX pattern for exercising shard_map code without a
multi-card host (SURVEY.md §4): the same sharded programs that run over the
cards of a GPU host compile and execute on the virtual CPU mesh, so sharding
invariants (determinism, psum correctness) are tested everywhere.  What runs
only on the card (the Pallas kernel compiled for it, TF32, atomics) is
checked by chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# XLA:CPU JIT code-space budget
#
# XLA:CPU never returns JIT code memory while executables are alive, and its
# allocator's budget is exhausted after ~50 of this suite's large wavefront
# programs in one process: LLVM reports 'Cannot allocate memory' and the next
# compile SEGFAULTS (root-caused in round 4; a 100-compile repro dies at
# iteration ~50 without clearing and completes with it, RSS flat).
#
# The fix is budget-aware rather than calibrated to module sizes: a
# monitoring hook counts actual backend compiles and the per-test fixture
# clears all executable caches once the count since the last clear exceeds
# _COMPILE_BUDGET — no matter how large any one module grows.  A per-module
# clear remains as a cheap secondary bound (it also keeps peak RSS down).
# ---------------------------------------------------------------------------

_COMPILE_BUDGET = 32  # large wavefront programs per process, conservative
_compiles_since_clear = [0]


def _on_event_duration(name, duration, **kw):
    if name == "/jax/core/compile/backend_compile_duration":
        _compiles_since_clear[0] += 1


jax.monitoring.register_event_duration_secs_listener(_on_event_duration)


@pytest.fixture(autouse=True)
def _jit_code_space_budget():
    """Clear compiled-program caches when the compile budget is exhausted."""
    yield
    if _compiles_since_clear[0] >= _COMPILE_BUDGET:
        jax.clear_caches()
        _compiles_since_clear[0] = 0


@pytest.fixture(autouse=True, scope="module")
def _free_jit_code_space():
    """Drop compiled-program caches after every test module (see above)."""
    yield
    jax.clear_caches()
    _compiles_since_clear[0] = 0
