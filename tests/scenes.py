"""Re-export of the programmatic test scenes (see nart_jax.testing)."""

from nart_jax.testing import quad, simple_scene  # noqa: F401
