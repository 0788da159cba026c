"""The one place that decides platform, kernel and backend.

On a GPU the hand-written kernels run (there is no silent fallback: a
kernel that fails to compile fails the run) and the "auto" backends of
diffusion / refinement resolve to their jitted device formulations.  On
the CPU (tests, golden runs) the plain XLA twins run and "auto" keeps the
float64 host reference paths.
"""
from __future__ import annotations

import contextlib

_twins_forced = False


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax
    return jax.default_backend() == "gpu"


def use_kernels() -> bool:
    """Hand-written kernels on the GPU, the plain XLA twins elsewhere (and
    inside `twins_only`)."""
    return on_gpu() and not _twins_forced


@contextlib.contextmanager
def twins_only():
    """Run the plain XLA twins even on the GPU — the reference a kernel's
    output is compared with on the card.  The kernel choice is made at
    trace time, so jit caches are cleared on entry and exit."""
    import jax
    global _twins_forced
    jax.clear_caches()
    _twins_forced = True
    try:
        yield
    finally:
        _twins_forced = False
        jax.clear_caches()


def resolve_auto_backend(value: str) -> str:
    """"auto" -> "device" on a GPU, "host" otherwise; explicit values pass
    through."""
    if value != "auto":
        return value
    return "device" if on_gpu() else "host"
