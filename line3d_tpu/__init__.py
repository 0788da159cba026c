"""line3d_tpu — line-based multi-view stereo on an accelerator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
manhofer/Line3D (GCPR 2015): 2D line segment detection, epipolar pairwise
matching, multi-view support scoring, replicator-dynamics diffusion,
graph clustering, and 3D line model output — array-first, fixed shapes,
sharded over device meshes.
"""

from .config import L3DConfig, DEFAULT_CONFIG
from .pipeline import Line3D

__version__ = "0.1.0"
__all__ = ["Line3D", "L3DConfig", "DEFAULT_CONFIG"]
