"""Test configuration: run the whole suite on a virtual 8-device CPU mesh so
multi-device sharding logic is exercised without GPU hardware (SURVEY.md
§4).  The config updates run before any backend initializes."""
import jax

from line3d_tpu.utils.xla_cache import enable_persistent_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
enable_persistent_cache()
