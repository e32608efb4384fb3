"""bhnerf_jax — JAX black-hole emission tomography framework.

A ground-up JAX/XLA/Pallas rebuild with the capabilities of the reference
bhnerf package (gravitationally-lensed 3D emission recovery around Kerr
black holes from image-plane movies, EHT visibilities, or ALMA polarized
lightcurves), designed for jit + sharding over device meshes.
"""
from bhnerf_jax import constants, units, utils
from bhnerf_jax import geodesics
from bhnerf_jax import ops
from bhnerf_jax import emission
from bhnerf_jax import models
from bhnerf_jax import parallel
from bhnerf_jax import train
from bhnerf_jax import observation
from bhnerf_jax import alma
from bhnerf_jax import config
from bhnerf_jax import visualization
# reference-API facades (bhnerf.kgeo / bhnerf.network / bhnerf.optimization)
from bhnerf_jax import kgeo
from bhnerf_jax import network
from bhnerf_jax import optimization
