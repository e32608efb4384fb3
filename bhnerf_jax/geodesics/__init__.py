from bhnerf_jax.geodesics import kerr
from bhnerf_jax.geodesics.dataset import Geodesics, image_plane_geos, trace_geodesics
