"""Reference-API compatibility facade for the GR geometry layer.

The reference exposes geodesics + tensor algebra under `bhnerf.kgeo`
(reference bhnerf/kgeo.py). Here the implementations live in
`bhnerf_jax.geodesics` (ray tracing) and `bhnerf_jax.ops.gr` (tensor
algebra); this module re-exports them under the reference names so code
written against the reference ports by changing the import root.
"""
from bhnerf_jax.geodesics.dataset import (Geodesics, image_plane_geos,
                                          trace_geodesics)
from bhnerf_jax.ops.gr import (azimuthal_velocity_vector, doppler_factor,
                               fluid_frame_tetrad, inv_metric_components,
                               magnetic_field_fluid_frame,
                               metric_components, parallel_transport,
                               parallel_transport_zamo,
                               radiative_trasfer, radiative_transfer,
                               raise_or_lower_indices,
                               transform_coordinates, wave_vector,
                               zamo_frame_tetrad, zamo_frame_velocity)
from bhnerf_jax.geodesics import equatorial as equatorial_lensing


def spacetime_metric(geos):
    """Reference kgeo.py:118-143 signature on a Geodesics bundle."""
    return metric_components(geos.r, geos.theta, geos.spin, geos.M)


def spacetime_inv_metric(geos):
    """Reference kgeo.py:145-171 signature on a Geodesics bundle."""
    return inv_metric_components(geos.r, geos.theta, geos.spin, geos.M)


def magnetic_field_spherical(geos, b_r, b_th, b_ph):
    """Constant/spatially-varying spherical B components stacked on a
    trailing mu axis (reference kgeo.py:250-272)."""
    import numpy as np
    shape = geos.r.shape
    comps = [np.broadcast_to(np.asarray(c, dtype=float), shape)
             for c in (b_r, b_th, b_ph)]
    return np.stack(comps, axis=-1)
