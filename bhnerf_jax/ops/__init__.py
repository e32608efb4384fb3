from bhnerf_jax.ops import gr
