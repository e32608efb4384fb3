from bhnerf_jax.models.fields import (GRID_Predictor, GridPredictor,
                                      NeRF_Predictor, NeRFPredictor,
                                      apply_mlp, init_mlp_params, posenc,
                                      sample_3d_grid)
