from bhnerf_jax.train.optimizer import (LogFn, Optimizer, TemporalBatchedArgs,
                                        TrainStep, total_movie_loss)
from bhnerf_jax.train.state import (TrainState, make_optimizer,
                                    restore_checkpoint, restore_params,
                                    save_checkpoint)
from bhnerf_jax.train.step import (RayTracingArgs, loss_fn_eht,
                                   loss_fn_image, image_plane_prediction,
                                   make_step_fns, raytracing_args)
