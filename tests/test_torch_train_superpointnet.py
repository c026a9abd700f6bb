"""SuperPointNet (version n) through the port's train and val steps against the JAX
package's, on the CPU in f32 at 64x64: one micro-step (losses, gradients,
BatchNorm statistics), one val step (losses, views, keypoints and their
descriptors) and the freeze mask of `TrainAgent`. The tests and their
tolerances: `tests/torch_step_compare.py`."""

from tests.torch_step_compare import (  # noqa: F401  (the shared tests and fixtures)
    family,
    runs,
    test_batchnorm_statistics_match,
    test_freeze_mask_matches_jax,
    test_gradients_match,
    test_train_losses_match,
    test_val_step_matches,
)

FAMILY = "SuperPointNet"
HOST_WARP = False
