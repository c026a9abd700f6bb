"""The host-warp feed through the port's train and val steps against the
JAX package's, on the CPU in f32 (YOLOPoint-n, 64x64): both steps build
their views from the JAX loader's payload (`host_warp_views`, a
zero-channel image stub) and the JAX package's own photometric and
descriptor draws. One micro-step (losses, gradients, BatchNorm
statistics), one val step (losses, views, keypoints and their
descriptors). The tests and their tolerances: `tests/torch_step_compare.py`."""

from tests.torch_step_compare import (  # noqa: F401  (the shared tests and fixtures)
    family,
    runs,
    test_batchnorm_statistics_match,
    test_gradients_match,
    test_train_losses_match,
    test_val_step_matches,
)

FAMILY = "YOLOPoint"
HOST_WARP = True
