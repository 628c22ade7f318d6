"""Training: steps of `train/loop.py::make_train_step` over a `TrainState`,
fed `rows_3d` 3D and `rows_2d` 2D rows of source tiles a step from a pool
of device-resident batches (`harness/traffic.py::train_pool`)."""
from harness.training import Training as Kind  # noqa: F401
