"""Training on one device: the differentiable scene parameters and the
inverse-rendering step (sharded.make_train_step). Multi-device rendering
and training are not ported yet."""
