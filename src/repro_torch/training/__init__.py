"""Training of the port (counterpart of ``repro.training``): AdamW, int8
error-feedback compression, checkpoints and the fault-tolerant driver.
The compressed step (``build_train_step_compressed``) waits for the port
of ``repro.distribution.sharding``."""
