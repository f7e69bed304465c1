"""Training of the port: criterion, train and eval steps, trainer
(counterparts of parallelwavegan_tpu/train/)."""
