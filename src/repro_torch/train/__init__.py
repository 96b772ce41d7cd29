"""Training of the port on one device: the chunked-CE train step with
gradient and weight compression (`train_step`) and the loop with
checkpoint/restart, NaN guard and straggler handling (`trainer`)."""
