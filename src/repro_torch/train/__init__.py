"""Training on one device (port of ``repro.train``): AdamW and its
schedule, the train step, checkpoints and the recovery loop."""
