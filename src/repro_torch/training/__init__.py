"""Training stack: AdamW, int8 gradient compression with error feedback,
the synthetic data streams, fault-tolerant checkpoints and the train-step
factory. Counterpart of ``repro.training``."""
