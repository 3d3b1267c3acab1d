"""Multi-sequence batching and the multi-process layer (PyTorch
counterpart of rebvo_tpu/parallel/)."""
