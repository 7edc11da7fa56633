"""Training: data, the train step, the optimizer and the Trainer
(counterpart of `tony_tpu/train/`, single device). The entry point is
``python -m tony_tpu_torch.train``."""
