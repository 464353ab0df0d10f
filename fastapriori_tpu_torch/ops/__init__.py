"""ops of the PyTorch/CUDA port (counterpart: fastapriori_tpu/ops/)."""
