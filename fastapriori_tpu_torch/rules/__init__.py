"""rules of the PyTorch/CUDA port (counterpart: fastapriori_tpu/rules/)."""
