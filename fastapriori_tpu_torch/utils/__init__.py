"""utils of the PyTorch/CUDA port (counterpart: fastapriori_tpu/utils/)."""
