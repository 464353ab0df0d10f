"""models of the PyTorch/CUDA port (counterpart: fastapriori_tpu/models/)."""
