"""io of the PyTorch/CUDA port (counterpart: fastapriori_tpu/io/)."""
