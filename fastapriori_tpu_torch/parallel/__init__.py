"""The one-process device mesh and its collectives (counterpart:
fastapriori_tpu/parallel/)."""
