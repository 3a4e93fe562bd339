"""Tensor, data and pipeline parallelism (port of ``rrs_tpu/parallel``)."""
