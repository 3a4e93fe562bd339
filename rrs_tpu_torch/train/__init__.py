"""train modules of rrs_tpu_torch (see rrs_tpu/train)."""
