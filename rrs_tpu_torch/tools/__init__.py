"""tools modules of rrs_tpu_torch (see rrs_tpu/tools)."""
