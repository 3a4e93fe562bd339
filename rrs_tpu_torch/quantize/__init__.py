"""The port's quantizer and imatrix collector (``python -m rrs_tpu_torch quantize | imatrix``)."""
