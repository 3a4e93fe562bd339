"""The multimodal front end of rrs_tpu_torch (see rrs_tpu/mtmd): the vision
towers and projectors, image decoding, the Whisper audio tower, and the
prompt pipeline."""
