"""Text to speech (see rrs_tpu/tts): the OuteTTS prompt and code
extraction, the WavTokenizer decoder, and the spectral synthesis to a WAV."""
