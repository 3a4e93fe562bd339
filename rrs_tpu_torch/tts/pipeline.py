"""OuteTTS text to speech (tools/tts/tts.cpp's analog): the TTS language
model generates audio-code tokens -> the WavTokenizer decoder -> spectral
frames -> the inverse DFT and overlap-add -> a 24 kHz WAV.

Port of ``rrs_tpu/tts/pipeline.py``. The language model runs through the
port's context (its kernels on the card), the vocoder as plain torch on its
weights' device, the synthesis as host NumPy.
"""

from __future__ import annotations

import re

# OuteTTS v0.2's audio-code token range (tts.cpp)
CODE_TOKEN_MIN = 151672
CODE_TOKEN_MAX = 155772


def process_text(text: str) -> list[str]:
    """Lowercase, punctuation to spaces or dropped, split into words
    (tts.cpp process_text; numbers are not spelled out)."""
    text = text.lower()
    text = re.sub(r"[-_/,\.\\]", " ", text)
    text = re.sub(r"[^a-zÀ-ſ0-9 ]", "", text)
    return [w for w in text.split() if w]


def format_prompt(text: str) -> str:
    """OuteTTS v0.2's prompt: the words joined by <|text_sep|> between
    <|text_start|> and <|text_end|>, then <|audio_start|>."""
    body = "<|text_sep|>".join(process_text(text))
    return "<|im_start|>\n<|text_start|>" + body + "<|text_end|>\n<|audio_start|>\n"


def extract_codes(tokens: list[int]) -> list[int]:
    """The audio tokens, rebased to vocoder codes."""
    return [t - CODE_TOKEN_MIN for t in tokens if CODE_TOKEN_MIN <= t <= CODE_TOKEN_MAX]


def synthesize(ctx, vocab, vocoder_weights, text: str, max_codes: int = 768,
               out_path="output.wav"):
    """Greedy generation of up to ``max_codes`` tokens (stopping at EOS),
    the vocoder over the audio codes among them, the waveform written as a
    16-bit WAV. Returns (path, number of codes); raises ValueError when the
    model generated no audio code."""
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.tts.dsp import embd_to_audio, save_wav16
    from rrs_tpu_torch.tts.vocoder import vocoder_forward

    toks = vocab.encode(format_prompt(text), add_special=True)
    out = ctx.generate(toks, max_codes, SamplerParams(temperature=0.0),
                       stop_tokens=tuple(t for t in (vocab.eos_id,) if t is not None and t >= 0))
    codes = extract_codes(out)
    if not codes:
        raise ValueError("model generated no audio codes: is this an OuteTTS checkpoint?")
    embd = vocoder_forward(vocoder_weights, codes).cpu().numpy()
    return save_wav16(out_path, embd_to_audio(embd)), len(codes)
