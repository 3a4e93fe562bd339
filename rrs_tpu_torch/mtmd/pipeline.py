"""Multimodal prompt pipeline: split a prompt on image markers, encode each
image into an embedding chunk, and drive a context with interleaved token
and embedding prefills.

Port of ``rrs_tpu/mtmd/pipeline.py`` (``IMAGE_MARKER``,
``decode_image_b64``, ``decode_audio_b64``, ``embed_images``,
``_prefill_chunk``, ``multimodal_prefill``, ``generate_with_images``). Images
decode through ``mtmd/image_io.py`` (PNG without Pillow); WAV audio through
the standard library's ``wave``, resampled to 16 kHz for ``mtmd/audio.py``.
A Qwen2-VL chunk carries its merged grid for the M-RoPE rows of
``prefill_embeds``; an audio chunk is plain rows and uses the same marker.
"""

from __future__ import annotations

import base64
import io

import numpy as np
import torch

from rrs_tpu_torch.mtmd.clip import (MERGERS, ClipConfig, ClipWeights, encode_image,
                                     encode_image_minicpmv, encode_image_pixtral,
                                     encode_image_qwen2vl, preprocess_image,
                                     preprocess_image_qwen2vl)

IMAGE_MARKER = "<__image__>"     # mtmd's default media marker


def decode_image_b64(data: str) -> np.ndarray:
    """base64 (optionally a data: URL) -> uint8 RGB [H, W, 3]; a format
    that cannot be decoded raises ValueError."""
    from rrs_tpu_torch.mtmd.image_io import decode_image

    if data.startswith("data:"):
        data = data.split(",", 1)[1]
    return decode_image(base64.b64decode(data))


def decode_audio_b64(data: str) -> np.ndarray:
    """base64 (optionally a data: URL) WAV -> mono f32 PCM at 16 kHz: 8-bit
    unsigned, 16- or 32-bit signed PCM, the channels averaged, a linear
    resample. A payload that ``wave`` cannot read raises ValueError."""
    import wave

    if data.startswith("data:"):
        data = data.split(",", 1)[1]
    try:
        with wave.open(io.BytesIO(base64.b64decode(data))) as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
    except (wave.Error, EOFError) as e:
        raise ValueError(f"cannot decode the audio as WAV: {e}") from e
    if width == 2:
        x = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(frames, np.uint8).astype(np.float32) - 128) / 128.0
    elif width == 4:
        x = np.frombuffer(frames, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(-1)
    if sr != 16000:
        n_out = int(round(x.size * 16000 / sr))
        x = np.interp(np.linspace(0, x.size - 1, n_out), np.arange(x.size), x).astype(np.float32)
    return x


def embed_images(cfg: ClipConfig, weights: ClipWeights, images) -> list:
    """Encode images -> a list of [n_tokens, n_embd_llm] f32 chunks on the
    tower's device; a Qwen2-VL / Qwen2.5-VL chunk is (chunk, (gh, gw)) with
    the merged grid for its M-RoPE positions."""
    out = []
    for img in images:
        if cfg.projector_type in MERGERS:
            patches, (gh, gw) = preprocess_image_qwen2vl(img, cfg)
            emb = encode_image_qwen2vl(cfg, weights, patches, (gh, gw))
            m = cfg.spatial_merge
            out.append((emb, (gh // m, gw // m)))
        elif cfg.projector_type == "pixtral":
            # dynamic resolution, no merge; [IMG_BREAK] rows ride in the chunk
            patches, grid = preprocess_image_qwen2vl(img, cfg)
            out.append(encode_image_pixtral(cfg, weights, patches, grid))
        elif cfg.projector_type == "resampler":
            out.append(encode_image_minicpmv(cfg, weights, preprocess_image(img, cfg)))
        else:
            out.append(encode_image(cfg, weights, preprocess_image(img, cfg)))
    return out


def _prefill_chunk(ctx, seq_id: int, chunk):
    """One image chunk -> ``prefill_embeds``, with the M-RoPE grid when the
    chunk carries one."""
    if isinstance(chunk, tuple):
        emb, grid = chunk
        return ctx.prefill_embeds(seq_id, emb, mrope_grid=grid)
    return ctx.prefill_embeds(seq_id, chunk)


def multimodal_prefill(ctx, vocab, seq_id: int, prompt: str, image_chunks: list) -> torch.Tensor:
    """Tokenize the prompt around IMAGE_MARKERs and interleave token and
    embedding prefills. Returns the final logits row [V]."""
    parts = prompt.split(IMAGE_MARKER)
    if len(parts) - 1 != len(image_chunks):
        raise ValueError(f"prompt has {len(parts) - 1} image markers but "
                         f"{len(image_chunks)} images were provided")
    logits = None
    for i, part in enumerate(parts):
        if part:
            toks = vocab.encode(part, add_special=(i == 0))
            if toks:
                logits = ctx.prefill(seq_id, toks)
        if i < len(image_chunks):
            logits = _prefill_chunk(ctx, seq_id, image_chunks[i])
    if logits is None:
        raise ValueError("empty multimodal prompt")
    return logits[-1]


def generate_with_images(ctx, vocab, prompt: str, images, clip_cfg: ClipConfig,
                         clip_weights: ClipWeights, max_new_tokens: int = 64,
                         stop_tokens: tuple = ()) -> list[int]:
    """Greedy multimodal generation (mtmd-cli's analog)."""
    chunks = embed_images(clip_cfg, clip_weights, images)
    seq = ctx.new_sequence()
    try:
        last = multimodal_prefill(ctx, vocab, seq, prompt, chunks)
        out = []
        for _ in range(max_new_tokens):
            tok = int(torch.argmax(last))
            if tok in stop_tokens:
                break
            out.append(tok)
            last = ctx.decode({seq: tok})[seq]
        return out
    finally:
        ctx.kv.seq_rm(seq)
