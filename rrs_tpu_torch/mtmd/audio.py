"""Audio towers: the Whisper log-mel front end, the Whisper encoder and the
qwen2-audio / ultravox projectors.

Port of ``rrs_tpu/mtmd/audio.py`` (mtmd-audio.cpp and whisper-enc.cpp's
analog). 16 kHz mono f32 PCM -> log-mel spectrogram (Slaney filterbank,
log10, max - 8 clamp, (x + 4) / 4) -> 3,000-frame chunks -> the encoder (two
conv1d + erf GELU, learned positions, a pre-LN transformer) -> the projector
(qwen2a: one fc; ultravox: stack the rows by ``stack_factor``, RMS norm,
swapped SwiGLU, RMS norm, linear) -> embedding chunks for
``prefill_embeds``. The front end stays host NumPy, as in the JAX package,
so its output is the same bits. The JAX package runs the encoder as plain
jnp with no TPU kernel, so the port's is plain torch: functions over f32
tensors on the weights' device. ``load_audio_mmproj`` reads a clip.cpp
mmproj GGUF with an audio tower through the port's own reader;
``write_audio_mmproj`` writes one of random weights, byte-equal to the JAX
package's for the same config and seed.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rrs_tpu_torch.ops.basic import layer_norm

AUDIO_SR = 16000
N_FFT = 400
HOP = 160
CHUNK_FRAMES = 3000          # the encoder graph accepts 3000 frames a chunk
CHUNK_LEN_S = 30


def mel_filterbank(n_mel: int, n_fft: int, sr: int, fmin: float = 0.0,
                   fmax: float = 0.0) -> np.ndarray:
    """Slaney-scale mel filterbank [n_mel, n_fft // 2 + 1] with area
    normalization (librosa's default), built in float64."""
    if fmax <= 0:
        fmax = sr / 2.0
    min_log_hz = 1000.0
    lin_slope = 3 / 200.0
    min_log_mel = min_log_hz * lin_slope
    log_step = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f < min_log_hz, f * lin_slope,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / log_step)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m < min_log_mel, m / lin_slope,
                        min_log_hz * np.exp((m - min_log_mel) * log_step))

    n_bins = n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * (sr / n_fft)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mel + 2))
    fb = np.zeros((n_mel, n_bins), np.float64)
    for m in range(n_mel):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
        fb[m] *= 2.0 / (hi - lo)            # Slaney area norm
    return fb.astype(np.float32)


def log_mel_spectrogram(samples: np.ndarray, n_mel: int = 128) -> np.ndarray:
    """f32 PCM at 16 kHz -> log-mel [n_mel, n_frames]: padded to 31 s, a
    periodic Hann, no centre padding, the power spectrum, a log10 floor of
    1e-10, the clamp at the global max - 8, then (x + 4) / 4."""
    samples = np.asarray(samples, np.float32).reshape(-1)
    min_samples = AUDIO_SR * (CHUNK_LEN_S + 1)      # a 1 s margin
    if samples.size < min_samples:
        samples = np.pad(samples, (0, min_samples - samples.size))
    n_frames = (samples.size - N_FFT) // HOP + 1
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = samples[idx]                           # [T, 400]
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    spec = np.fft.rfft(frames * hann[None, :], n=N_FFT, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)  # [T, 201]
    mel = power @ mel_filterbank(n_mel, N_FFT, AUDIO_SR).T        # [T, n_mel]
    log_spec = np.log10(np.maximum(mel, 1e-10)).T   # [n_mel, T]
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def chunk_mel(mel: np.ndarray) -> list[np.ndarray]:
    """[n_mel, T] -> its whole 3,000-frame chunks; the trailing partial
    chunk is dropped."""
    return [mel[:, off:off + CHUNK_FRAMES]
            for off in range(0, mel.shape[1] - CHUNK_FRAMES + 1, CHUNK_FRAMES)]


# -- the Whisper encoder and the projectors ------------------------------------

@dataclasses.dataclass
class AudioConfig:
    n_mel: int = 128
    n_embd: int = 384
    n_layers: int = 4
    n_heads: int = 6
    n_ff: int = 1536
    n_embd_llm: int = 2048
    eps: float = 1e-5
    projector: str = "qwen2a"        # "qwen2a" | "ultravox"
    stack_factor: int = 8            # ultravox StackAudioFrames

    @staticmethod
    def from_gguf(md: dict) -> "AudioConfig":
        g = lambda k, d=None: md.get(f"clip.audio.{k}", d)   # noqa: E731
        return AudioConfig(
            n_mel=int(g("num_mel_bins", 128)),
            n_embd=int(g("embedding_length", 384)),
            n_layers=int(g("block_count", 4)),
            n_heads=int(g("attention.head_count", 6)),
            n_ff=int(g("feed_forward_length", 1536)),
            n_embd_llm=int(md.get("clip.audio.projection_dim",
                                  md.get("clip.projector.output_dim", 2048))),
            eps=float(g("attention.layer_norm_epsilon", 1e-5)),
            projector=str(md.get("clip.projector_type", "qwen2a")),
            stack_factor=int(g("projector.stack_factor", 8)),
        )


@dataclasses.dataclass
class AudioLayer:
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wq: torch.Tensor                 # [E, E] for x @ w
    bq: torch.Tensor
    wk: torch.Tensor                 # no k bias (whisper-enc.cpp's check)
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w_up: torch.Tensor               # [E, F]
    b_up: torch.Tensor
    w_down: torch.Tensor             # [F, E]
    b_down: torch.Tensor


@dataclasses.dataclass
class AudioWeights:
    conv1_w: torch.Tensor            # [E, n_mel, 3], conv1d's own layout
    conv1_b: torch.Tensor
    conv2_w: torch.Tensor            # [E, E, 3]
    conv2_b: torch.Tensor
    pos_embd: torch.Tensor           # [n_pos_max, E]
    layers: list
    ln_post_w: torch.Tensor
    ln_post_b: torch.Tensor
    proj: dict                       # qwen2a: fc_w, fc_b; ultravox: norm_pre_w, w1, norm_mid_w, w2

    @property
    def device(self) -> torch.device:
        return self.conv1_w.device

    def nbytes(self) -> int:
        objs = [self, *self.layers]
        ts = [getattr(o, f.name) for o in objs for f in dataclasses.fields(o)]
        ts += list(self.proj.values())
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _conv1d(x, w, b, stride):
    """x [T, Cin]; w [Cout, Cin, 3]; padding 1 each side (ggml_conv_1d_ph)
    -> [T', Cout]."""
    return F.conv1d(x.T[None], w, b, stride=stride, padding=1)[0].T


def _rms(x, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def encoder_forward(cfg: AudioConfig, weights: AudioWeights, mel) -> torch.Tensor:
    """mel [n_mel, T] (NumPy or a tensor) -> [T', n_embd_llm] f32 on the
    weights' device (clip_graph_whisper_enc::build)."""
    x = torch.as_tensor(mel, dtype=torch.float32, device=weights.device).T
    x = F.gelu(_conv1d(x, weights.conv1_w, weights.conv1_b, 1))     # erf GELU throughout
    x = F.gelu(_conv1d(x, weights.conv2_w, weights.conv2_b, 2))
    n_pos, e = x.shape
    x = x + weights.pos_embd[:n_pos]
    h, d = cfg.n_heads, e // cfg.n_heads
    scale = 1.0 / math.sqrt(d)
    for lw in weights.layers:
        y = layer_norm(x, lw.ln1_w, lw.ln1_b, cfg.eps)
        q = (y @ lw.wq + lw.bq).reshape(n_pos, h, d)
        k = (y @ lw.wk).reshape(n_pos, h, d)
        v = (y @ lw.wv + lw.bv).reshape(n_pos, h, d)
        att = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) * scale, dim=-1)
        ctx = torch.einsum("hqk,khd->qhd", att, v).reshape(n_pos, e)
        x = x + (ctx @ lw.wo + lw.bo)
        y = layer_norm(x, lw.ln2_w, lw.ln2_b, cfg.eps)
        x = x + (F.gelu(y @ lw.w_up + lw.b_up) @ lw.w_down + lw.b_down)
    x = layer_norm(x, weights.ln_post_w, weights.ln_post_b, cfg.eps)

    p = weights.proj
    if cfg.projector == "qwen2a":
        return x @ p["fc_w"] + p["fc_b"]
    if cfg.projector == "ultravox":
        # StackAudioFrames: zero rows up to a multiple of stack_factor, then
        # each run of stack_factor rows becomes one
        sf = cfg.stack_factor
        x = F.pad(x, (0, 0, 0, (-n_pos) % sf))
        x = x.reshape(x.shape[0] // sf, sf * e)
        x = _rms(x) * p["norm_pre_w"] @ p["w1"]
        h1, h2 = x.chunk(2, dim=-1)
        x = h1 * F.silu(h2)             # ggml_swiglu_swapped: the SECOND half gates
        return _rms(x) * p["norm_mid_w"] @ p["w2"]
    raise ValueError(f"unknown audio projector {cfg.projector!r}")


def embed_audio(cfg: AudioConfig, weights: AudioWeights, samples: np.ndarray) -> list:
    """PCM -> a list of [T', n_embd_llm] f32 chunks on the weights' device,
    one a whole 30 s chunk of the padded clip."""
    mel = log_mel_spectrogram(samples, n_mel=cfg.n_mel)
    return [encoder_forward(cfg, weights, c) for c in chunk_mel(mel)]


# -- GGUF interchange (an mmproj with an audio tower; clip-impl.h names) -------

def load_audio_mmproj(path: str | Path, device=None):
    """Read an mmproj GGUF's audio tower into (AudioConfig, AudioWeights),
    f32 on ``device`` (None means ``cuda``, which raises without a GPU)."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.gguf.reader import read_gguf

    dev = resolve_device(device)
    with read_gguf(path) as g:
        cfg = AudioConfig.from_gguf(dict(g.metadata))

        def t(name):
            return torch.from_numpy(np.array(g.tensor(name), np.float32)).to(dev)

        def lin(name):
            """[out, in] -> [in, out] for x @ w."""
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(g.tensor(name), np.float32).T)).to(dev)

        layers = []
        for li in range(cfg.n_layers):
            p = f"a.blk.{li}"
            layers.append(AudioLayer(
                ln1_w=t(f"{p}.ln1.weight"), ln1_b=t(f"{p}.ln1.bias"),
                wq=lin(f"{p}.attn_q.weight"), bq=t(f"{p}.attn_q.bias"),
                wk=lin(f"{p}.attn_k.weight"),
                wv=lin(f"{p}.attn_v.weight"), bv=t(f"{p}.attn_v.bias"),
                wo=lin(f"{p}.attn_out.weight"), bo=t(f"{p}.attn_out.bias"),
                ln2_w=t(f"{p}.ln2.weight"), ln2_b=t(f"{p}.ln2.bias"),
                w_up=lin(f"{p}.ffn_up.weight"), b_up=t(f"{p}.ffn_up.bias"),
                w_down=lin(f"{p}.ffn_down.weight"), b_down=t(f"{p}.ffn_down.bias")))
        if cfg.projector == "qwen2a":
            proj = {"fc_w": lin("mm.a.fc.weight"), "fc_b": t("mm.a.fc.bias")}
        else:
            proj = {"norm_pre_w": t("mm.a.norm_pre.weight"),
                    "norm_mid_w": t("mm.a.norm_mid.weight"),
                    "w1": lin("mm.a.mlp.1.weight"), "w2": lin("mm.a.mlp.2.weight")}
        weights = AudioWeights(
            conv1_w=t("a.conv1d.1.weight"), conv1_b=t("a.conv1d.1.bias"),
            conv2_w=t("a.conv1d.2.weight"), conv2_b=t("a.conv1d.2.bias"),
            pos_embd=t("a.position_embd.weight"), layers=layers,
            ln_post_w=t("a.post_ln.weight"), ln_post_b=t("a.post_ln.bias"), proj=proj)
    return cfg, weights


def write_audio_mmproj(path: str | Path, cfg: AudioConfig, seed: int = 0) -> Path:
    """Write an audio mmproj GGUF of random weights, N(0, 0.05) from
    ``np.random.default_rng(seed)`` in the JAX package's order (norm weights
    1 + that), so the file is byte-equal to its writer's. The ultravox
    projector's hidden width is the tower's ``n_ff``, as there."""
    from rrs_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)

    def m(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    w = GGUFWriter(path)
    w.add_string("general.architecture", "clip")
    w.add_string("clip.projector_type", cfg.projector)
    w.add_uint32("clip.audio.num_mel_bins", cfg.n_mel)
    w.add_uint32("clip.audio.embedding_length", cfg.n_embd)
    w.add_uint32("clip.audio.block_count", cfg.n_layers)
    w.add_uint32("clip.audio.attention.head_count", cfg.n_heads)
    w.add_uint32("clip.audio.feed_forward_length", cfg.n_ff)
    w.add_uint32("clip.audio.projection_dim", cfg.n_embd_llm)
    w.add_float32("clip.audio.attention.layer_norm_epsilon", cfg.eps)
    w.add_uint32("clip.audio.projector.stack_factor", cfg.stack_factor)

    e, nm, f = cfg.n_embd, cfg.n_mel, cfg.n_ff

    def add(name, arr):
        w.add_tensor(name, np.ascontiguousarray(arr, np.float32))

    add("a.conv1d.1.weight", m(e, nm, 3))
    add("a.conv1d.1.bias", m(e))
    add("a.conv1d.2.weight", m(e, e, 3))
    add("a.conv1d.2.bias", m(e))
    add("a.position_embd.weight", m(1500, e))
    add("a.post_ln.weight", 1.0 + m(e))
    add("a.post_ln.bias", m(e))
    for li in range(cfg.n_layers):
        p = f"a.blk.{li}"
        add(f"{p}.ln1.weight", 1.0 + m(e))
        add(f"{p}.ln1.bias", m(e))
        add(f"{p}.attn_q.weight", m(e, e))
        add(f"{p}.attn_q.bias", m(e))
        add(f"{p}.attn_k.weight", m(e, e))
        add(f"{p}.attn_v.weight", m(e, e))
        add(f"{p}.attn_v.bias", m(e))
        add(f"{p}.attn_out.weight", m(e, e))
        add(f"{p}.attn_out.bias", m(e))
        add(f"{p}.ln2.weight", 1.0 + m(e))
        add(f"{p}.ln2.bias", m(e))
        add(f"{p}.ffn_up.weight", m(f, e))
        add(f"{p}.ffn_up.bias", m(f))
        add(f"{p}.ffn_down.weight", m(e, f))
        add(f"{p}.ffn_down.bias", m(e))
    if cfg.projector == "qwen2a":
        add("mm.a.fc.weight", m(cfg.n_embd_llm, e))
        add("mm.a.fc.bias", m(cfg.n_embd_llm))
    else:
        add("mm.a.norm_pre.weight", 1.0 + m(e * cfg.stack_factor))
        add("mm.a.mlp.1.weight", m(2 * f, e * cfg.stack_factor))
        add("mm.a.norm_mid.weight", 1.0 + m(f))
        add("mm.a.mlp.2.weight", m(cfg.n_embd_llm, f))
    return w.write()
