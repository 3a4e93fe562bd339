"""Vision towers and multimodal projectors: plain PyTorch in f32.

Port of ``rrs_tpu/mtmd/clip.py`` (clip.cpp's analog): a CLIP / SigLIP-style
pre-LN ViT whose conv stem is one matmul over flattened patches, then the
projector that maps patch features into the language model's embedding
space: the LLaVA MLP (``mm.0`` / ``mm.2``), gemma3 (average pool, RMS norm,
``mm.input_projection``), idefics3 (pixel shuffle, ``mm.model.fc``),
internvl (CLS row, layer scales, pixel shuffle, LN + MLP), the MiniCPM-V
resampler, Qwen2-VL / Qwen2.5-VL (2-D rotary, the 2 x 2 merger, Qwen2.5's
RMS norms, gated SiLU and window attention) and Pixtral (RMS norms, gated
SiLU, its interleaved 2-D rotary, ``[IMG_BREAK]`` rows). The JAX package
runs these as plain jnp, with no TPU kernel, so the port's are plain torch:
functions over tensors on the weights' device, weights and activations in
f32 as the JAX package loads them. Positions and orders are computed in
NumPy as there. ``load_mmproj`` reads a clip.cpp mmproj GGUF through the
port's own reader; ``random_clip_weights`` draws weights of the JAX
function's shapes and scales on the device (a Qwen2-VL merger at its 2 x 2
block width, which the JAX function does not size). Images reach the
preprocessors as uint8 RGB arrays from ``mtmd/image_io.py`` (no Pillow),
resized with its copy of Pillow's bicubic resample.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

MERGERS = ("qwen2vl_merger", "qwen2.5vl_merger")


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    image_size: int = 224
    patch_size: int = 14
    n_embd: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    n_ff: int = 4096
    n_embd_llm: int = 2048
    eps: float = 1e-5
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    use_gelu: bool = True            # the LLaVA ViT's GELU: tanh-approximate
    projector_type: str = "mlp"      # "mlp" | "gemma3" | "qwen2vl_merger" | ...
    n_merge: int = 4                 # gemma3 pool / pixel-shuffle factor
    spatial_merge: int = 2           # qwen2vl merger: 2 x 2 patch blocks
    temporal_patch: int = 2          # qwen2vl conv3d depth (an image = 2 frames)
    ffn_act: str = "gelu"            # "gelu" | "quick_gelu" | "silu_gated"
    rope_theta: float = 10000.0      # 2-D vision rotary base
    n_wa_pattern: int = 0            # qwen2.5vl: every n-th layer global; 0 = all
    attn_window_size: int = 112      # qwen2.5vl window, pixels
    query_num: int = 64              # minicpmv resampler queries

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_output_tokens(self) -> int:
        if self.projector_type == "gemma3":
            return (self.image_size // self.patch_size // self.n_merge) ** 2
        if self.projector_type == "qwen2vl_merger":
            return self.n_patches // self.spatial_merge ** 2
        return self.n_patches

    @staticmethod
    def from_gguf(md: dict) -> "ClipConfig":
        g = lambda k, d=None: md.get(f"clip.vision.{k}", d)   # noqa: E731
        mean = g("image_mean")
        std = g("image_std")
        ptype = md.get("clip.projector_type")
        return ClipConfig(
            image_size=int(g("image_size", 224)),
            patch_size=int(g("patch_size", 14)),
            n_embd=int(g("embedding_length", 1024)),
            n_layers=int(g("block_count", 12)),
            n_heads=int(g("attention.head_count", 16)),
            n_ff=int(g("feed_forward_length", 4096)),
            n_embd_llm=int(md.get("clip.vision.projection_dim",
                                  md.get("clip.projector.output_dim", 2048))),
            eps=float(g("attention.layer_norm_epsilon", 1e-5)),
            image_mean=tuple(mean) if mean is not None else ClipConfig.image_mean,
            image_std=tuple(std) if std is not None else ClipConfig.image_std,
            projector_type=str(md.get("clip.projector_type", "mlp")),
            n_merge=int(md.get("clip.vision.projector.scale_factor", 4)),
            spatial_merge=int(g("spatial_merge_size", 1 if ptype == "pixtral" else 2)),
            # Qwen2-VL's ViT takes quick-GELU; Qwen2.5-VL gated SiLU
            ffn_act=("quick_gelu" if ptype == "qwen2vl_merger"
                     else "silu_gated" if ptype == "qwen2.5vl_merger" else "gelu"),
            n_wa_pattern=int(g("n_wa_pattern", 0)),
            attn_window_size=int(g("attn_window_size", 112)),
            query_num=int(md.get("clip.minicpmv_query_num", 64)),
        )


@dataclasses.dataclass
class ClipLayer:
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wq: torch.Tensor                 # [in, out] for x @ w
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w_up: torch.Tensor
    b_up: torch.Tensor
    w_down: torch.Tensor
    b_down: torch.Tensor
    w_gate: Optional[torch.Tensor] = None   # pixtral / qwen2.5vl: gated SiLU
    b_gate: Optional[torch.Tensor] = None
    ls1: Optional[torch.Tensor] = None      # internvl layer scales
    ls2: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ClipWeights:
    patch_w: torch.Tensor            # [3 * p * p, E] flattened conv stem
    patch_b: Optional[torch.Tensor]
    pos_embd: Optional[torch.Tensor]  # [n_patches, E]; none for the rotary towers
    pre_ln_w: Optional[torch.Tensor]
    pre_ln_b: Optional[torch.Tensor]
    post_ln_w: Optional[torch.Tensor]
    post_ln_b: Optional[torch.Tensor]
    layers: list
    mm0_w: Optional[torch.Tensor]
    mm0_b: Optional[torch.Tensor]
    mm2_w: Optional[torch.Tensor]
    mm2_b: Optional[torch.Tensor]
    mm_input_proj: Optional[torch.Tensor] = None    # gemma3
    mm_soft_emb_norm: Optional[torch.Tensor] = None
    img_break: Optional[torch.Tensor] = None        # pixtral [IMG_BREAK] row
    cls_embd: Optional[torch.Tensor] = None         # internvl CLS row
    mm_ln_w: Optional[torch.Tensor] = None          # internvl mm.model.mlp.0
    mm_ln_b: Optional[torch.Tensor] = None
    mm_fc: Optional[torch.Tensor] = None            # idefics3
    rs: Optional[dict] = None                       # minicpmv resampler

    @property
    def device(self) -> torch.device:
        return self.patch_w.device

    def nbytes(self) -> int:
        objs = [self, *self.layers]
        ts = [getattr(o, f.name) for o in objs for f in dataclasses.fields(o)]
        ts += list((self.rs or {}).values())
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x) \
        .to(device=device, dtype=torch.float32)


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _attend(q, k, v, mask=None):
    """Full softmax attention [T, H, D] x [S, H, D] -> [T, H * D]."""
    att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        att = att + mask[None]
    att = torch.softmax(att, dim=-1)
    return torch.einsum("hqk,khd->qhd", att, v).reshape(q.shape[0], -1)


def _normalize(arr: np.ndarray, cfg: ClipConfig) -> np.ndarray:
    return (arr - np.asarray(cfg.image_mean)) / np.asarray(cfg.image_std)


def _unit_scale(img) -> np.ndarray:
    """A uint8 image to [0, 1] f32; a float image as it is (÷ 255 above 2)."""
    if np.asarray(img).dtype == np.uint8:
        return np.asarray(img, np.float32) / 255.0
    arr = np.asarray(img, np.float32)
    return arr / 255.0 if arr.max() > 2.0 else arr


def preprocess_image(img, cfg: ClipConfig) -> np.ndarray:
    """uint8 RGB [H, W, 3] (bicubic-resized to the square input) or a float
    image of that size -> [n_patches, 3 * p * p] f32: CLIP mean / std,
    non-overlapping patches in the conv weight's (C, ph, pw) order."""
    from rrs_tpu_torch.mtmd.image_io import resize_bicubic

    if np.asarray(img).dtype == np.uint8:
        img = resize_bicubic(img, cfg.image_size, cfg.image_size)
    arr = _unit_scale(img)
    if arr.shape[:2] != (cfg.image_size, cfg.image_size):
        raise ValueError(f"image must be {cfg.image_size}x{cfg.image_size} (got {arr.shape})")
    arr = _normalize(arr, cfg)
    p = cfg.patch_size
    g = cfg.image_size // p
    patches = arr.reshape(g, p, g, p, 3).transpose(0, 2, 4, 1, 3)
    return patches.reshape(g * g, 3 * p * p).astype(np.float32)


def preprocess_image_qwen2vl(img, cfg: ClipConfig, max_pixels: int = 1024 * 1024):
    """uint8 RGB [H, W, 3] or a float image -> (patches [gh * gw, 3 * p * p]
    f32 in raster order, (gh, gw)). Dynamic resolution: a uint8 image is
    resized, keeping its aspect, to sides that are multiples of
    patch_size * spatial_merge (at most ``max_pixels``)."""
    from rrs_tpu_torch.mtmd.image_io import resize_bicubic

    unit = cfg.patch_size * cfg.spatial_merge
    if np.asarray(img).dtype == np.uint8:
        h0, w0 = np.asarray(img).shape[:2]
        scale = min(1.0, (max_pixels / (w0 * h0)) ** 0.5)
        w1 = max(unit, int(round(w0 * scale / unit)) * unit)
        h1 = max(unit, int(round(h0 * scale / unit)) * unit)
        img = resize_bicubic(img, w1, h1)
    arr = _unit_scale(img)
    hh, ww = arr.shape[:2]
    if hh % unit or ww % unit:
        raise ValueError(f"qwen2vl image dims must be multiples of {unit}, got {arr.shape}")
    arr = _normalize(arr, cfg)
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    patches = arr.reshape(gh, p, gw, p, 3).transpose(0, 2, 4, 1, 3)
    return patches.reshape(gh * gw, 3 * p * p).astype(np.float32), (gh, gw)


def _vit_forward(cfg: ClipConfig, weights: ClipWeights, x: torch.Tensor,
                 rms: bool = False) -> torch.Tensor:
    """The shared pre-LN ViT body (positions already added): optional layer
    scales and RMS norms (InternVL-6B)."""
    n, e = x.shape
    h, d = cfg.n_heads, cfg.n_embd // cfg.n_heads
    norm = (lambda v_, w_, b_: _rms(v_, w_, cfg.eps)) if rms \
        else (lambda v_, w_, b_: _layer_norm(v_, w_, b_, cfg.eps))
    if weights.pre_ln_w is not None:
        x = norm(x, weights.pre_ln_w, weights.pre_ln_b)
    for lw in weights.layers:
        y = norm(x, lw.ln1_w, lw.ln1_b)
        q = (y @ lw.wq + lw.bq).reshape(n, h, d)
        k = (y @ lw.wk + lw.bk).reshape(n, h, d)
        v = (y @ lw.wv + lw.bv).reshape(n, h, d)
        ctx = _attend(q, k, v) @ lw.wo + lw.bo
        if lw.ls1 is not None:
            ctx = ctx * lw.ls1
        x = x + ctx
        y = norm(x, lw.ln2_w, lw.ln2_b)
        y = F.gelu(y @ lw.w_up + lw.b_up, approximate="tanh" if cfg.use_gelu else "none")
        y = y @ lw.w_down + lw.b_down
        if lw.ls2 is not None:
            y = y * lw.ls2
        x = x + y
    if weights.post_ln_w is not None:
        x = norm(x, weights.post_ln_w, weights.post_ln_b)
    return x


def pixel_shuffle(x: torch.Tensor, gh: int, gw: int, s: int) -> torch.Tensor:
    """[gh * gw, E] raster -> [gh/s * gw/s, E * s * s]: the idefics3 /
    internvl patch merge (w groups fold into channels first, then h)."""
    e = x.shape[-1]
    x = x.reshape(gh, gw // s, s * e).transpose(0, 1)
    x = x.reshape(gw // s, gh // s, s * s * e).transpose(0, 1)
    return x.reshape((gh // s) * (gw // s), s * s * e)


def encode_image(cfg: ClipConfig, weights: ClipWeights, patches) -> torch.Tensor:
    """[n_patches, 3 * p * p] -> [n_tokens, n_embd_llm] f32: the LLaVA mlp,
    gemma3, idefics3 and internvl projectors."""
    x = _f32(patches, weights.device) @ weights.patch_w
    if weights.patch_b is not None:
        x = x + weights.patch_b
    is_internvl = cfg.projector_type == "internvl"
    if is_internvl and weights.cls_embd is not None:
        x = torch.cat([weights.cls_embd[None, :], x], dim=0)
    if cfg.projector_type == "idefics3":
        # HF Idefics3VisionEmbeddings' bucketed coordinates: ids per axis
        # come out [0, 0, 1, ..., g - 2], not an arange
        g = cfg.image_size // cfg.patch_size
        b = np.searchsorted(np.arange(1, g) / g, np.arange(g) / g * (1 - 1e-6), side="right")
        ids = (b[:, None] * g + b[None, :]).reshape(-1)
        x = x + weights.pos_embd[torch.from_numpy(ids).to(x.device)]
    else:
        x = x + weights.pos_embd[: x.shape[0]]
    rms = is_internvl and cfg.n_embd == 3200 and cfg.n_layers == 45   # InternVL-6B
    x = _vit_forward(cfg, weights, x, rms=rms)
    e = x.shape[-1]
    if cfg.projector_type == "idefics3":
        g = cfg.image_size // cfg.patch_size
        return pixel_shuffle(x, g, g, cfg.n_merge) @ weights.mm_fc
    if is_internvl:
        g = cfg.image_size // cfg.patch_size
        x = pixel_shuffle(x[1:], g, g, cfg.n_merge)              # CLS dropped
        x = _layer_norm(x, weights.mm_ln_w, weights.mm_ln_b, 1e-5)
        x = F.gelu(x @ weights.mm0_w + weights.mm0_b)
        return x @ weights.mm2_w + weights.mm2_b
    if cfg.projector_type == "gemma3":
        ppi = cfg.image_size // cfg.patch_size
        m_ = cfg.n_merge
        pooled = x.reshape(ppi // m_, m_, ppi // m_, m_, e).mean(dim=(1, 3)).reshape(-1, e)
        normed = pooled * torch.rsqrt((pooled ** 2).mean(-1, keepdim=True) + cfg.eps) \
            * weights.mm_soft_emb_norm
        return normed @ weights.mm_input_proj
    x = F.gelu(x @ weights.mm0_w + weights.mm0_b, approximate="tanh")
    return x @ weights.mm2_w + weights.mm2_b


def _sincos_2d(n_embd_proj: int, gh: int, gw: int) -> np.ndarray:
    """MiniCPM-V's 2-D sinusoidal table [gh * gw, Ep]: per axis [sin | cos]
    over Ep / 4 frequencies, the x block then the y block."""
    q = n_embd_proj // 4
    omega = 1.0 / (10000.0 ** (np.arange(q, dtype=np.float32) / q))
    hpos = (np.arange(gh * gw) // gw).astype(np.float32)
    wpos = (np.arange(gh * gw) % gw).astype(np.float32)
    tx = wpos[:, None] * omega[None, :]
    ty = hpos[:, None] * omega[None, :]
    return np.concatenate([np.sin(tx), np.cos(tx), np.sin(ty), np.cos(ty)], axis=1)


def encode_image_minicpmv(cfg: ClipConfig, weights: ClipWeights, patches,
                          grid_hw=None) -> torch.Tensor:
    """The MiniCPM-V resampler: the LN ViT with learned positions, then
    ``query_num`` learned queries cross-attend the kv-projected patches (2-D
    sincos positions on K only), LN and the final projection. Always
    [query_num, n_embd_llm]."""
    dev = weights.device
    x = _f32(patches, dev) @ weights.patch_w
    if weights.patch_b is not None:
        x = x + weights.patch_b
    n = x.shape[0]
    if grid_hw is None:
        g = cfg.image_size // cfg.patch_size
        grid_hw = (g, g)
    x = _vit_forward(cfg, weights, x + weights.pos_embd[:n])
    rs = weights.rs
    q = _layer_norm(rs["query"], rs["ln_q_w"], rs["ln_q_b"], cfg.eps)
    v = _layer_norm(x @ rs["kv_w"], rs["ln_kv_w"], rs["ln_kv_b"], cfg.eps)    # [N, Ep]
    k = v + torch.from_numpy(_sincos_2d(v.shape[-1], *grid_hw)).to(dev)[:n]
    ep = v.shape[-1]
    d = 128 if ep % 128 == 0 else ep // max(1, cfg.n_heads)
    h = ep // d
    nq = q.shape[0]
    out = _attend((q @ rs["q_w"] + rs["q_b"]).reshape(nq, h, d),
                  (k @ rs["k_w"] + rs["k_b"]).reshape(n, h, d),
                  (v @ rs["v_w"] + rs["v_b"]).reshape(n, h, d))
    out = _layer_norm(out @ rs["o_w"] + rs["o_b"], rs["ln_post_w"], rs["ln_post_b"], cfg.eps)
    return out @ rs["proj"]


def qwen2vl_block_order(gh: int, gw: int, m: int = 2) -> np.ndarray:
    """The qwen2vl ViT's token order: raster patches regrouped so that each
    run of m * m tokens is one spatial merge block."""
    idx = np.arange(gh * gw).reshape(gh // m, m, gw // m, m)
    return idx.transpose(0, 2, 1, 3).reshape(-1)


def _vision_rope_2d(cfg: ClipConfig, hpos, wpos, d: int):
    """[T] h / w patch coordinates -> (cos, sin) [T, d] NumPy f32 of the
    qwen2vl ViT's 2-D rotary: the d/2 angles are [h * invf | w * invf] over
    d/4 inverse frequencies, applied NEOX-style over the whole head."""
    invf = 1.0 / (cfg.rope_theta ** (np.arange(0, d // 2, 2, dtype=np.float32) / (d // 2)))
    ang = np.concatenate([hpos[:, None].astype(np.float32) * invf[None, :],
                          wpos[:, None].astype(np.float32) * invf[None, :]], axis=1)
    ang = np.concatenate([ang, ang], axis=1)
    return np.cos(ang), np.sin(ang)


def _vision_rope_2d_pixtral(cfg: ClipConfig, hpos, wpos, d: int):
    """Pixtral's 2-D rotary: h takes the even rungs of the d/2 frequency
    ladder, w the odd ones, then [h | w] as in qwen2vl."""
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.concatenate([hpos[:, None].astype(np.float32) * freqs[0::2][None, :],
                          wpos[:, None].astype(np.float32) * freqs[1::2][None, :]], axis=1)
    ang = np.concatenate([ang, ang], axis=1)
    return np.cos(ang), np.sin(ang)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rotary(cos_sin, dev):
    """NumPy (cos, sin) [T, d] -> tensors [T, 1, d] on dev."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None, :] for a in cos_sin)


def qwen25vl_window_order(gh: int, gw: int, m: int, window_units: int):
    """Qwen2.5-VL's window grouping: merged units (m * m patch blocks)
    regrouped so that each attention window's units are contiguous. Returns
    (units [U], each window-ordered slot's raster unit; seglens [n_windows],
    token counts)."""
    ph, pw = gh // m, gw // m
    units, seglens = [], []
    for y in range(0, ph, window_units):
        for x in range(0, pw, window_units):
            wh = min(window_units, ph - y)
            ww = min(window_units, pw - x)
            for dy in range(wh):
                for dx in range(ww):
                    units.append((y + dy) * pw + (x + dx))
            seglens.append(wh * ww * m * m)
    return np.asarray(units, np.int64), np.asarray(seglens, np.int64)


def encode_image_qwen2vl(cfg: ClipConfig, weights: ClipWeights, patches,
                         grid_hw) -> torch.Tensor:
    """Qwen2-VL / Qwen2.5-VL ViT and its 2 x 2 merger: the two temporal conv
    slices summed into ``patch_w``, no learned positions but a 2-D rotary
    over each patch's (h, w) in every attention, then mm.0 -> GELU -> mm.2
    over concatenated 2 x 2 blocks. Patches arrive in raster order. Qwen2.5-VL
    takes RMS norms, gated SiLU, and window attention in every layer but each
    n_wa_pattern-th; its merger output goes back to raster unit order."""
    dev = weights.device
    gh, gw = grid_hw
    m = cfg.spatial_merge
    order = qwen2vl_block_order(gh, gw, m)
    win_units = win_mask = None
    is25 = cfg.projector_type == "qwen2.5vl_merger"
    if is25 and cfg.n_wa_pattern > 0:
        wu = max(1, cfg.attn_window_size // cfg.patch_size // m)
        win_units, seglens = qwen25vl_window_order(gh, gw, m, wu)
        m2 = m * m
        order = order[(win_units[:, None] * m2 + np.arange(m2)[None, :]).reshape(-1)]
        seg_id = np.repeat(np.arange(len(seglens)), seglens)
        win_mask = torch.from_numpy(np.where(seg_id[:, None] == seg_id[None, :], 0.0,
                                             -np.inf).astype(np.float32)).to(dev)
    hpos = (np.arange(gh * gw) // gw)[order]
    wpos = (np.arange(gh * gw) % gw)[order]

    x = (_f32(patches, dev) @ weights.patch_w)[torch.from_numpy(order).to(dev)]
    if weights.patch_b is not None:
        x = x + weights.patch_b
    norm = (lambda v_, w_, b_: _rms(v_, w_, cfg.eps)) if is25 \
        else (lambda v_, w_, b_: _layer_norm(v_, w_, b_, cfg.eps))
    if weights.pre_ln_w is not None:
        x = norm(x, weights.pre_ln_w, weights.pre_ln_b)
    n, e = x.shape
    h, d = cfg.n_heads, cfg.n_embd // cfg.n_heads
    cos, sin = _rotary(_vision_rope_2d(cfg, hpos, wpos, d), dev)
    for li, lw in enumerate(weights.layers):
        full_attn = win_mask is None or (li + 1) % cfg.n_wa_pattern == 0
        y = norm(x, lw.ln1_w, lw.ln1_b)
        q = (y @ lw.wq + lw.bq).reshape(n, h, d)
        k = (y @ lw.wk + lw.bk).reshape(n, h, d)
        v = (y @ lw.wv + lw.bv).reshape(n, h, d)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        x = x + (_attend(q, k, v, None if full_attn else win_mask) @ lw.wo + lw.bo)
        y = norm(x, lw.ln2_w, lw.ln2_b)
        if cfg.ffn_act == "silu_gated":
            gate = y @ lw.w_gate + (lw.b_gate if lw.b_gate is not None else 0.0)
            y = F.silu(gate) * (y @ lw.w_up + lw.b_up)
        else:
            y = y @ lw.w_up + lw.b_up
            if cfg.ffn_act == "quick_gelu":
                y = y * torch.sigmoid(1.702 * y)
            else:
                y = F.gelu(y, approximate="tanh" if cfg.use_gelu else "none")
        x = x + (y @ lw.w_down + lw.b_down)
    if weights.post_ln_w is not None:
        x = norm(x, weights.post_ln_w, weights.post_ln_b)
    m2 = cfg.spatial_merge ** 2
    x = F.gelu(x.reshape(n // m2, m2 * e) @ weights.mm0_w + weights.mm0_b)
    x = x @ weights.mm2_w + weights.mm2_b
    if win_units is not None:
        inv = np.empty(len(win_units), np.int64)
        inv[win_units] = np.arange(len(win_units))
        x = x[torch.from_numpy(inv).to(dev)]
    return x


def encode_image_pixtral(cfg: ClipConfig, weights: ClipWeights, patches, grid_hw,
                         insert_breaks: bool = True) -> torch.Tensor:
    """Pixtral's ViT and MLP projector: RMS norms, gated SiLU, its 2-D rotary
    per patch in raster order, mm.1 -> GELU -> mm.2. With ``insert_breaks``
    the learned [IMG_BREAK] row follows every patch row but the last:
    gh * gw + gh - 1 rows."""
    dev = weights.device
    gh, gw = grid_hw
    hpos = np.arange(gh * gw) // gw
    wpos = np.arange(gh * gw) % gw
    x = _f32(patches, dev) @ weights.patch_w
    if weights.patch_b is not None:
        x = x + weights.patch_b
    x = _rms(x, weights.pre_ln_w, cfg.eps)
    n, e = x.shape
    h, d = cfg.n_heads, cfg.n_embd // cfg.n_heads
    cos, sin = _rotary(_vision_rope_2d_pixtral(cfg, hpos, wpos, d), dev)
    for lw in weights.layers:
        y = _rms(x, lw.ln1_w, cfg.eps)
        q = (y @ lw.wq + lw.bq).reshape(n, h, d)
        k = (y @ lw.wk + lw.bk).reshape(n, h, d)
        v = (y @ lw.wv + lw.bv).reshape(n, h, d)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        x = x + (_attend(q, k, v) @ lw.wo + lw.bo)
        y = _rms(x, lw.ln2_w, cfg.eps)
        y = F.silu(y @ lw.w_gate) * (y @ lw.w_up + lw.b_up)
        x = x + (y @ lw.w_down + lw.b_down)
    out = F.gelu(x @ weights.mm0_w + weights.mm0_b)
    out = out @ weights.mm2_w + weights.mm2_b                       # [gh * gw, D]
    if insert_breaks and weights.img_break is not None:
        rows = out.reshape(gh, gw, -1)
        brk = weights.img_break[None, None, :].expand(gh, 1, rows.shape[-1])
        out = torch.cat([rows, brk], dim=1).reshape(gh * (gw + 1), -1)[:-1]
    return out


def load_mmproj(path: str | Path, device=None):
    """Read a clip.cpp mmproj GGUF into (ClipConfig, ClipWeights) on
    ``device`` (None means ``cuda``, which raises without a GPU)."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.gguf.reader import read_gguf

    dev = resolve_device(device)
    with read_gguf(path) as g:
        md = g.metadata
        cfg = ClipConfig.from_gguf(md)

        def arr(name):
            return np.array(g.tensor(name), np.float32)

        def t(name, required=True):
            if name not in g.tensors:
                if required:
                    raise KeyError(name)
                return None
            return torch.from_numpy(arr(name)).to(dev)

        def lin(name):
            """[out, in] -> ([in, out], bias or zeros)."""
            w = arr(f"{name}.weight")
            b = t(f"{name}.bias", required=False)
            if b is None:
                b = torch.zeros((w.shape[0],), dtype=torch.float32, device=dev)
            return torch.from_numpy(np.ascontiguousarray(w.T)).to(dev), b

        # conv stem [E, 3, p, p] -> [3 * p * p, E]; Qwen2-VL's two temporal
        # slices see the same pixels for a still image, so they are summed
        pw = arr("v.patch_embd.weight")
        e = pw.shape[0]
        if "v.patch_embd.weight.1" in g.tensors:
            pw = pw.reshape(e, -1) + arr("v.patch_embd.weight.1").reshape(e, -1)
        patch_w = torch.from_numpy(np.ascontiguousarray(pw.reshape(e, -1).T)).to(dev)
        layers = []
        for i in range(cfg.n_layers):
            p = f"v.blk.{i}"
            wq, bq = lin(f"{p}.attn_q")
            wk, bk = lin(f"{p}.attn_k")
            wv, bv = lin(f"{p}.attn_v")
            wo, bo = lin(f"{p}.attn_out")
            wu, bu = lin(f"{p}.ffn_up")
            wd, bd = lin(f"{p}.ffn_down")
            ln1_w = t(f"{p}.ln1.weight")
            ln1_b = t(f"{p}.ln1.bias", required=False)
            ln2_b = t(f"{p}.ln2.bias", required=False)
            wg, bg = lin(f"{p}.ffn_gate") if f"{p}.ffn_gate.weight" in g.tensors else (None, None)
            layers.append(ClipLayer(
                ln1_w=ln1_w, ln1_b=ln1_b if ln1_b is not None else torch.zeros_like(ln1_w),
                wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
                ln2_w=t(f"{p}.ln2.weight"),
                ln2_b=ln2_b if ln2_b is not None else torch.zeros_like(ln1_w),
                w_up=wu, b_up=bu, w_down=wd, b_down=bd, w_gate=wg, b_gate=bg,
                ls1=t(f"{p}.ls1.weight", required=False),
                ls2=t(f"{p}.ls2.weight", required=False)))
        mm0w = mm0b = mm2w = mm2b = mm_ip = mm_sen = None
        mm_lnw = mm_lnb = mm_fc = rs = None
        if cfg.projector_type == "gemma3":
            # HF stores it [vision, text]; orient it for x @ W
            ip = arr("mm.input_projection.weight")
            mm_ip = torch.from_numpy(np.ascontiguousarray(
                ip if ip.shape[0] == cfg.n_embd else ip.T)).to(dev)
            mm_sen = t("mm.soft_emb_norm.weight")
        elif cfg.projector_type == "idefics3":
            mm_fc = lin("mm.model.fc")[0]
        elif cfg.projector_type == "internvl":
            mm_lnw = t("mm.model.mlp.0.weight")
            mm_lnb = t("mm.model.mlp.0.bias")
            mm0w, mm0b = lin("mm.model.mlp.1")
            mm2w, mm2b = lin("mm.model.mlp.3")
        elif cfg.projector_type == "resampler":
            rs = {"query": t("resampler.query"),
                  "kv_w": lin("resampler.kv")[0],
                  "ln_q_w": t("resampler.ln_q.weight"), "ln_q_b": t("resampler.ln_q.bias"),
                  "ln_kv_w": t("resampler.ln_kv.weight"), "ln_kv_b": t("resampler.ln_kv.bias"),
                  "ln_post_w": t("resampler.ln_post.weight"),
                  "ln_post_b": t("resampler.ln_post.bias"),
                  "proj": t("resampler.proj.weight")}
            for nm in ("q", "k", "v"):
                rs[f"{nm}_w"], rs[f"{nm}_b"] = lin(f"resampler.attn.{nm}")
            rs["o_w"], rs["o_b"] = lin("resampler.attn.out")
        else:
            # pixtral names its projector mm.1 / mm.2, the LLaVA MLP mm.0 / mm.2
            mm0w, mm0b = lin("mm.1" if "mm.1.weight" in g.tensors else "mm.0")
            mm2w, mm2b = lin("mm.2")
        brk = t("v.token_embd.img_break", required=False)
        pos = t("v.position_embd.weight",
                required=cfg.projector_type not in MERGERS + ("pixtral",))
        weights = ClipWeights(
            patch_w=patch_w,
            patch_b=t("v.patch_embd.bias", required=False),
            # internvl keeps its CLS row at index 0; CLIP-style tables drop
            # leading class rows
            pos_embd=(None if pos is None else pos if cfg.projector_type == "internvl"
                      else pos[-cfg.n_patches:]),
            pre_ln_w=t("v.pre_ln.weight", required=False),
            pre_ln_b=t("v.pre_ln.bias", required=False),
            post_ln_w=t("v.post_ln.weight", required=False),
            post_ln_b=t("v.post_ln.bias", required=False),
            layers=layers,
            mm0_w=mm0w, mm0_b=mm0b, mm2_w=mm2w, mm2_b=mm2b,
            mm_input_proj=mm_ip, mm_soft_emb_norm=mm_sen,
            img_break=None if brk is None else brk.reshape(-1),
            cls_embd=t("v.class_embd").reshape(-1) if "v.class_embd" in g.tensors else None,
            mm_ln_w=mm_lnw, mm_ln_b=mm_lnb, mm_fc=mm_fc, rs=rs)
    return cfg, weights


def random_clip_weights(cfg: ClipConfig, seed: int = 0, mm_hidden: int = 0,
                        device=None) -> ClipWeights:
    """Random f32 weights with the JAX function's shapes and scales (matrices
    N(0, 0.02), biases zero, norms one), drawn on ``device`` (None means
    ``cuda``) from a seeded ``torch.Generator``: the JAX function draws from
    NumPy on the host, too slow for a full-size tower (Qwen2-VL's 663 M
    weights), so the values differ. A Qwen2-VL merger's mm.0 takes the 2 x 2
    block width E * m * m and, by default, as many hidden units (the
    published merger's), where the JAX function leaves it at E."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e, f = cfg.n_embd, cfg.n_ff
    merger = cfg.projector_type in MERGERS
    mm_in = e * cfg.spatial_merge ** 2 if merger else e
    mm_hidden = mm_hidden or (mm_in if merger else cfg.n_embd_llm)

    def m(k, n, s=0.02):
        return torch.randn((k, n), generator=gen, device=dev) * s

    def b(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def one(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    layers = [ClipLayer(
        ln1_w=one(e), ln1_b=b(e),
        wq=m(e, e), bq=b(e), wk=m(e, e), bk=b(e), wv=m(e, e), bv=b(e),
        wo=m(e, e), bo=b(e),
        ln2_w=one(e), ln2_b=b(e),
        w_up=m(e, f), b_up=b(f), w_down=m(f, e), b_down=b(e),
    ) for _ in range(cfg.n_layers)]
    gemma3 = cfg.projector_type == "gemma3"
    return ClipWeights(
        patch_w=m(3 * cfg.patch_size ** 2, e),
        patch_b=b(e),
        pos_embd=m(cfg.n_patches, e),
        pre_ln_w=one(e), pre_ln_b=b(e),
        post_ln_w=one(e), post_ln_b=b(e),
        layers=layers,
        mm0_w=None if gemma3 else m(mm_in, mm_hidden),
        mm0_b=None if gemma3 else b(mm_hidden),
        mm2_w=None if gemma3 else m(mm_hidden, cfg.n_embd_llm),
        mm2_b=None if gemma3 else b(cfg.n_embd_llm),
        mm_input_proj=m(e, cfg.n_embd_llm) if gemma3 else None,
        mm_soft_emb_norm=one(e) if gemma3 else None,
    )
