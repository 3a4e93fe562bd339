"""Auto-fit context/lanes to device memory — the llama_params_fit analog
(include/llama.h:485-495, src/llama.cpp:159; tool tools/fit-params).

The reference shrinks n_gpu_layers / n_ctx until the model + KV + compute
buffers fit VRAM. Every layer lives on the device, so the free variables
are context length and lane count.

Port of ``rrs_tpu/utils/fit_params.py``: the same formulas, so the same
integers for every configuration. ``model_bytes`` is an estimate for a
TCQ4 checkpoint (4.625 bits a weight, an 8.5-bit Q8_0 head, a 16-bit
embedding), not a reading of what a loader allocates.
"""

from __future__ import annotations

import dataclasses

from rrs_tpu_torch.models.config import ModelConfig


def model_bytes(cfg: ModelConfig, bits_per_weight: float = 4.625,
                lm_head_bits: float = 8.5, embd_bits: float = 16.0) -> int:
    """Approximate on-device model size for a TCQ4-quantized checkpoint."""
    if cfg.is_recurrent:
        di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank
        per_layer = (cfg.n_embd * 2 * di + di * (dtr + 2 * ds)
                     + dtr * di + di * cfg.n_embd)
    else:
        per_layer = (cfg.n_embd * (cfg.n_q_dim + 2 * cfg.n_kv_dim)
                     + cfg.n_q_dim * cfg.n_embd
                     + 3 * cfg.n_embd * cfg.n_ff)
        if cfg.n_experts:
            per_layer += 3 * cfg.n_experts * cfg.n_embd * (cfg.n_ff_exp or cfg.n_ff)
    total = cfg.n_layers * per_layer * bits_per_weight / 8
    total += cfg.vocab_size * cfg.n_embd * embd_bits / 8          # embeddings
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.n_embd * lm_head_bits / 8   # output head
    return int(total)


def kv_bytes_per_slot(cfg: ModelConfig, kv_quant: str = "none") -> int:
    """KV bytes per (lane, position) across all layers (SWA rings reduced)."""
    if cfg.is_recurrent:
        return 0
    el = {"q8": 1.0, "q4": 0.5}.get(kv_quant, 2.0)
    scale_b = 4 if kv_quant in ("q8", "q4") else 0   # f32 scale per slot
    per = 0
    for li in range(cfg.n_layers):
        frac = 1.0
        if cfg.is_swa(li):
            frac = min(1.0, (cfg.swa_window + 512) / cfg.context_length)
        per += 2 * cfg.n_kv_heads * (cfg.head_dim * el + scale_b) * frac
    return int(per)


def recurrent_state_bytes(cfg: ModelConfig) -> int:
    if not cfg.is_recurrent:
        return 0
    per_lane = cfg.n_layers * (
        (cfg.ssm_d_conv - 1) * cfg.ssm_d_inner * 2           # conv, bf16
        + cfg.ssm_d_inner * cfg.ssm_d_state * 4              # ssm, f32
    )
    return per_lane


@dataclasses.dataclass
class FitResult:
    fits: bool
    n_ctx: int                 # max context per lane
    n_lanes: int
    model_bytes: int
    kv_bytes: int
    free_bytes: int


def fit_params(
    cfg: ModelConfig,
    hbm_bytes: int = 16 * 1024**3,          # the JAX package's default budget
    n_lanes: int = 1,
    n_ctx: int = 0,                          # 0 => maximize
    kv_quant: str = "none",
    headroom: float = 0.10,                  # compile/compute buffers
) -> FitResult:
    """Compute the largest context (or validate a requested one) that fits."""
    budget = int(hbm_bytes * (1.0 - headroom))
    mb = model_bytes(cfg)
    per_slot = kv_bytes_per_slot(cfg, kv_quant)
    rec = recurrent_state_bytes(cfg) * n_lanes
    avail = budget - mb - rec
    if cfg.is_recurrent:
        ctx = n_ctx or cfg.context_length
        return FitResult(avail >= 0, ctx, n_lanes, mb, rec, avail)
    if avail <= 0 or per_slot == 0:
        return FitResult(False, 0, n_lanes, mb, 0, avail)
    max_ctx = avail // (per_slot * n_lanes)
    max_ctx = min(int(max_ctx), cfg.context_length)
    max_ctx = max_ctx // 128 * 128
    if n_ctx:
        kv = per_slot * n_lanes * n_ctx
        return FitResult(n_ctx <= max_ctx, n_ctx, n_lanes, mb, kv,
                         avail - kv)
    kv = per_slot * n_lanes * max_ctx
    return FitResult(max_ctx > 0, max_ctx, n_lanes, mb, kv, avail - kv)
