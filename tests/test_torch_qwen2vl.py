"""qwen2vl in rrs_tpu_torch against rrs_tpu: M-RoPE (``apply_mrope``), the
config, the KV cache's position rows (``positions_row``, ``pos_offset``,
``mrope_begin_image``, ``mrope_delta``) and ``seq_div`` over bf16 / q8 / q4
caches, and a 2-layer Qwen2-VL converted from a tiny ``transformers``
checkpoint: text logits and a [text, image, text] prefill through
``prefill_embeds`` against the JAX package's ``InferenceContext`` (run op by
op), at the tolerance of the JAX package's own test against Hugging Face
(tests/test_qwen2vl.py: atol 2e-2, rtol 0.05 on max-shifted logits)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.ops import basic as jbasic
from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.ops import basic
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import jax_cfg, rel_err, torch_cfg
from test_torch_kv_cache import LAYOUTS, _qcfg, _random_quantized

transformers = pytest.importorskip("transformers")

SECTIONS = {"3 channels": (2, 3, 3), "4 channels": (2, 3, 3, 0), "uneven": (1, 2, 4, 1)}


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_apply_mrope_matches_jax(name):
    """Each frequency dim takes its angle from its section's channel: rel
    1e-6 of JAX's on [B, T, H, D] rows with random (t, h, w[, e]) channels;
    with every channel equal it is ``apply_rope`` bit for bit."""
    sect = SECTIONS[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7, len(sect))).astype(np.int32)
    p, jp = basic.RopeParams(head_dim=16, theta=1e6), jbasic.RopeParams(head_dim=16, theta=1e6)
    got = basic.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), p, sect)
    ref = jbasic.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jp, sect)
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-6
    flat = np.broadcast_to(pos[..., :1], pos.shape).copy()
    got = basic.apply_mrope(torch.from_numpy(x), torch.from_numpy(flat), p, sect)
    ref = basic.apply_rope(torch.from_numpy(x), torch.from_numpy(flat[..., 0]), p)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="sum to"):
        basic.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), p, sect[:-1] + (9,))


def test_qwen2vl_config_matches_jax():
    """qwen2vl loads: qwen2's body with qkv biases, the M-RoPE sections."""
    md = {"general.architecture": "qwen2vl", "qwen2vl.block_count": 2,
          "qwen2vl.embedding_length": 64, "qwen2vl.attention.head_count": 4,
          "qwen2vl.rope.dimension_sections": [2, 3, 3, 0]}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert cfg.rope_sections == (2, 3, 3, 0) and cfg.attn_bias


def _rows_script(kv):
    """One script of image chunks, text, a fork and a removal; returns every
    integer the position rows give."""
    out = []
    kv.seq_new(0)
    kv.lengths[0] = 5
    out.append(kv.mrope_begin_image(0, 2, 3).tolist())
    kv.lengths[0] += 6
    out += [kv.positions_row(0, 11, 4).tolist(), kv.pos_offset(0), dict(kv.mrope_delta)]
    kv.lengths[0] += 4
    out.append(kv.mrope_begin_image(0, 4, 2).tolist())     # h != w, a second image
    kv.lengths[0] += 8
    out += [kv.positions_row(0, 23, 3).tolist(), kv.pos_offset(0)]
    kv.seq_cp(0, 1)
    out += [dict(kv.mrope_delta), kv.positions_row(1, 23, 2).tolist()]
    kv.seq_rm(1)
    kv.seq_new(2)
    out += [dict(kv.mrope_delta), kv.positions_row(1, 0, 3).tolist(), kv.pos_offset(1)]
    return out


def test_position_rows_match_jax():
    jcfg = jax_cfg(n_layers=1)
    jkv = JaxKVCache.create(jcfg, n_lanes=3, max_seq=64)
    tkv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=64)
    got, ref = _rows_script(tkv), _rows_script(jkv)
    assert got == ref
    assert ref[3] == {0: -3}              # a 2 x 3 grid of 6 rows: text resumes at base + 3


def _fill_bf16(tkv, jkv, rng):
    for li in range(len(tkv.k)):
        for name in ("k", "v"):
            a = rng.standard_normal(tuple(tkv.k[li].shape)).astype(np.float32)
            getattr(tkv, name)[li] = torch.from_numpy(a).to(torch.bfloat16)
            getattr(jkv, name)[li] = jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("layout", ["bf16"] + sorted(LAYOUTS))
def test_seq_div_matches_jax(layout):
    """Self-extend: every position of lane 1 divided by 2, then [4, 24) by 3, the cached K
    re-rotated by each slot's delta. The slot -> position map, the rows and
    the offset equal JAX's; bf16 K within one bf16 ulp of JAX's (the two
    round the rotation's f32 result to either side), a quantized K within one
    quantization step; V untouched; a second division composes."""
    from rrs_tpu.runtime import kv_codec as jkc
    from rrs_tpu_torch.runtime import kv_codec as tkc

    quant, hkv = ("none", 2) if layout == "bf16" else LAYOUTS[layout]
    jcfg = _qcfg(hkv)
    cfg = torch_cfg(jcfg)
    rng = np.random.default_rng(3)
    jkv = JaxKVCache.create(jcfg, n_lanes=2, max_seq=32, quant=quant)
    tkv = KVCache.create(cfg, n_lanes=2, max_seq=32, quant=quant)
    if quant == "none":
        _fill_bf16(tkv, jkv, rng)
    else:
        _random_quantized(tkv, jkv, rng)
    v_before = [tuple(t.clone() for t in v) if quant != "none" else v.clone() for v in tkv.v]
    for kv in (jkv, tkv):
        kv.seq_new(7)
        kv.seq_new(8)
        kv.lengths[1] = 30
    for args in ((0, -1, 2), (4, 24, 3)):
        jkv.seq_div(jcfg, 8, *args)
        tkv.seq_div(cfg, 8, *args)
        np.testing.assert_array_equal(tkv.slot_pos[1], jkv.slot_pos[1])
        assert tkv.positions_row(1, 30, 2).tolist() == jkv.positions_row(1, 30, 2).tolist()
        assert tkv.pos_offset(1) == jkv.pos_offset(1) != 0
    for li in range(cfg.n_layers):
        if quant == "none":
            got = tkv.k[li].float().numpy()
            ref = np.asarray(jkv.k[li], np.float32)
            np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
            assert torch.equal(tkv.v[li], v_before[li])
            continue
        got = tkc.dequantize(*tkv.k[li]).numpy()
        ref = np.asarray(jkc.dequantize(*jkv.k[li]))
        step = np.maximum(tkv.k[li][1].numpy(), np.asarray(jkv.k[li][1]))
        assert (np.abs(got - ref) <= 1.0001 * step.transpose(0, 1, 3, 2)).all()
        for a, b in zip(tkv.v[li], v_before[li]):
            assert torch.equal(a, b)


def test_seq_div_refuses_sliding_models():
    cfg = torch_cfg(jax_cfg(n_layers=1, swa_window=8, swa_pattern=1))
    kv = KVCache.create(cfg, n_lanes=1, max_seq=32)
    kv.seq_new(0)
    kv.lengths[0] = 10
    with pytest.raises(RuntimeError, match="SWA"):
        kv.seq_div(cfg, 0, 0, 8, 2)


# -- a 2-layer Qwen2-VL from a tiny transformers checkpoint ---------------------

VC = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=4, patch_size=4,
          spatial_merge_size=2, temporal_patch_size=2, in_channels=3, hidden_size=64)


def tiny_qwen2vl(directory):
    """The tiny checkpoint of tests/test_qwen2vl.py, saved under ``directory``."""
    cfg = transformers.Qwen2VLConfig(
        vision_config=VC, vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        vision_start_token_id=100, vision_end_token_id=102, image_token_id=101)
    torch.manual_seed(0)
    model = transformers.Qwen2VLForConditionalGeneration(cfg)
    model.eval()
    model.save_pretrained(str(directory), safe_serialization=True)
    cfg.save_pretrained(str(directory))
    return directory


def png_bytes(rng, h, w) -> bytes:
    """A smooth random RGB image as PNG (Pillow's encoder, adaptive filters)."""
    from PIL import Image

    img = np.clip(np.cumsum(rng.integers(-9, 10, (h, w, 3)), axis=1) + 128, 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def qwen2vl_files(tmp_path_factory):
    """The checkpoint converted by the port (model and mmproj), each file
    byte-equal to the JAX package's."""
    from rrs_tpu.tools import convert_hf as jconv
    from rrs_tpu_torch.tools import convert_hf as tconv

    d = tmp_path_factory.mktemp("qwen2vl")
    hf = tiny_qwen2vl(d / "hf")
    out = {}
    for name, tfn, jfn in (("model", tconv.convert_hf_to_gguf, jconv.convert_hf_to_gguf),
                           ("mmproj", tconv.convert_hf_mmproj, jconv.convert_hf_mmproj)):
        out[name] = tfn(hf, d / f"{name}.gguf")
        jfn(hf, d / f"{name}-jax.gguf")
        assert out[name].read_bytes() == (d / f"{name}-jax.gguf").read_bytes(), name
    return out


def _contexts(path):
    from rrs_tpu.models.loader import load_model as jload
    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg, w, _ = load_model(path, dtype=torch.float32, device="cpu", fuse=False)
    jcfg, jw, _ = jload(path, dtype=np.float32, fuse=False)
    assert cfg == torch_cfg(jcfg) and cfg.rope_sections == (2, 3, 3, 0)
    return (InferenceContext(cfg, w, n_lanes=2, max_seq=64, kv_dtype=torch.float32, device="cpu"),
            JaxContext(jcfg, jw, n_lanes=2, max_seq=64, kv_dtype=jnp.float32))


def _assert_logits_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got - got.max(-1, keepdims=True), ref - ref.max(-1, keepdims=True),
                               atol=2e-2, rtol=0.05)


def test_qwen2vl_text_logits_match_jax(qwen2vl_files):
    """A text-only qwen2vl prompt ([B, T] positions: plain RoPE, the same
    rotation as M-RoPE with equal channels), then two decode steps."""
    ctx, jctx = _contexts(qwen2vl_files["model"])
    toks = [3, 17, 42, 5, 99, 7]
    seq, jseq = ctx.new_sequence(), jctx.new_sequence()
    got = ctx.prefill(seq, toks)
    with jax.disable_jit():
        ref = jctx.prefill(jseq, toks)
    _assert_logits_close(got.numpy(), ref)
    for tok in (11, 12):
        got = ctx.decode({seq: tok})[seq]
        with jax.disable_jit():
            ref = jctx.decode({jseq: tok})[jseq]
        _assert_logits_close(got.numpy(), ref)
    assert not ctx.kv.mrope_delta


def test_qwen2vl_image_prefill_matches_jax(qwen2vl_files):
    """[text, image, text] then decode: the image (a 13 x 22 PNG, resized to
    16 x 24 by each package's bicubic resample: 6 merged tokens) encoded by
    each package's tower, fed through ``prefill_embeds`` with its M-RoPE
    grid rows; the logits at JAX's tolerance and the lane's text delta equal
    (-3: text resumes at base + max(2, 3))."""
    from PIL import Image

    from rrs_tpu.mtmd.clip import load_mmproj as jload_mmproj
    from rrs_tpu.mtmd.pipeline import embed_images as jembed
    from rrs_tpu_torch.mtmd.clip import load_mmproj
    from rrs_tpu_torch.mtmd.image_io import decode_image
    from rrs_tpu_torch.mtmd.pipeline import embed_images

    data = png_bytes(np.random.default_rng(2), 13, 22)
    (chunk, grid), = embed_images(*load_mmproj(qwen2vl_files["mmproj"], device="cpu"),
                                  [decode_image(data)])
    with jax.disable_jit():
        (jchunk, jgrid), = jembed(*jload_mmproj(qwen2vl_files["mmproj"]),
                                  [Image.open(io.BytesIO(data))])
    assert grid == jgrid == (2, 3)
    assert rel_err(chunk.numpy(), jchunk) <= 1e-5
    ctx, jctx = _contexts(qwen2vl_files["model"])
    seq, jseq = ctx.new_sequence(), jctx.new_sequence()
    pre, post = [3, 17, 42, 100], [5, 99, 7, 23]
    got = [ctx.prefill(seq, pre), ctx.prefill_embeds(seq, chunk, mrope_grid=grid),
           ctx.prefill(seq, post)]
    with jax.disable_jit():
        ref = [jctx.prefill(jseq, pre), jctx.prefill_embeds(jseq, jchunk, mrope_grid=jgrid),
               jctx.prefill(jseq, post)]
    _assert_logits_close(torch.cat(got).numpy(), np.concatenate(ref))
    assert ctx.kv.mrope_delta == jctx.kv.mrope_delta == {0: -3}
    for tok in (11, 12):
        got = ctx.decode({seq: tok})[seq]
        with jax.disable_jit():
            ref = jctx.decode({jseq: tok})[jseq]
        _assert_logits_close(got.numpy(), ref)
    # the lane's positions trail its slots by the delta; a freed lane forgets it
    assert ctx.kv.positions_row(0, ctx.kv.lengths[0], 1).tolist() == [ctx.kv.lengths[0] - 3]
    ctx.kv.seq_rm(seq)
    assert not ctx.kv.mrope_delta
