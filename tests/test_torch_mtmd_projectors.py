"""Every vision projector of rrs_tpu_torch (``mtmd/clip.py``) against the JAX
package's on the same patches, in f32 (rel 1e-5), and every branch of
``convert_hf_mmproj`` written byte-equal to JAX's file from the same tiny
``transformers`` checkpoint: Qwen2-VL and Qwen2.5-VL (window attention,
ragged windows), Pixtral (with its ``[IMG_BREAK]`` row), Idefics3 and
InternVL (CLS row, layer scales), each read back by both packages' loaders;
the LLaVA mlp and gemma3 towers on JAX's random weights carried across,
``random_clip_weights`` against JAX's shapes and scales, and the MiniCPM-V
resampler from a written mmproj."""

import json

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.mtmd import clip as jclip
from rrs_tpu_torch.mtmd import clip

from test_torch_common import rel_err, torch_clip

transformers = pytest.importorskip("transformers")

ENC_TOL = 1e-5


def _save(model, cfg, d):
    torch.manual_seed(0)
    model = model(cfg)
    model.eval()
    model.save_pretrained(str(d), safe_serialization=True)
    cfg.save_pretrained(str(d))
    return d


def _qwen2vl(d):
    from test_torch_qwen2vl import tiny_qwen2vl

    return tiny_qwen2vl(d)


def _qwen25vl(d):
    from test_qwen25vl import _tiny_qwen25vl

    return _tiny_qwen25vl(d.parent)[0]


def _pixtral(d):
    from test_pixtral import _tiny_llava_pixtral

    out = _tiny_llava_pixtral(d.parent)[0]
    cfg = json.loads((out / "config.json").read_text())
    cfg["image_break_token_id"] = 5                  # the [IMG_BREAK] row of the table
    (out / "config.json").write_text(json.dumps(cfg))
    return out


def _idefics3(d):
    vc = transformers.Idefics3VisionConfig(hidden_size=32, intermediate_size=64,
                                           num_hidden_layers=2, num_attention_heads=2,
                                           image_size=32, patch_size=8)
    cfg = transformers.Idefics3Config(
        vision_config=vc, scale_factor=2,
        text_config=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=1,
                         num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                         rms_norm_eps=1e-6))
    return _save(transformers.Idefics3ForConditionalGeneration, cfg, d)


def _internvl(d):
    vc = transformers.InternVLVisionConfig(hidden_size=32, intermediate_size=64,
                                           num_hidden_layers=2, num_attention_heads=2,
                                           image_size=32, patch_size=8)
    cfg = transformers.InternVLConfig(
        vision_config=vc, downsample_ratio=0.5,
        text_config=dict(model_type="qwen2", hidden_size=48, intermediate_size=96,
                         num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                         vocab_size=128))
    return _save(transformers.InternVLForConditionalGeneration, cfg, d)


# branch -> (checkpoint writer, image grid in patches or None for the square input)
BRANCHES = {"qwen2vl": (_qwen2vl, (4, 6)), "qwen2.5vl": (_qwen25vl, (4, 6)),
            "pixtral": (_pixtral, (4, 6)), "idefics3": (_idefics3, None),
            "internvl": (_internvl, None)}


def _encode(mod, ccfg, cw, patches, grid):
    if ccfg.projector_type in ("qwen2vl_merger", "qwen2.5vl_merger"):
        return mod.encode_image_qwen2vl(ccfg, cw, patches, grid)
    if ccfg.projector_type == "pixtral":
        return mod.encode_image_pixtral(ccfg, cw, patches, grid)
    if ccfg.projector_type == "resampler":
        return mod.encode_image_minicpmv(ccfg, cw, patches)
    return mod.encode_image(ccfg, cw, patches)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_mmproj_branch_matches_jax(tmp_path, branch):
    """The branch's mmproj file equals JAX's byte for byte; both loaders
    read the same config; the port's tower on the file's weights (and on
    JAX's weights carried across, bit for bit the same) gives JAX's
    embeddings within 1e-5."""
    from rrs_tpu.tools.convert_hf import convert_hf_mmproj as jconvert
    from rrs_tpu_torch.tools.convert_hf import convert_hf_mmproj

    writer, grid = BRANCHES[branch]
    d = writer(tmp_path / "hf")
    convert_hf_mmproj(d, tmp_path / "t.gguf")
    jconvert(d, tmp_path / "j.gguf")
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    ccfg, cw = clip.load_mmproj(tmp_path / "t.gguf", device="cpu")
    jccfg, jcw = jclip.load_mmproj(tmp_path / "j.gguf")
    carried_cfg, carried = torch_clip(jccfg, jcw)
    assert ccfg == carried_cfg
    n = grid[0] * grid[1] if grid else ccfg.n_patches
    patches = np.random.default_rng(7).standard_normal(
        (n, 3 * ccfg.patch_size ** 2)).astype(np.float32)
    got = _encode(clip, ccfg, cw, patches, grid)
    assert torch.equal(got, _encode(clip, ccfg, carried, patches, grid))
    with jax.disable_jit():
        ref = np.asarray(_encode(jclip, jccfg, jcw, patches, grid))
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), ref) <= ENC_TOL
    if branch == "pixtral":
        assert cw.img_break is not None and got.shape[0] == n + grid[0] - 1


@pytest.mark.parametrize("ptype", ["mlp", "gemma3", "qwen2vl_merger"])
def test_random_clip_weights_match_jax(ptype):
    """``random_clip_weights`` has the JAX function's fields, shapes, zeros,
    ones and N(0, 0.02) scale (drawn on the device, so other values; a
    Qwen2-VL merger's mm.0 at its 2 x 2 block width, which the JAX function
    leaves at E), the same draws for the same seed, and the tower encodes to
    the right shape."""
    cfg = clip.ClipConfig(image_size=56, patch_size=14, n_embd=64, n_layers=2, n_heads=4,
                          n_ff=128, n_embd_llm=96, n_merge=2, projector_type=ptype)
    jcfg = jclip.ClipConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    w = clip.random_clip_weights(cfg, seed=3, device="cpu")
    _, ref = torch_clip(jcfg, jclip.random_clip_weights(jcfg, seed=3))
    pairs = [(f, getattr(w, f), getattr(ref, f)) for f in clip.ClipWeights.__dataclass_fields__
             if f != "layers"]
    pairs += [(f, getattr(lw, f), getattr(lr, f)) for lw, lr in zip(w.layers, ref.layers)
              for f in clip.ClipLayer.__dataclass_fields__]
    merger_mm = ("mm0_w", "mm0_b", "mm2_w") if ptype == "qwen2vl_merger" else ()
    for name, x, y in pairs:
        if x is None or y is None:
            assert x is None and y is None, name
        elif name in merger_mm:
            continue
        elif y.abs().max() == 0 or (y == 1).all():
            assert torch.equal(x, y), name                       # biases and norms
        else:
            assert x.shape == y.shape and abs(x.std().item() / 0.02 - 1) < 0.1, name
    assert torch.equal(clip.random_clip_weights(cfg, seed=3, device="cpu").patch_w, w.patch_w)
    patches = np.random.default_rng(8).standard_normal(
        (cfg.n_patches, 3 * 14 * 14)).astype(np.float32)
    if ptype == "qwen2vl_merger":
        assert tuple(w.mm0_w.shape) == (4 * 64, 4 * 64) and tuple(w.mm2_w.shape) == (256, 96)
        out = clip.encode_image_qwen2vl(cfg, w, patches, (4, 4))
    else:
        out = clip.encode_image(cfg, w, patches)
    n = 4 if ptype in ("qwen2vl_merger", "gemma3") else cfg.n_patches
    assert tuple(out.shape) == (n, 96) and torch.isfinite(out).all()


def test_minicpmv_resampler_matches_jax(tmp_path):
    """The resampler mmproj of tests/test_mtmd_projectors.py, written by the
    port's writer and read by both loaders: [query_num, n_embd_llm] within
    1e-5 of JAX's, and the 2-D sincos table equal."""
    from rrs_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(0)
    e, ep, llm, q, p, img = 32, 256, 48, 8, 8, 32
    g = img // p
    w = GGUFWriter(tmp_path / "mm.gguf")
    w.add_string("general.architecture", "clip")
    w.add_string("clip.projector_type", "resampler")
    w.add_uint32("clip.minicpmv_query_num", q)
    for k, v in (("image_size", img), ("patch_size", p), ("embedding_length", e),
                 ("block_count", 1), ("attention.head_count", 2),
                 ("feed_forward_length", 64), ("projection_dim", llm)):
        w.add_uint32(f"clip.vision.{k}", v)

    def add(name, *shape):
        w.add_tensor(name, (rng.standard_normal(shape) * 0.05).astype(np.float32))

    add("v.patch_embd.weight", e, 3, p, p)
    add("v.patch_embd.bias", e)
    add("v.position_embd.weight", g * g, e)
    for nm in ("ln1", "ln2"):
        add(f"v.blk.0.{nm}.weight", e)
        add(f"v.blk.0.{nm}.bias", e)
    for nm in ("attn_q", "attn_k", "attn_v", "attn_out"):
        add(f"v.blk.0.{nm}.weight", e, e)
        add(f"v.blk.0.{nm}.bias", e)
    add("v.blk.0.ffn_up.weight", 64, e)
    add("v.blk.0.ffn_up.bias", 64)
    add("v.blk.0.ffn_down.weight", e, 64)
    add("v.blk.0.ffn_down.bias", e)
    add("resampler.query", q, ep)
    add("resampler.kv.weight", ep, e)
    for nm in ("ln_q", "ln_kv", "ln_post"):
        add(f"resampler.{nm}.weight", ep)
        add(f"resampler.{nm}.bias", ep)
    for nm in ("q", "k", "v", "out"):
        add(f"resampler.attn.{nm}.weight", ep, ep)
        add(f"resampler.attn.{nm}.bias", ep)
    add("resampler.proj.weight", ep, llm)
    w.write()
    ccfg, cw = clip.load_mmproj(tmp_path / "mm.gguf", device="cpu")
    jccfg, jcw = jclip.load_mmproj(tmp_path / "mm.gguf")
    assert ccfg.projector_type == "resampler" and ccfg.query_num == q
    patches = (rng.standard_normal((g * g, 3 * p * p)) * 0.1).astype(np.float32)
    got = clip.encode_image_minicpmv(ccfg, cw, patches)
    with jax.disable_jit():
        ref = np.asarray(jclip.encode_image_minicpmv(jccfg, jcw, patches))
    assert tuple(got.shape) == ref.shape == (q, llm)
    assert rel_err(got.numpy(), ref) <= ENC_TOL
    np.testing.assert_array_equal(clip._sincos_2d(ep, 2, 3), jclip._sincos_2d(ep, 2, 3))


def test_qwen2vl_positions_and_windows_match_jax():
    """The token orders and 2-D rotary tables the towers build on: the 2 x 2
    block order, Qwen2.5-VL's windows (ragged at the edges), and the qwen2vl
    and Pixtral cos / sin tables, equal to JAX's."""
    for gh, gw in ((4, 6), (6, 10)):
        np.testing.assert_array_equal(clip.qwen2vl_block_order(gh, gw),
                                      jclip.qwen2vl_block_order(gh, gw))
        for a, b in zip(clip.qwen25vl_window_order(gh, gw, 2, 2),
                        jclip.qwen25vl_window_order(gh, gw, 2, 2)):
            np.testing.assert_array_equal(a, b)
    cfg, jcfg = clip.ClipConfig(), jclip.ClipConfig()
    h, w = np.arange(24) // 6, np.arange(24) % 6
    for fn, jfn in ((clip._vision_rope_2d, jclip._vision_rope_2d),
                    (clip._vision_rope_2d_pixtral, jclip._vision_rope_2d_pixtral)):
        for a, b in zip(fn(cfg, h, w, 16), jfn(jcfg, h, w, 16)):
            np.testing.assert_array_equal(a, np.asarray(b))
