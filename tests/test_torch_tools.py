"""The port's tool suite against the JAX package's, on the CPU:
``export_lora_merged`` (byte-equal on F32 and Q8_0 bases), the control
vector (directions within DIR_TOL relative L2 on dense weights, the file
byte-equal), ``fit_params`` and its parts for every preset, the logging
sink, ``quantize_stats.tensor_stats``, and each new verb of
``python -m rrs_tpu_torch`` run with ``--device cpu`` in a process of its own
against the JAX function it calls."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rrs_tpu.gguf.writer import GGUFWriter as JaxWriter
from rrs_tpu.models import llama as jllama
from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.tools import cvector, export_lora, quantize_stats
from rrs_tpu_torch.utils import fit_params, logging as ulog

from test_torch_common import jax_cfg, tiny_vocab_tokens, torch_cfg, weights_tree

ROOT = Path(__file__).resolve().parent.parent
# mean hidden states of bf16 forwards that round at different sites (see
# tests/test_torch_imatrix.py); a wrong layer or a missed residual is order one
DIR_TOL = 1e-2
# every statistic, the TCQ4 matvec's too, comes from the same host code as
# JAX's (its integer-exact oracle for TCQ4)
DOT_TOL = 1e-5


def _cfg():
    return jax_cfg(n_embd=256, n_ff=512, vocab_size=128)


def _base_gguf(d, name="base.gguf"):
    cfg = _cfg()
    return export_random_gguf(cfg, d / name, seed=0, vocab_tokens=tiny_vocab_tokens(128))


def _adapter(d, cfg, seed=0):
    rng = np.random.default_rng(seed)
    w = JaxWriter(d / "adapter.gguf")
    w.add_string("general.architecture", cfg.arch)
    w.add_float32("adapter.lora.alpha", 8.0)
    for li, name, (n, k) in ((0, "attn_q", (cfg.n_q_dim, cfg.n_embd)),
                             (1, "ffn_down", (cfg.n_embd, cfg.n_ff))):
        w.add_tensor(f"blk.{li}.{name}.weight.lora_a",
                     (rng.standard_normal((4, k)) * 0.1).astype(np.float32))
        w.add_tensor(f"blk.{li}.{name}.weight.lora_b",
                     (rng.standard_normal((n, 4)) * 0.1).astype(np.float32))
    w.write()
    return d / "adapter.gguf"


@pytest.mark.parametrize("base_type", ["f32", "q8_0"])
def test_export_lora_matches_jax(tmp_path, base_type):
    from rrs_tpu.quantize.quantizer import quantize_model
    from rrs_tpu.tools.export_lora import export_lora_merged as jax_merge

    base = _base_gguf(tmp_path)
    if base_type == "q8_0":
        quantize_model(base, tmp_path / "q8.gguf", verbose=False, out_type="q8_0")
        base = tmp_path / "q8.gguf"
    lora = _adapter(tmp_path, _cfg())
    jax_merge(base, lora, tmp_path / "j.gguf", scale=0.7)
    out = export_lora.export_lora_merged(base, lora, tmp_path / "t.gguf", scale=0.7)
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_export_lora_refuses_an_unmatched_adapter(tmp_path):
    base = _base_gguf(tmp_path)
    lora = _adapter(tmp_path, dataclasses.replace(_cfg(), arch="x"))
    w = JaxWriter(tmp_path / "other.gguf")
    w.add_float32("adapter.lora.alpha", 8.0)
    w.add_tensor("blk.9.attn_q.weight.lora_a", np.ones((2, 4), np.float32))
    w.add_tensor("blk.9.attn_q.weight.lora_b", np.ones((4, 2), np.float32))
    w.write()
    assert lora.exists()
    with pytest.raises(ValueError, match="no adapter tensors"):
        export_lora.export_lora_merged(base, tmp_path / "other.gguf", tmp_path / "x.gguf")


def test_control_vector_matches_jax(tmp_path):
    from rrs_tpu.tools import cvector as jcvector

    cfg = _cfg()
    jw = jllama.random_weights(cfg, seed=1)
    tw = llama.weights_from_numpy(torch_cfg(cfg), weights_tree(jw), device="cpu")
    pos = [[1, 2, 3, 40], [4, 5, 6, 7, 80]]
    neg = [[9, 10, 90], [11, 12, 13]]
    ref = jcvector.build_control_vector(cfg, jw, pos, neg)
    got = cvector.build_control_vector(torch_cfg(cfg), tw, pos, neg)
    assert got.shape == ref.shape == (cfg.n_layers, cfg.n_embd) and got.dtype == np.float32
    for li in range(cfg.n_layers):
        rel = np.linalg.norm(got[li] - ref[li]) / np.linalg.norm(ref[li])
        assert rel < DIR_TOL, (li, rel)
    jcvector.save_control_vector(tmp_path / "j.gguf", ref, model_hint="tiny")
    out = cvector.save_control_vector(tmp_path / "t.gguf", ref, model_hint="tiny")
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()
    cv = cvector.load_control_vector(out, cfg.n_layers, cfg.n_embd, strength=0.5)
    assert cv.strength == 0.5
    np.testing.assert_array_equal(cv.vectors.numpy(), ref)


def _recurrent_cfg():
    return JaxConfig(arch="mamba", n_layers=4, n_embd=768, n_heads=0, n_kv_heads=0, head_dim=0,
                     n_ff=0, vocab_size=50280, context_length=2048, ssm_d_conv=4,
                     ssm_d_inner=1536, ssm_d_state=16, ssm_dt_rank=48)


FIT_CASES = sorted(JAX_PRESETS) + ["mamba", "qwen3moe", "gemma2-swa"]


def _fit_cfg(name):
    if name == "mamba":
        return _recurrent_cfg()
    if name == "qwen3moe":
        return jax_cfg(arch="qwen3moe", n_experts=8, n_experts_used=2, n_ff_exp=256)
    if name == "gemma2-swa":
        return dataclasses.replace(JAX_PRESETS["gemma2-9b"], swa_window=4096, swa_pattern=2)
    return JAX_PRESETS[name]


@pytest.mark.parametrize("name", FIT_CASES)
def test_fit_params_match_jax(name):
    from rrs_tpu.utils import fit_params as jfit

    jc = _fit_cfg(name)
    tc = torch_cfg(jc)
    assert fit_params.model_bytes(tc) == jfit.model_bytes(jc)
    assert fit_params.recurrent_state_bytes(tc) == jfit.recurrent_state_bytes(jc)
    for kv in ("none", "q8", "q4"):
        assert fit_params.kv_bytes_per_slot(tc, kv) == jfit.kv_bytes_per_slot(jc, kv)
        for hbm, lanes, ctx in ((16 * 1024**3, 1, 0), (80 * 1024**3, 4, 0),
                                (4 * 1024**3, 4, 32768), (80 * 1024**3, 2, 4096)):
            got = fit_params.fit_params(tc, hbm_bytes=hbm, n_lanes=lanes, n_ctx=ctx,
                                        kv_quant=kv)
            ref = jfit.fit_params(jc, hbm_bytes=hbm, n_lanes=lanes, n_ctx=ctx, kv_quant=kv)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_logging_sink(monkeypatch):
    from rrs_tpu.utils import logging as jlog

    seen = []
    ulog.log_set(lambda lvl, line: seen.append((lvl, line)))
    try:
        ulog.set_level("info")
        log = ulog.get_logger("test")
        log.debug("hidden %d", 1)
        log.info("shown %d", 2)
        log.warning("warned")
        log.error("err")
        ulog.set_level("nonsense")          # an unknown name keeps the level
        log.info("still %s", "shown")
        ulog.set_level("none")
        log.error("silenced")
    finally:
        ulog.log_set(None)
        ulog.set_level("info")
    assert [lvl for lvl, _ in seen] == [20, 30, 40, 20]
    assert "I test: shown 2" in seen[0][1] and "W test: warned" in seen[1][1]
    assert "still shown" in seen[3][1]
    assert ulog._LEVELS == jlog._LEVELS


def test_tensor_stats_match_jax():
    from rrs_tpu.tools.quantize_stats import tensor_stats as jstats

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    x = rng.standard_normal((32, 512)).astype(np.float32)
    ref, got = jstats(w, x), quantize_stats.tensor_stats(w, x, device="cpu")
    assert sorted(got) == sorted(ref) == ["q4_k", "q8_0", "tcq4", "tcq4_reorder"]
    for fmt in ref:
        for key, v in ref[fmt].items():
            tol = DOT_TOL if fmt.startswith("tcq4") and key == "rmse_dot" else 1e-5
            assert abs(got[fmt][key] - v) <= tol * abs(v), (fmt, key, got[fmt][key], v)
    assert got["q8_0"]["rmse_dot"] < got["q4_k"]["rmse_dot"] < got["tcq4"]["rmse_dot"] < 0.2
    # beside the oracle's: the same matvec through B4's plain version (bf16 operands)
    for fmt in ("tcq4", "tcq4_reorder"):
        assert abs(got[fmt]["rmse_dot_b4"] - ref[fmt]["rmse_dot"]) <= 1e-3 * ref[fmt]["rmse_dot"]


def test_act_quant_matches_jax():
    from rrs_tpu.tools.quantize_stats import _act_quant_rrs as jquant

    x = (np.random.default_rng(5).standard_normal((6, 512)) * 2).astype(np.float32)
    x[2, :256] = 0.0                                   # an all-zero block: scale 1
    (q, s), (jq, js) = quantize_stats._act_quant_rrs(x), jquant(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


# -- the verbs, each a process of its own --------------------------------

def _verb(*argv, timeout=300) -> str:
    r = subprocess.run([sys.executable, "-m", "rrs_tpu_torch", *map(str, argv)], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tools_verbs")
    base = _base_gguf(d)
    (d / "pos.txt").write_text("abcde\nfghij\n\n", encoding="utf-8")
    (d / "neg.txt").write_text("zyxw\nvuts\n", encoding="utf-8")
    return d, base


def test_verb_tokenize(files):
    from rrs_tpu.gguf.reader import read_gguf as jread
    from rrs_tpu.models.vocab import Vocab as JaxVocab

    d, base = files
    with jread(base) as g:
        ids = JaxVocab.from_gguf(g.metadata).encode("hello")
    assert _verb("tokenize", "-m", base, "-p", "hello", "--ids-only").split() == \
        [str(i) for i in ids]
    rows = _verb("tokenize", "-m", base, "-p", "hello").splitlines()
    assert [int(r.split("->")[0]) for r in rows] == ids and "'h'" in rows[0]


def test_verb_fit_params(files):
    from rrs_tpu.gguf.reader import read_gguf as jread
    from rrs_tpu.utils.fit_params import fit_params as jfit

    d, base = files
    with jread(base) as g:
        r = jfit(JaxConfig.from_gguf(g.metadata), hbm_bytes=int(2.5 * 1024**3), n_lanes=2,
                 kv_quant="q8")
    out = _verb("fit-params", "-m", base, "--hbm-gib", "2.5", "--parallel", "2",
                "--cache-type", "q8")
    assert out.strip() == (f"fits={r.fits} n_ctx={r.n_ctx} n_lanes={r.n_lanes} "
                           f"model={r.model_bytes/1e9:.2f}GB kv={r.kv_bytes/1e9:.2f}GB "
                           f"free={r.free_bytes/1e9:.2f}GB")


def test_verb_export_lora(files, tmp_path):
    from rrs_tpu.tools.export_lora import export_lora_merged as jax_merge

    d, base = files
    lora = _adapter(tmp_path, _cfg(), seed=3)
    out = _verb("export-lora", "-m", base, "--lora", lora, "-o", tmp_path / "t.gguf",
                "--lora-scale", "2")
    assert out.strip() == f"wrote merged model -> {tmp_path / 't.gguf'}"
    jax_merge(base, lora, tmp_path / "j.gguf", scale=2.0)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_verb_cvector(files, tmp_path):
    from rrs_tpu.models import loader as jloader
    from rrs_tpu.models.vocab import Vocab as JaxVocab
    from rrs_tpu.tools import cvector as jcvector

    d, base = files
    out = _verb("cvector", "-m", base, "--positive-file", d / "pos.txt", "--negative-file",
                d / "neg.txt", "-o", tmp_path / "cv.gguf", "--device", "cpu")
    assert out.strip() == f"wrote control vector (2 layers) -> {tmp_path / 'cv.gguf'}"
    jc, jw, md = jloader.load_model(base)
    v = JaxVocab.from_gguf(md)
    ref = jcvector.build_control_vector(jc, jw, [v.encode("abcde"), v.encode("fghij")],
                                        [v.encode("zyxw"), v.encode("vuts")])
    got = cvector.load_control_vector(tmp_path / "cv.gguf", 2, jc.n_embd).vectors.numpy()
    for li in range(2):
        assert np.linalg.norm(got[li] - ref[li]) / np.linalg.norm(ref[li]) < DIR_TOL


def test_verb_quantize_stats(files):
    d, base = files
    rows = [json.loads(line) for line in _verb(
        "quantize-stats", "-m", base, "--max-tensors", "2", "--samples", "16", "--json",
        "--device", "cpu").splitlines()]
    assert [r["tensor"] for r in rows] == ["token_embd.weight", "blk.0.attn_q.weight"]
    for r in rows:
        assert 0 < r["q8_0_rmse_dot"] < r["q4_k_rmse_dot"] < r["tcq4_rmse_dot"] < 0.3, r
    text = _verb("quantize-stats", "--max-tensors", "1", "--samples", "8", "--device", "cpu")
    assert "mean rel RMSE(y) tcq4" in text and "synthetic.0" in text


def test_verb_convert_hf(tmp_path):
    from rrs_tpu.tools.convert_hf import convert_hf_to_gguf as jax_convert
    from rrs_tpu_torch.tools.safetensors_io import save_safetensors

    d = tmp_path / "hf"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3ForCausalLM"], "num_hidden_layers": 1, "hidden_size": 64,
        "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "vocab_size": 32, "tie_word_embeddings": True}))
    rng = np.random.default_rng(0)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    p = "model.layers.0."
    save_safetensors(d / "model.safetensors", {
        "model.embed_tokens.weight": t(32, 64), "model.norm.weight": t(64),
        p + "input_layernorm.weight": t(64), p + "post_attention_layernorm.weight": t(64),
        p + "self_attn.q_proj.weight": t(64, 64), p + "self_attn.k_proj.weight": t(32, 64),
        p + "self_attn.v_proj.weight": t(32, 64), p + "self_attn.o_proj.weight": t(64, 64),
        p + "self_attn.q_norm.weight": t(16), p + "self_attn.k_norm.weight": t(16),
        p + "mlp.gate_proj.weight": t(128, 64), p + "mlp.up_proj.weight": t(128, 64),
        p + "mlp.down_proj.weight": t(64, 128)})
    out = _verb("convert-hf", d, tmp_path / "t.gguf", "--outtype", "f16")
    assert out.strip() == f"wrote {tmp_path / 't.gguf'}"
    jax_convert(d, tmp_path / "j.gguf", out_dtype=np.float16)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
