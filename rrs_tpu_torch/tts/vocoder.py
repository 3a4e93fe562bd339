"""WavTokenizer decoder (src/models/wavtokenizer-dec.cpp's analog): audio
codes -> spectral frames for ``rrs_tpu_torch.tts.dsp.embd_to_audio``.

Port of ``rrs_tpu/tts/vocoder.py``. Graph: code embedding -> conv1d stem ->
posnet (resnet blocks of group norm + swish + conv, one single-head
self-attention block, a final group norm) -> token LayerNorm -> ConvNeXt
stack (depthwise conv k7 + LN + pointwise tanh-GELU MLP + gamma) -> output
norm -> head. The JAX package runs it as plain jnp with no TPU kernel, so
the port's is plain torch: f32 functions on the weights' device. Conv
weights are kept in ``torch.nn.functional.conv1d``'s layout [Cout, Cin /
groups, k] (the JAX package's are [k, Cin, Cout]), converted once where the
weights are made or loaded; linear weights are [in, out] for x @ w.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from rrs_tpu_torch.ops.basic import layer_norm


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                groups: int = 1) -> torch.Tensor:
    """[T, Cin] x [Cout, Cin / groups, k] -> [T, Cout], padded (k // 2,
    (k - 1) // 2) (ggml_conv_1d_ph's 'same')."""
    k = w.shape[-1]
    y = F.conv1d(F.pad(x.T[None], (k // 2, (k - 1) // 2)), w, b, groups=groups)
    return y[0].T


def group_norm(x: torch.Tensor, w, b, n_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of [T, C]: each group's statistics over time and its
    channels (LLM_NORM_GROUP)."""
    return F.group_norm(x.T[None], n_groups, w, b, eps)[0].T


@dataclasses.dataclass
class PosnetLayer:
    kind: str            # "res" | "attn" | "norm"
    params: dict


@dataclasses.dataclass
class VocoderWeights:
    embed: torch.Tensor          # [n_codes_vocab, C_embd]
    conv_w: torch.Tensor         # [C, C_embd, k] stem
    conv_b: torch.Tensor
    posnet: list                 # PosnetLayer
    tok_norm_w: torch.Tensor
    tok_norm_b: torch.Tensor
    convnext: list               # dicts: dw_w [C, 1, 7], pw1_w [C, F], pw2_w [F, C], ...
    out_norm_w: torch.Tensor
    out_norm_b: torch.Tensor
    head_w: torch.Tensor         # [C, n_embd_out]
    head_b: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tensors(self) -> list:
        ts = [getattr(self, f.name) for f in dataclasses.fields(self)]
        ts += [v for layer in self.posnet for v in layer.params.values()]
        ts += [v for blk in self.convnext for v in blk.values()]
        return [t for t in ts if isinstance(t, torch.Tensor)]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def _swish(x):
    return x * torch.sigmoid(x)


def vocoder_forward(w: VocoderWeights, codes) -> torch.Tensor:
    """codes [T] -> spectral frames [T, n_embd_out] f32 on the weights'
    device. A code past the embedding's rows reads a row of NaN, as
    ``jnp.take``'s fill mode does in the JAX package (OuteTTS's code range
    holds 4,101 ids, WavTokenizer 4,096 codes)."""
    codes = torch.as_tensor(codes, dtype=torch.long, device=w.device)
    n = w.embed.shape[0]
    x = w.embed[codes.clamp(max=n - 1)].to(torch.float32)   # [T, C_embd]
    x = x.masked_fill((codes >= n)[:, None], float("nan"))
    x = conv1d_same(x, w.conv_w, w.conv_b)
    for layer in w.posnet:
        p = layer.params
        if layer.kind == "res":
            h = _swish(group_norm(x, p["norm1_w"], p["norm1_b"]))
            h = conv1d_same(h, p["conv1_w"], p["conv1_b"])
            h = _swish(group_norm(h, p["norm2_w"], p["norm2_b"]))
            x = x + conv1d_same(h, p["conv2_w"], p["conv2_b"])
        elif layer.kind == "attn":
            h = group_norm(x, p["norm_w"], p["norm_b"])
            q = conv1d_same(h, p["q_w"], p["q_b"])
            k = conv1d_same(h, p["k_w"], p["k_b"])
            v = conv1d_same(h, p["v_w"], p["v_b"])
            att = torch.softmax(q @ k.T / math.sqrt(q.shape[-1]), dim=-1)
            x = x + conv1d_same(att @ v, p["o_w"], p["o_b"])
        else:                                                 # the final group norm
            x = group_norm(x, p["norm_w"], p["norm_b"])
    x = layer_norm(x, w.tok_norm_w, w.tok_norm_b)
    for p in w.convnext:
        h = conv1d_same(x, p["dw_w"], p["dw_b"], groups=x.shape[-1])
        h = layer_norm(h, p["norm_w"], p["norm_b"])
        h = F.gelu(h @ p["pw1_w"] + p["pw1_b"], approximate="tanh")
        x = x + (h @ p["pw2_w"] + p["pw2_b"]) * p["gamma"]
    x = layer_norm(x, w.out_norm_w, w.out_norm_b)
    return x @ w.head_w + w.head_b


def random_vocoder(n_codes_vocab: int = 4096, c: int = 512, n_embd_out: int = 1282,
                   n_convnext: int = 2, seed: int = 0, device=None) -> VocoderWeights:
    """The JAX package's random vocoder (one width ``c`` throughout): the
    same N(0, s) draws from ``np.random.default_rng(seed)`` in its order,
    the convs turned to conv1d's layout, on ``device`` (None means
    ``cuda``)."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def m(*shape, s=0.05):
        return put(rng.standard_normal(shape) * s)

    def conv(k, cin, cout):
        return put((rng.standard_normal((k, cin, cout)) * 0.05).transpose(2, 1, 0))

    def ones(n=c):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    def zeros(n=c):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def res():
        return PosnetLayer(kind="res", params=dict(
            norm1_w=ones(), norm1_b=zeros(), conv1_w=conv(3, c, c), conv1_b=zeros(),
            norm2_w=ones(), norm2_b=zeros(), conv2_w=conv(3, c, c), conv2_b=zeros()))

    posnet = [res(), res(),
              PosnetLayer(kind="attn", params=dict(
                  norm_w=ones(), norm_b=zeros(),
                  q_w=conv(1, c, c), q_b=zeros(), k_w=conv(1, c, c), k_b=zeros(),
                  v_w=conv(1, c, c), v_b=zeros(), o_w=conv(1, c, c), o_b=zeros())),
              res(), res(),
              PosnetLayer(kind="norm", params=dict(norm_w=ones(), norm_b=zeros()))]
    convnext = [dict(
        dw_w=conv(7, 1, c), dw_b=zeros(),
        norm_w=ones(), norm_b=zeros(),
        pw1_w=m(c, 3 * c), pw1_b=zeros(3 * c), pw2_w=m(3 * c, c), pw2_b=zeros(),
        gamma=ones() * 0.1,
    ) for _ in range(n_convnext)]
    return VocoderWeights(
        embed=m(n_codes_vocab, c, s=0.1),
        conv_w=conv(7, c, c), conv_b=zeros(),
        posnet=posnet, tok_norm_w=ones(), tok_norm_b=zeros(), convnext=convnext,
        out_norm_w=ones(), out_norm_b=zeros(),
        head_w=m(c, n_embd_out, s=0.02), head_b=zeros(n_embd_out))


def load_vocoder(path, device=None) -> VocoderWeights:
    """Load a WavTokenizer-dec GGUF (llama.cpp's wavtokenizer tensor names)
    in f32 on ``device`` (None means ``cuda``). A ggml conv weight of ne {k,
    Cin, Cout} reads as (Cout, Cin, k), conv1d's own layout."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.gguf.reader import read_gguf

    dev = resolve_device(device)
    with read_gguf(path) as g:
        def t(name):
            return torch.from_numpy(np.array(g.tensor(name), np.float32)).to(dev)

        def lin(name):
            """[out, in] -> [in, out] for x @ w."""
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(g.tensor(name), np.float32).T)).to(dev)

        posnet = []
        for il in range(6):
            p = f"posnet.{il}"
            if il == 2:
                posnet.append(PosnetLayer(kind="attn", params=dict(
                    norm_w=t(f"{p}.attn_norm.weight"), norm_b=t(f"{p}.attn_norm.bias"),
                    q_w=t(f"{p}.attn_q.weight"), q_b=t(f"{p}.attn_q.bias"),
                    k_w=t(f"{p}.attn_k.weight"), k_b=t(f"{p}.attn_k.bias"),
                    v_w=t(f"{p}.attn_v.weight"), v_b=t(f"{p}.attn_v.bias"),
                    o_w=t(f"{p}.attn_output.weight"), o_b=t(f"{p}.attn_output.bias"))))
            elif il == 5:
                posnet.append(PosnetLayer(kind="norm", params=dict(
                    norm_w=t(f"{p}.norm.weight"), norm_b=t(f"{p}.norm.bias"))))
            else:
                posnet.append(PosnetLayer(kind="res", params=dict(
                    norm1_w=t(f"{p}.norm1.weight"), norm1_b=t(f"{p}.norm1.bias"),
                    conv1_w=t(f"{p}.conv1.weight"), conv1_b=t(f"{p}.conv1.bias"),
                    norm2_w=t(f"{p}.norm2.weight"), norm2_b=t(f"{p}.norm2.bias"),
                    conv2_w=t(f"{p}.conv2.weight"), conv2_b=t(f"{p}.conv2.bias"))))
        convnext = []
        il = 0
        while f"convnext.{il}.dw.weight" in g.tensors:
            p = f"convnext.{il}"
            convnext.append(dict(
                dw_w=t(f"{p}.dw.weight"), dw_b=t(f"{p}.dw.bias"),
                norm_w=t(f"{p}.norm.weight"), norm_b=t(f"{p}.norm.bias"),
                pw1_w=lin(f"{p}.pw1.weight"), pw1_b=t(f"{p}.pw1.bias"),
                pw2_w=lin(f"{p}.pw2.weight"), pw2_b=t(f"{p}.pw2.bias"),
                gamma=t(f"{p}.gamma")))
            il += 1
        return VocoderWeights(
            embed=t("token_embd.weight"),
            conv_w=t("conv1d.weight"), conv_b=t("conv1d.bias"),
            posnet=posnet,
            tok_norm_w=t("token_embd_norm.weight"), tok_norm_b=t("token_embd_norm.bias"),
            convnext=convnext,
            out_norm_w=t("output_norm.weight"), out_norm_b=t("output_norm.bias"),
            head_w=lin("output.weight"), head_b=t("output.bias"))
