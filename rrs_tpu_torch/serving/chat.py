"""Chat templating + tool-call parsing + reasoning extraction
(common/chat*.cpp analog).

Host code, copied whole from ``rrs_tpu/serving/chat.py`` so that the port
imports nothing of the JAX package. jinja2 is imported lazily; where it is
missing, rendering falls back to the built-in template families, as there.

Primary path: the GGUF's ``tokenizer.chat_template`` rendered with jinja2
in an HF-compatible sandbox (the role common/jinja/'s hand-written engine
plays for C++ — Python has the real engine these templates were written
for). Heuristic template families (ChatML/Llama-3/Gemma/Mistral) remain
the fallback when a model ships no template or it fails to render.

Tool-call output parsing covers the major dialects of common/chat.cpp
(COMMON_CHAT_FORMAT_*): Qwen3-Coder XML ``<function=..><parameter=..>``,
Seed-OSS ``<seed:tool_call>``, MiniMax-M2 ``<minimax:tool_call><invoke>``,
Kimi-K2 ``<|tool_call_begin|>``, Granite ``<|tool_call|>[json]``,
Hermes/Qwen ``<tool_call>{json}</tool_call>``,
Llama-3.x bare JSON + ``<|python_tag|>``, Mistral-Nemo ``[TOOL_CALLS]``,
DeepSeek-R1 marker blocks, Command-R7B ``<|START_ACTION|>``, Functionary
v3.1 ``<function=...>``, GPT-OSS harmony channels, with a generic JSON
fallback; reasoning extraction handles ``<think>`` and
``<|START_THINKING|>`` (common_chat_params reasoning_format analog).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Optional


# ---------------------------------------------------------------------------
# Jinja rendering (common/chat.cpp apply + common/jinja/ analog)
# ---------------------------------------------------------------------------

def _jinja_env():
    from jinja2 import Environment
    from jinja2.ext import loopcontrols
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True, extensions=[loopcontrols])

    def raise_exception(msg):
        raise RuntimeError(f"chat template error: {msg}")

    def strftime_now(fmt):
        import datetime

        return datetime.datetime.now().strftime(fmt)

    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    env.filters["tojson"] = lambda v, indent=None: json.dumps(
        v, ensure_ascii=False, indent=indent)
    return env


_ENV = None


def render_jinja(
    template: str,
    messages: list[dict],
    tools: Optional[list[dict]] = None,
    add_generation_prompt: bool = True,
    special: Optional[dict] = None,
) -> str:
    """Render a tokenizer.chat_template with the HF-conventional context
    (messages/tools/add_generation_prompt/bos_token/eos_token). Raises on
    template errors — callers fall back to the heuristic families."""
    global _ENV
    if _ENV is None:
        _ENV = _jinja_env()
    ctx = {
        "messages": messages,
        "tools": tools if tools else None,
        "add_generation_prompt": add_generation_prompt,
        "bos_token": "",
        "eos_token": "",
    }
    if special:
        ctx.update(special)
    return _ENV.from_string(template).render(**ctx)


def build_prompt(
    md_template: str,
    fallback: str,
    messages: list[dict],
    tools: Optional[list[dict]] = None,
    add_assistant: bool = True,
    special: Optional[dict] = None,
) -> tuple[str, tuple[str, ...]]:
    """Render the chat prompt, preferring the model's own Jinja template.
    Returns (prompt, extra stop strings)."""
    if md_template:
        try:
            text = render_jinja(md_template, messages, tools=tools,
                                add_generation_prompt=add_assistant,
                                special=special)
            return text, stop_strings_for(detect_template(
                {"tokenizer.chat_template": md_template}))
        except Exception:                                   # noqa: BLE001
            pass
    return (apply_template(fallback, messages, add_assistant=add_assistant,
                           tools=tools),
            stop_strings_for(fallback))


def detect_template(md: dict) -> str:
    tmpl = str(md.get("tokenizer.chat_template", "") or "")
    if "<|im_start|>" in tmpl:
        return "chatml"
    if "<|start_header_id|>" in tmpl:
        return "llama3"
    if "<start_of_turn>" in tmpl:
        return "gemma"
    if "[INST]" in tmpl:
        return "mistral"
    arch = str(md.get("general.architecture", ""))
    if arch.startswith("qwen"):
        return "chatml"
    if arch.startswith("gemma"):
        return "gemma"
    if arch.startswith("llama"):
        return "llama3"
    return "chatml"


def _content_str(m: dict) -> str:
    """OAI messages may carry list-of-parts content; flatten text parts."""
    c = m.get("content")
    if isinstance(c, list):
        return "".join(p.get("text", "") for p in c if isinstance(p, dict))
    return "" if c is None else str(c)


def apply_template(
    name: str,
    messages: list[dict],
    add_assistant: bool = True,
    tools: Optional[list[dict]] = None,
) -> str:
    if tools:
        messages = _inject_tools(messages, tools)
    out = []
    if name == "chatml":
        for m in messages:
            role = m["role"]
            if role == "tool":
                out.append("<|im_start|>user\n<tool_response>\n"
                           f"{_content_str(m)}\n</tool_response><|im_end|>\n")
                continue
            body = _content_str(m)
            if role == "assistant" and m.get("tool_calls"):
                for tc in m["tool_calls"]:
                    fn = tc.get("function", tc)
                    body += ("\n<tool_call>\n" + json.dumps(
                        {"name": fn.get("name"),
                         "arguments": _maybe_json(fn.get("arguments"))})
                        + "\n</tool_call>")
            out.append(f"<|im_start|>{role}\n{body}<|im_end|>\n")
        if add_assistant:
            out.append("<|im_start|>assistant\n")
    elif name == "llama3":
        out.append("<|begin_of_text|>")
        for m in messages:
            role = "ipython" if m["role"] == "tool" else m["role"]
            out.append(
                f"<|start_header_id|>{role}<|end_header_id|>\n\n{_content_str(m)}<|eot_id|>"
            )
        if add_assistant:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    elif name == "gemma":
        # gemma has no system role: fold system text into the first user turn
        sys_txt = ""
        out.append("<bos>")
        for m in messages:
            role = m["role"]
            if role == "system":
                sys_txt = _content_str(m) + "\n\n"
                continue
            role = "model" if role == "assistant" else "user"
            body = sys_txt + _content_str(m) if role == "user" else _content_str(m)
            sys_txt = ""
            out.append(f"<start_of_turn>{role}\n{body}<end_of_turn>\n")
        if add_assistant:
            out.append("<start_of_turn>model\n")
    elif name == "mistral":
        for m in messages:
            if m["role"] == "assistant":
                out.append(f"{_content_str(m)}</s>")
            else:
                out.append(f"[INST] {_content_str(m)} [/INST]")
    else:
        for m in messages:
            out.append(f"{m['role']}: {_content_str(m)}\n")
        if add_assistant:
            out.append("assistant: ")
    return "".join(out)


def stop_strings_for(name: str) -> tuple[str, ...]:
    return {
        "chatml": ("<|im_end|>",),
        "llama3": ("<|eot_id|>",),
        "gemma": ("<end_of_turn>",),
        "mistral": ("</s>",),
    }.get(name, ())


# ---------------------------------------------------------------------------
# Tools (Hermes-style injection + parsing; common/chat.cpp tool-call handling)
# ---------------------------------------------------------------------------

def _maybe_json(v):
    if isinstance(v, str):
        try:
            return json.loads(v)
        except Exception:
            return v
    return v


def _inject_tools(messages: list[dict], tools: list[dict]) -> list[dict]:
    """Prepend a system preamble describing the available tools and the
    <tool_call> convention (the Hermes template family's system block)."""
    specs = []
    for t in tools:
        fn = t.get("function", t)
        specs.append(json.dumps({
            "name": fn.get("name"),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {}),
        }))
    preamble = (
        "You are a function-calling AI. You may call one or more functions "
        "to assist with the user query. Available tools:\n<tools>\n"
        + "\n".join(specs)
        + "\n</tools>\nFor each call, return a JSON object inside "
        "<tool_call></tool_call> tags: "
        '<tool_call>{"name": <name>, "arguments": <args-json>}</tool_call>'
    )
    msgs = list(messages)
    if msgs and msgs[0].get("role") == "system":
        merged = dict(msgs[0])
        merged["content"] = _content_str(msgs[0]) + "\n\n" + preamble
        return [merged] + msgs[1:]
    return [{"role": "system", "content": preamble}] + msgs


# EXAONE wraps the JSON in a ```json fence inside the block
# (chat-parser.cpp common_chat_parse_exaone_moe_content)
_TOOL_CALL_RE = re.compile(
    r"<tool_call>\s*(?:```(?:json)?\s*)?(\{.*?\})\s*(?:```\s*)?"
    r"</tool_call>", re.S)


def detect_tool_format(template: str) -> str:
    """Map a chat template's markers to a tool-call dialect (the format
    switch of common_chat_templates_apply_jinja, common/chat.cpp:650+)."""
    t = template or ""
    if "<seed:tool_call>" in t:
        return "seed-oss"               # chat.cpp:2746 (Seed-OSS)
    if "<minimax:tool_call>" in t:
        return "minimax-m2"             # chat.cpp:1871 (MiniMax-M2)
    if "<|tool_call_begin|>" in t or "<|im_middle|>" in t:
        return "kimi-k2"                # chat.cpp:1923+ (Kimi-K2)
    if "<parameter=" in t and "<function=" in t:
        return "qwen3-coder"            # chat.cpp:1891 (Qwen3-Coder XML)
    if "<TOOLCALL>" in t:
        return "nemotron-v2"            # chat-parser.cpp:1261
    if "<tool_calls>" in t and "<tool_call>" not in t:
        return "apriel-1.5"             # chat-parser.cpp:932
    if "<|tool_call|>" in t:
        return "granite"                # chat.cpp:2533 (Granite 3.x)
    if "<tool_call>" in t or "<|im_start|>" in t:
        return "hermes"                 # Hermes-2-Pro / Qwen family
    if "<｜tool▁calls▁begin｜>" in t or "<｜tool▁calls｜>" in t:
        return "deepseek"
    if "[TOOL_CALLS]" in t:
        return "mistral"
    if "<|START_ACTION|>" in t:
        return "command-r7b"
    if "<function=" in t:
        return "functionary-3.1"
    if "<|channel|>" in t:
        return "gpt-oss"
    if "<|python_tag|>" in t or "<|start_header_id|>" in t:
        return "llama3"
    return "generic"


def _mk_call(name, args, call_id=None):
    return {
        "id": call_id or f"call_{uuid.uuid4().hex[:8]}",
        "type": "function",
        "function": {
            "name": name or "",
            "arguments": args if isinstance(args, str)
            else json.dumps(args, ensure_ascii=False),
        },
    }


def _parse_json_maybe(blob):
    try:
        return json.loads(blob)
    except Exception:                                       # noqa: BLE001
        return None


_DS_CALL_RE = re.compile(
    r"<｜tool▁call▁begin｜>(?:function<｜tool▁sep｜>)?([^\n<]+)\n"
    r"```json\n(.*?)\n```<｜tool▁call▁end｜>", re.S)
_DS_BLOCK_RE = re.compile(
    r"<｜tool▁calls▁begin｜>.*?(?:<｜tool▁calls▁end｜>|$)", re.S)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*?\])(?=\s*(?:\[TOOL_CALLS\]|$))", re.S)
_ACTION_RE = re.compile(r"<\|START_ACTION\|>\s*(\[.*?\])\s*<\|END_ACTION\|>", re.S)
_FUNC31_RE = re.compile(r"<function=([^>]+)>(.*?)</function>", re.S)
_GPTOSS_RE = re.compile(
    r"<\|channel\|>commentary to=functions\.([\w.-]+)"
    r"(?:\s*<\|constrain\|>json)?\s*<\|message\|>(.*?)(?:<\|call\|>|$)", re.S)
_PYTAG_RE = re.compile(r"<\|python_tag\|>(.*?)(?:<\|eom_id\|>|$)", re.S)
# XML-parameter dialects (chat-parser.cpp xml_tool_call_format table):
#   qwen3-coder  <tool_call><function=N><parameter=K>V</parameter>...
#   seed-oss     <seed:tool_call><function=N><parameter=K>V</parameter>...
#   minimax-m2   <minimax:tool_call><invoke name="N"><parameter name="K">V...
_Q3C_BLOCK_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.S)
_SEED_BLOCK_RE = re.compile(r"<seed:tool_call>\s*(.*?)\s*</seed:tool_call>",
                            re.S)
_MMX_BLOCK_RE = re.compile(
    r"<minimax:tool_call>\s*(.*?)\s*</minimax:tool_call>", re.S)
_XMLFN_RE = re.compile(r"<function=([^>\n]+)>\s*(.*?)\s*</function>", re.S)
_XMLPARAM_RE = re.compile(r"<parameter=([^>\n]+)>\s*(.*?)\s*</parameter>",
                          re.S)
_INVOKE_RE = re.compile(r"<invoke name=\"([^\"]+)\">\s*(.*?)\s*</invoke>",
                        re.S)
_NPARAM_RE = re.compile(
    r"<parameter name=\"([^\"]+)\">\s*(.*?)\s*</parameter>", re.S)
# kimi-k2 (chat-parser.cpp:913): <|tool_calls_section_begin|>
#   <|tool_call_begin|>functions.NAME:IDX<|tool_call_argument_begin|>
#   {json}<|tool_call_end|> ... <|tool_calls_section_end|>
_KIMI_CALL_RE = re.compile(
    r"<\|tool_call_begin\|>\s*(?:functions\.)?([\w.-]+?)(?::\d+)?\s*"
    r"<\|tool_call_argument_begin\|>\s*(\{.*?\})\s*<\|tool_call_end\|>",
    re.S)
_KIMI_SECTION_RE = re.compile(
    r"<\|tool_calls_section_begin\|>.*?"
    r"(?:<\|tool_calls_section_end\|>|$)", re.S)
# granite (chat-parser.cpp:1214): <|tool_call|>[{"name":..,"arguments":..}]
_GRANITE_RE = re.compile(r"<\|tool_call\|>\s*(\[.*?\])\s*(?:$|<)", re.S)
# nemotron-v2 (chat-parser.cpp:1261): <TOOLCALL>[json array]</TOOLCALL>
_NEMOTRON_RE = re.compile(r"<TOOLCALL>\s*(\[.*?\])\s*</TOOLCALL>", re.S)
# apriel-1.5 (chat-parser.cpp:932): <tool_calls>[{"name":..}]</tool_calls>
_APRIEL_RE = re.compile(r"<tool_calls>\s*(\[.*?\])\s*</tool_calls>", re.S)
_RESPONSE_RE = re.compile(r"<response>\s*(.*?)\s*</response>", re.S)


def _xml_param_value(raw: str):
    """XML dialect parameter values are raw text; JSON-typed literals
    (numbers, bools, objects) pass through typed, everything else is a
    trimmed string (chat-parser-xml-toolcall.cpp value handling)."""
    v = _parse_json_maybe(raw.strip())
    return v if v is not None else raw.strip()


def _parse_xml_function_calls(blocks, calls):
    for block in blocks:
        for name, body in _XMLFN_RE.findall(block):
            args = {k: _xml_param_value(v)
                    for k, v in _XMLPARAM_RE.findall(body)}
            calls.append(_mk_call(name.strip(), args))


def parse_tool_calls(text: str, fmt: str = "auto"):
    """Extract tool calls from generated text for the given dialect.
    Returns (content, calls) with OAI-shaped tool_call dicts."""
    calls = []
    content = text

    def add_objs(objs):
        for obj in objs:
            if not isinstance(obj, dict):
                continue
            fn = obj.get("function", obj)
            calls.append(_mk_call(
                fn.get("name") or obj.get("tool_name"),
                fn.get("arguments", fn.get("parameters",
                                           obj.get("parameters", {}))),
                call_id=obj.get("id") or obj.get("tool_call_id")))

    if fmt in ("auto", "seed-oss") and "<seed:tool_call>" in text:
        _parse_xml_function_calls(_SEED_BLOCK_RE.findall(text), calls)
        content = _SEED_BLOCK_RE.sub("", text).strip()
    elif fmt in ("auto", "minimax-m2") and "<minimax:tool_call>" in text:
        for block in _MMX_BLOCK_RE.findall(text):
            for name, body in _INVOKE_RE.findall(block):
                args = {k: _xml_param_value(v)
                        for k, v in _NPARAM_RE.findall(body)}
                calls.append(_mk_call(name, args))
        content = _MMX_BLOCK_RE.sub("", text).strip()
    elif fmt in ("auto", "kimi-k2") and "<|tool_call_begin|>" in text:
        for name, blob in _KIMI_CALL_RE.findall(text):
            obj = _parse_json_maybe(blob)
            if obj is not None:
                calls.append(_mk_call(name, obj))
        content = _KIMI_SECTION_RE.sub("", text).strip()
    elif fmt in ("auto", "qwen3-coder") and "<function=" in text \
            and "<parameter=" in text and "<tool_call>" in text:
        _parse_xml_function_calls(_Q3C_BLOCK_RE.findall(text), calls)
        content = _Q3C_BLOCK_RE.sub("", text).strip()
    elif fmt in ("auto", "nemotron-v2") and "<TOOLCALL>" in text:
        for blob in _NEMOTRON_RE.findall(text):
            arr = _parse_json_maybe(blob)
            if isinstance(arr, list):
                add_objs(arr)
        content = _NEMOTRON_RE.sub("", text).strip()
    elif fmt in ("auto", "apriel-1.5") and "<tool_calls>" in text:
        for blob in _APRIEL_RE.findall(text):
            arr = _parse_json_maybe(blob)
            if isinstance(arr, list):
                add_objs(arr)
        content = _APRIEL_RE.sub("", text).strip()
    elif fmt in ("auto", "granite") and "<|tool_call|>" in text:
        for blob in _GRANITE_RE.findall(text):
            arr = _parse_json_maybe(blob)
            if isinstance(arr, list):
                add_objs(arr)
        content = _GRANITE_RE.sub("", text).replace("<|tool_call|>", "")
        m = _RESPONSE_RE.search(content)
        if m:                          # granite wraps prose in <response>
            content = m.group(1)
        content = content.strip()
    elif fmt in ("auto", "hermes", "generic") and _TOOL_CALL_RE.search(text):
        add_objs(filter(None, (_parse_json_maybe(b)
                               for b in _TOOL_CALL_RE.findall(text))))
        content = _TOOL_CALL_RE.sub("", text).strip()
    elif fmt in ("auto", "deepseek") and "<｜tool▁call▁begin｜>" in text:
        for name, blob in _DS_CALL_RE.findall(text):
            obj = _parse_json_maybe(blob)
            if obj is not None:
                calls.append(_mk_call(name.strip(), obj))
        content = _DS_BLOCK_RE.sub("", text).strip()
    elif fmt in ("auto", "mistral") and "[TOOL_CALLS]" in text:
        for blob in _MISTRAL_RE.findall(text):
            arr = _parse_json_maybe(blob)
            if isinstance(arr, list):
                add_objs(arr)
        content = _MISTRAL_RE.sub("", text).replace("[TOOL_CALLS]", "").strip()
    elif fmt in ("auto", "command-r7b") and "<|START_ACTION|>" in text:
        for blob in _ACTION_RE.findall(text):
            arr = _parse_json_maybe(blob)
            if isinstance(arr, list):
                add_objs(arr)
        content = _ACTION_RE.sub("", text).strip()
    elif fmt in ("auto", "functionary-3.1") and "<function=" in text:
        for name, blob in _FUNC31_RE.findall(text):
            obj = _parse_json_maybe(blob.strip())
            calls.append(_mk_call(name, obj if obj is not None
                                  else blob.strip()))
        content = _FUNC31_RE.sub("", text).strip()
    elif fmt in ("auto", "gpt-oss") and "<|channel|>commentary to=" in text:
        for name, blob in _GPTOSS_RE.findall(text):
            obj = _parse_json_maybe(blob.strip())
            calls.append(_mk_call(name, obj if obj is not None
                                  else blob.strip()))
        content = _GPTOSS_RE.sub("", text).strip()
    elif fmt in ("auto", "llama3") and "<|python_tag|>" in text:
        for blob in _PYTAG_RE.findall(text):
            obj = _parse_json_maybe(blob.strip())
            if isinstance(obj, dict) and "name" in obj:
                calls.append(_mk_call(obj["name"],
                                      obj.get("parameters",
                                              obj.get("arguments", {}))))
            else:
                calls.append(_mk_call("python", {"code": blob.strip()}))
        content = _PYTAG_RE.sub("", text).strip()
    else:
        # llama3-style / generic bare JSON object
        stripped = text.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            obj = _parse_json_maybe(stripped)
            if isinstance(obj, dict) and "name" in obj and (
                    "arguments" in obj or "parameters" in obj):
                calls.append(_mk_call(
                    obj["name"],
                    obj.get("arguments", obj.get("parameters", {}))))
                content = ""
    return content, calls


_THINK_RE = re.compile(r"<think>(.*?)</think>", re.S)
_CR_THINK_RE = re.compile(r"<\|START_THINKING\|>(.*?)<\|END_THINKING\|>", re.S)
_SEED_THINK_RE = re.compile(r"<seed:think>(.*?)</seed:think>", re.S)


def extract_reasoning(text: str):
    """Split <think>...</think> (deepseek/qwen3/kimi/minimax), seed-oss
    <seed:think>, or command-r7b <|START_THINKING|> reasoning from
    content. Returns (reasoning or None, content)."""
    for rx, open_tag in ((_SEED_THINK_RE, "<seed:think>"),
                         (_THINK_RE, "<think>"),
                         (_CR_THINK_RE, "<|START_THINKING|>")):
        parts = rx.findall(text)
        if parts:
            content = rx.sub("", text)
            return "\n".join(p.strip() for p in parts), content.lstrip("\n")
        if text.lstrip().startswith(open_tag):
            # unclosed block (generation cut off mid-reasoning)
            return text.lstrip()[len(open_tag):].strip(), ""
    return None, text
