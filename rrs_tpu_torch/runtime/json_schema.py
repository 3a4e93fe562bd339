"""JSON schema -> GBNF grammar (json-schema-to-grammar.cpp analog, core subset).

Supports: type object/array/string/number/integer/boolean/null, properties +
required, items, enum, const, additionalProperties=false semantics
(properties emitted in declaration order, like the reference's ordered dict).

A copy of ``rrs_tpu/runtime/json_schema.py``, word for word below this
paragraph.
"""

from __future__ import annotations

import json


_PRIMITIVES = {
    "string": r'"\"" [^"\\]* "\"" ws',
    "number": r'"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? ws',
    "integer": r'"-"? ([0-9] | [1-9] [0-9]*) ws',
    "boolean": r'("true" | "false") ws',
    "null": r'"null" ws',
}


class _Converter:
    def __init__(self):
        self.rules: dict[str, str] = {"ws": "[ \\t\\n]*"}
        self.n = 0

    def _add(self, name: str, body: str) -> str:
        if name in self.rules and self.rules[name] != body:
            name = f"{name}{self.n}"
            self.n += 1
        self.rules[name] = body
        return name

    def _lit(self, value) -> str:
        s = json.dumps(value)
        escaped = s.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}" ws'

    def visit(self, schema: dict, name: str) -> str:
        if not isinstance(schema, dict) or not schema:
            self._ensure_value()
            return self._add(name, "value")
        if "const" in schema:
            return self._add(name, self._lit(schema["const"]))
        if "enum" in schema:
            body = " | ".join(self._lit(v) for v in schema["enum"])
            return self._add(name, body)
        t = schema.get("type")
        if isinstance(t, list):
            parts = [self.visit({**schema, "type": tt}, f"{name}-{tt}") for tt in t]
            return self._add(name, " | ".join(parts))
        if t == "object" and "properties" in schema:
            required = set(schema.get("required", []))
            parts = []
            props = list(schema["properties"].items())
            rule_names = [
                (k, self.visit(v, f"{name}-{_slug(k)}")) for k, v in props
            ]
            # emit properties in order; optional ones wrapped in ?
            seq = ['"{" ws']
            first = True
            for k, rn in rule_names:
                key = json.dumps(k).replace("\\", "\\\\").replace('"', '\\"')
                piece = f'"{key}" ":" ws {rn}'
                if first:
                    item = piece if k in required else f"( {piece} )?"
                    first = False
                else:
                    item = f'"," ws {piece}' if k in required else f'( "," ws {piece} )?'
                seq.append(item)
            seq.append('"}" ws')
            return self._add(name, " ".join(seq))
        if t == "object":
            self._ensure_value()
            return self._add(name, "object")
        if t == "array":
            item = self.visit(schema.get("items", {}), f"{name}-item")
            body = f'"[" ws ( {item} ( "," ws {item} )* )? "]" ws'
            return self._add(name, body)
        if t in _PRIMITIVES:
            return self._add(name, _PRIMITIVES[t])
        self._ensure_value()
        return self._add(name, "value")

    def _ensure_value(self):
        if "value" not in self.rules:
            self.rules["value"] = "object | array | string | number | boolean-r | null-r"
            self.rules["object"] = (
                '"{" ws ( string ":" ws value ( "," ws string ":" ws value )* )? "}" ws'
            )
            self.rules["array"] = '"[" ws ( value ( "," ws value )* )? "]" ws'
            self.rules["string"] = _PRIMITIVES["string"]
            self.rules["number"] = _PRIMITIVES["number"]
            self.rules["boolean-r"] = _PRIMITIVES["boolean"]
            self.rules["null-r"] = _PRIMITIVES["null"]


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() else "-" for c in s)


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    c = _Converter()
    root_body = c.visit(schema, "root0")
    lines = [f"root ::= {root_body}"]
    for name, body in c.rules.items():
        lines.append(f"{name} ::= {body}")
    return "\n".join(lines)
