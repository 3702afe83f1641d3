"""JSON schema → GBNF grammar conversion (role of reference
common/json-schema-to-grammar.cpp): constrain generation to JSON documents
matching a (subset of a) JSON schema.

Supported: type (object/array/string/number/integer/boolean/null), enum,
const, properties/required/additionalProperties, items/prefixItems,
minItems/maxItems, anyOf/oneOf/allOf (shallow), $ref (local #/definitions &
#/$defs), string minLength/maxLength, simple formats.

The port's own copy of llamacog_tpu/runtime/json_schema.py (it imports no JAX).
"""

from __future__ import annotations

import json
import re

_SPACE = 'space ::= " "?\n'

_PRIMITIVES = {
    "boolean": 'boolean ::= ("true" | "false") space',
    "null": 'null ::= "null" space',
    "string": r'''string ::= "\"" char* "\"" space''',
    "char": r'''char ::= [^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4})''',
    "number": r'''number ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9] [1-9]{0,15})? space''',
    "integer": r'''integer ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) space''',
    "value": 'value ::= object | array | string | number | boolean | null',
    "object": r'''object ::= "{" space ( string ":" space value ("," space string ":" space value)* )? "}" space''',
    "array": r'''array ::= "[" space ( value ("," space value)* )? "]" space''',
}


def _format_literal(val) -> str:
    s = json.dumps(val)
    out = []
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


class SchemaConverter:
    def __init__(self):
        self.rules: dict[str, str] = {"space": '" "?'}
        self._counter = 0

    def _add_rule(self, name: str, body: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", name).strip("-") or "rule"
        key = base
        while key in self.rules and self.rules[key] != body:
            self._counter += 1
            key = f"{base}{self._counter}"
        self.rules[key] = body
        return key

    def _need_primitive(self, name: str) -> str:
        if name in self.rules:
            return name
        defn = _PRIMITIVES[name]
        body = defn.split("::=", 1)[1].strip()
        self.rules[name] = body
        if name == "string":
            self._need_primitive("char")
        if name == "value":
            for dep in ("object", "array", "string", "number", "boolean", "null"):
                self._need_primitive(dep)
        if name in ("object", "array"):
            self.rules.setdefault("value", _PRIMITIVES["value"].split("::=", 1)[1].strip())
            for dep in ("string", "number", "boolean", "null"):
                self._need_primitive(dep)
            if name == "object":
                self._need_primitive("array")
            else:
                self._need_primitive("object")
        return name

    def visit(self, schema: dict, name: str, root: dict | None = None) -> str:
        root = root if root is not None else schema
        if not isinstance(schema, dict):
            schema = {}
        if "$ref" in schema:
            ref = schema["$ref"]
            for prefix in ("#/definitions/", "#/$defs/"):
                if ref.startswith(prefix):
                    key = ref[len(prefix):]
                    defs = root.get(prefix.split("/")[1], {})
                    return self.visit(defs.get(key, {}), key, root)
            return self._need_primitive("value")
        if "const" in schema:
            return self._add_rule(name, _format_literal(schema["const"]) + " space")
        if "enum" in schema:
            body = " | ".join(_format_literal(v) for v in schema["enum"]) + " space"
            return self._add_rule(name, body)
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                alts = [
                    self.visit(sub, f"{name}-{i}", root) for i, sub in enumerate(schema[comb])
                ]
                return self._add_rule(name, " | ".join(alts))
        if "allOf" in schema:
            merged: dict = {}
            for sub in schema["allOf"]:
                if "$ref" in sub:
                    ref = sub["$ref"]
                    for prefix in ("#/definitions/", "#/$defs/"):
                        if ref.startswith(prefix):
                            sub = root.get(prefix.split("/")[1], {}).get(ref[len(prefix):], {})
                for k, v in sub.items():
                    if k == "properties":
                        merged.setdefault("properties", {}).update(v)
                    elif k == "required":
                        merged.setdefault("required", []).extend(v)
                    else:
                        merged[k] = v
            return self.visit(merged, name, root)

        stype = schema.get("type")
        if isinstance(stype, list):
            alts = [self.visit({**schema, "type": t}, f"{name}-{t}", root) for t in stype]
            return self._add_rule(name, " | ".join(alts))

        if stype == "object" and ("properties" in schema or "additionalProperties" in schema):
            props = schema.get("properties", {})
            required = set(schema.get("required", []))
            parts: list[str] = []
            prop_rules = {}
            for pname, psch in props.items():
                prop_rules[pname] = self.visit(psch, f"{name}-{pname}", root)
            seq = '"{" space'
            # required properties in order; optional ones wrapped
            first = True
            for pname in props:
                frag = f'{_format_literal(pname)} ":" space {prop_rules[pname]}'
                sep = "" if first else '"," space '
                if pname in required:
                    seq += f' {sep}{frag}'
                    first = False
                else:
                    seq += f' ({sep}{frag})?'
                    # NB: approximation — comma placement for purely-optional
                    # mixes is handled loosely
                    first = False
            seq += ' "}" space'
            return self._add_rule(name, seq)
        if stype == "array":
            items = schema.get("items", {})
            if isinstance(items, list):
                alts = [self.visit(s, f"{name}-item{i}", root) for i, s in enumerate(items)]
                inner = ' "," space '.join(alts)
                return self._add_rule(name, f'"[" space {inner} "]" space')
            item = self.visit(items, f"{name}-item", root)
            mn = schema.get("minItems", 0)
            mx = schema.get("maxItems", -1)
            if mn == 0 and mx == -1:
                body = f'"[" space ({item} ("," space {item})*)? "]" space'
            else:
                rep = f'("," space {item}){{{max(mn - 1, 0)},{mx - 1 if mx > 0 else ""}}}'
                core = f"{item} {rep}"
                body = f'"[" space ({core})' + ("?" if mn == 0 else "") + ' "]" space'
            return self._add_rule(name, body)
        if stype == "string":
            if "pattern" not in schema and (
                "minLength" in schema or "maxLength" in schema
            ):
                self._need_primitive("char")
                mn = schema.get("minLength", 0)
                mx = schema.get("maxLength", -1)
                rng = f"{{{mn},{mx if mx >= 0 else ''}}}"
                return self._add_rule(name, f'"\\"" char{rng} "\\"" space')
            return self._need_primitive("string")
        if stype in ("number", "integer", "boolean", "null"):
            return self._need_primitive(stype)
        return self._need_primitive("value")

    def grammar(self, root_rule: str) -> str:
        out = []
        if root_rule != "root":
            out.append(f"root ::= {root_rule}")
        for k, v in self.rules.items():
            out.append(f"{k} ::= {v}")
        return "\n".join(out) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = SchemaConverter()
    root = conv.visit(schema, "root")
    return conv.grammar(root)
