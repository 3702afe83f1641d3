"""Chat templating + model-output parsing.

Covers the reference's two chat layers:
* builtin (non-Jinja) templates + detection heuristics
  (src/llama-chat.cpp: llm_chat_detect_template :73, llm_chat_apply_template :183)
* Jinja rendering of `tokenizer.chat_template` (common/chat.cpp uses vendored
  minja; here the real jinja2), tool-call extraction per model family
  (common/chat-parser.cpp), and reasoning-content extraction — DeepSeek
  `<think>` tags and the fork's Relevance-Realization `<rr>` tags
  (COMMON_REASONING_FORMAT_RR, common/common.h:223).

The port's own copy of llamacog_tpu/runtime/chat.py (it imports no JAX).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# builtin templates (llm_chat_apply_template)
# ---------------------------------------------------------------------------

def _trim(s: str) -> str:
    return s.strip()


def _chatml(chat, add_ass):
    out = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in chat)
    return out + ("<|im_start|>assistant\n" if add_ass else "")


def _phi3(chat, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in chat)
    return out + ("<|assistant|>\n" if add_ass else "")


def _phi4(chat, add_ass):
    out = "".join(
        f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>" for m in chat
    )
    return out + ("<|im_start|>assistant<|im_sep|>" if add_ass else "")


def _falcon3(chat, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in chat)
    return out + ("<|assistant|>\n" if add_ass else "")


def _zephyr(chat, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in chat)
    return out + ("<|assistant|>\n" if add_ass else "")


def _monarch(chat, add_ass):
    parts = []
    for i, m in enumerate(chat):
        bos = "" if i == 0 else "<s>"
        parts.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    return "".join(parts) + ("<s>assistant\n" if add_ass else "")


def _llama2(chat, add_ass, support_system=True, bos_inside=False, strip=False):
    out, inside = "[INST] ", True
    for m in chat:
        content = _trim(m["content"]) if strip else m["content"]
        role = m["role"]
        if not inside:
            inside = True
            out += "<s>[INST] " if bos_inside else "[INST] "
        if role == "system":
            if support_system:
                out += f"<<SYS>>\n{content}\n<</SYS>>\n\n"
            else:
                out += f"{content}\n"
        elif role == "user":
            out += f"{content} [/INST]"
        else:
            out += f"{content}</s>"
            inside = False
    return out


def _mistral_v7(chat, add_ass, tekken=False):
    sp = "" if tekken else " "
    out = ""
    for m in chat:
        role, content = m["role"], m["content"]
        if role == "system":
            out += f"[SYSTEM_PROMPT]{sp}{content}[/SYSTEM_PROMPT]"
        elif role == "user":
            out += f"[INST]{sp}{content}[/INST]"
        else:
            out += f"{sp}{content}</s>"
    return out


def _mistral_v1_v3(chat, add_ass, leading=" ", trailing=" ", trim_asst=False):
    out, inside = "", False
    for m in chat:
        if not inside:
            out += f"{leading}[INST]{trailing}"
            inside = True
        role, content = m["role"], m["content"]
        if role == "system":
            out += f"{content}\n\n"
        elif role == "user":
            out += f"{content}{leading}[/INST]"
        else:
            out += trailing + (_trim(content) if trim_asst else content) + "</s>"
            inside = False
    return out


def _gemma(chat, add_ass):
    out, sys_prompt = "", ""
    for m in chat:
        role = m["role"]
        if role == "system":
            sys_prompt += _trim(m["content"])
            continue
        role = "model" if role == "assistant" else role
        out += f"<start_of_turn>{role}\n"
        if sys_prompt and role != "model":
            out += sys_prompt + "\n\n"
            sys_prompt = ""
        out += _trim(m["content"]) + "<end_of_turn>\n"
    return out + ("<start_of_turn>model\n" if add_ass else "")


def _orion(chat, add_ass):
    out, sys_prompt = "", ""
    for m in chat:
        role = m["role"]
        if role == "system":
            sys_prompt += m["content"]
        elif role == "user":
            out += "Human: "
            if sys_prompt:
                out += sys_prompt + "\n\n"
                sys_prompt = ""
            out += m["content"] + "\n\nAssistant: </s>"
        else:
            out += m["content"] + "</s>"
    return out


def _openchat(chat, add_ass):
    out = ""
    for m in chat:
        if m["role"] == "system":
            out += m["content"] + "<|end_of_turn|>"
        else:
            out += f"GPT4 Correct {m['role'].capitalize()}: {m['content']}<|end_of_turn|>"
    return out + ("GPT4 Correct Assistant:" if add_ass else "")


def _vicuna(chat, add_ass, orca=False):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += f"SYSTEM: {m['content']}\n" if orca else m["content"] + "\n\n"
        elif role == "user":
            out += f"USER: {m['content']}\n"
        else:
            out += f"ASSISTANT: {m['content']}</s>\n"
    return out + ("ASSISTANT:" if add_ass else "")


def _deepseek(chat, add_ass):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += m["content"]
        elif role == "user":
            out += f"### Instruction:\n{m['content']}\n"
        else:
            out += f"### Response:\n{m['content']}\n<|EOT|>\n"
    return out + ("### Response:\n" if add_ass else "")


def _deepseek2(chat, add_ass):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += m["content"] + "\n\n"
        elif role == "user":
            out += f"User: {m['content']}\n\n"
        else:
            out += f"Assistant: {m['content']}<｜end▁of▁sentence｜>"
    return out + ("Assistant:" if add_ass else "")


def _deepseek3(chat, add_ass):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += m["content"] + "\n\n"
        elif role == "user":
            out += f"<｜User｜>{m['content']}"
        else:
            out += f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>"
    return out + ("<｜Assistant｜>" if add_ass else "")


def _command_r(chat, add_ass):
    role_tok = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
                "assistant": "<|CHATBOT_TOKEN|>"}
    out = "".join(
        f"<|START_OF_TURN_TOKEN|>{role_tok.get(m['role'], '<|USER_TOKEN|>')}"
        f"{_trim(m['content'])}<|END_OF_TURN_TOKEN|>"
        for m in chat
    )
    return out + ("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>" if add_ass else "")


def _llama3(chat, add_ass):
    out = "".join(
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{_trim(m['content'])}<|eot_id|>"
        for m in chat
    )
    return out + ("<|start_header_id|>assistant<|end_header_id|>\n\n" if add_ass else "")


def _chatglm4(chat, add_ass):
    out = "[gMASK]<sop>" + "".join(f"<|{m['role']}|>\n{m['content']}" for m in chat)
    return out + ("<|assistant|>\n" if add_ass else "")


def _exaone3(chat, add_ass):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += f"[|system|]{_trim(m['content'])}[|endofturn|]\n"
        elif role == "user":
            out += f"[|user|]{_trim(m['content'])}\n"
        else:
            out += f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n"
    return out + ("[|assistant|]" if add_ass else "")


def _granite(chat, add_ass):
    out = "".join(
        f"<|start_of_role|>{m['role']}<|end_of_role|>{_trim(m['content'])}<|end_of_text|>\n"
        for m in chat
    )
    return out + ("<|start_of_role|>assistant<|end_of_role|>\n" if add_ass else "")


def _rwkv_world(chat, add_ass):
    out = ""
    for m in chat:
        role = m["role"]
        if role == "system":
            out += f"System: {_trim(m['content'])}\n\n"
        elif role == "user":
            out += f"User: {_trim(m['content'])}\n\n"
        else:
            out += f"Assistant: {_trim(m['content'])}\n\n"
    return out + ("Assistant:" if add_ass else "")


def _chatglm3(chat, add_ass):
    out = "[gMASK]sop" + "".join(f"<|{m['role']}|>\n {m['content']}" for m in chat)
    return out + ("<|assistant|>" if add_ass else "")


def _glmedge(chat, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}" for m in chat)
    return out + ("<|assistant|>" if add_ass else "")


def _minicpm(chat, add_ass):
    out = ""
    for m in chat:
        if m["role"] == "user":
            out += "<\u7528\u6237>" + _trim(m["content"]) + "<AI>"
        else:
            out += _trim(m["content"])
    return out


def _gigachat(chat, add_ass):
    out = "<s>"
    rest = chat
    if chat and chat[0]["role"] == "system":
        out += chat[0]["content"] + "<|message_sep|>"
        rest = chat[1:]
    for m in rest:
        if m["role"] == "user":
            out += ("user<|role_sep|>" + m["content"] + "<|message_sep|>"
                    + "available functions<|role_sep|>[]<|message_sep|>")
        elif m["role"] == "assistant":
            out += "assistant<|role_sep|>" + m["content"] + "<|message_sep|>"
    return out + ("assistant<|role_sep|>" if add_ass else "")


def _megrez(chat, add_ass):
    out = "".join(
        f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>"
        for m in chat
    )
    return out + ("<|role_start|>assistant<|role_end|>" if add_ass else "")


def _yandex(chat, add_ass):
    out = "<s>"
    for m in chat:
        if m["role"] == "user":
            out += " \u041f\u043e\u043b\u044c\u0437\u043e\u0432\u0430\u0442\u0435\u043b\u044c: " + m["content"] + "\n\n"
        elif m["role"] == "assistant":
            out += " \u0410\u0441\u0441\u0438\u0441\u0442\u0435\u043d\u0442: " + m["content"] + "\n\n"
    return out + (" \u0410\u0441\u0441\u0438\u0441\u0442\u0435\u043d\u0442:[SEP]" if add_ass else "")


def _bailing(chat, add_ass):
    out = ""
    for m in chat:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out += f"<role>{role}</role>{m['content']}"
    return out + ("<role>ASSISTANT</role>" if add_ass else "")


def _llama4(chat, add_ass):
    out = "".join(
        f"<|header_start|>{m['role']}<|header_end|>\n\n{_trim(m['content'])}<|eot|>"
        for m in chat
    )
    return out + ("<|header_start|>assistant<|header_end|>\n\n" if add_ass else "")


def _smolvlm(chat, add_ass):
    out = "<|im_start|>"
    for m in chat:
        if m["role"] == "system":
            out += m["content"] + "\n\n"
        elif m["role"] == "user":
            out += "User: " + m["content"] + "<end_of_utterance>\n"
        else:
            out += "Assistant: " + m["content"] + "<end_of_utterance>\n"
    return out + ("Assistant:" if add_ass else "")


BUILTIN_TEMPLATES = {
    "chatml": _chatml,
    "llama2": lambda c, a: _llama2(c, a, support_system=False),
    "llama2-sys": lambda c, a: _llama2(c, a),
    "llama2-sys-bos": lambda c, a: _llama2(c, a, bos_inside=True),
    "llama2-sys-strip": lambda c, a: _llama2(c, a, strip=True),
    "mistral-v1": lambda c, a: _mistral_v1_v3(c, a, leading=" ", trailing=" "),
    "mistral-v3": lambda c, a: _mistral_v1_v3(c, a, leading="", trailing=" ", trim_asst=True),
    "mistral-v3-tekken": lambda c, a: _mistral_v1_v3(c, a, leading="", trailing=""),
    "mistral-v7": lambda c, a: _mistral_v7(c, a),
    "mistral-v7-tekken": lambda c, a: _mistral_v7(c, a, tekken=True),
    "phi3": _phi3,
    "phi4": _phi4,
    "falcon3": _falcon3,
    "zephyr": _zephyr,
    "monarch": _monarch,
    "gemma": _gemma,
    "orion": _orion,
    "openchat": _openchat,
    "vicuna": _vicuna,
    "vicuna-orca": lambda c, a: _vicuna(c, a, orca=True),
    "deepseek": _deepseek,
    "deepseek2": _deepseek2,
    "deepseek3": _deepseek3,
    "command-r": _command_r,
    "llama3": _llama3,
    "chatglm4": _chatglm4,
    "chatglm3": _chatglm3,
    "glmedge": _glmedge,
    "minicpm": _minicpm,
    "gigachat": _gigachat,
    "megrez": _megrez,
    "yandex": _yandex,
    "bailing": _bailing,
    "llama4": _llama4,
    "smolvlm": _smolvlm,
    "exaone3": _exaone3,
    "granite": _granite,
    "rwkv-world": _rwkv_world,
}


def detect_template(tmpl: str) -> str | None:
    """Map a Jinja template source (or a known name) to a builtin template
    name — the llm_chat_detect_template heuristics (src/llama-chat.cpp:73)."""
    if tmpl in BUILTIN_TEMPLATES:
        return tmpl
    has = lambda s: s in tmpl  # noqa: E731
    if has("<|im_start|>"):
        return "phi4" if has("<|im_sep|>") else "chatml"
    if tmpl.startswith("mistral") or has("[INST]"):
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if has("' [INST] ' + system_message") or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        if has("<<SYS>>"):
            return "llama2-sys"
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<|assistant|>") and has("<|user|>"):
        return "falcon3" if has("</s>") else None
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone3"
    if has("rwkv-world"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    # llm_chat_detect_template additions (src/llama-chat.cpp:160-190)
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("<\u7528\u6237>"):  # MiniCPM <用户>
        return "minicpm"
    if has("message['role'] + additional_special_tokens[0]") or (
        has("<|role_sep|>") and has("<|message_sep|>")
    ):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    if has("\u0410\u0441\u0441\u0438\u0441\u0442\u0435\u043d\u0442:[SEP]") or has(" \u041f\u043e\u043b\u044c\u0437\u043e\u0432\u0430\u0442\u0435\u043b\u044c:"):
        return "yandex"
    if has("<role>ASSISTANT</role>") or has("<role>HUMAN</role>"):
        return "bailing"
    if has("<|header_start|>") and has("<|header_end|>"):
        return "llama4"
    if has("<end_of_utterance>"):
        return "smolvlm"
    return None


def apply_builtin_template(name: str, messages: list[dict], add_assistant=True) -> str:
    fn = BUILTIN_TEMPLATES.get(name)
    if fn is None:
        raise ValueError(f"unknown builtin chat template: {name}")
    return fn(messages, add_assistant)


def render_template(
    template: str | None,
    messages: list[dict],
    add_generation_prompt: bool = True,
    tools: list | None = None,
    bos_token: str = "",
    eos_token: str = "",
    extra_context: dict | None = None,
) -> str:
    """Render with jinja2 (role of the vendored minja, common/chat.cpp:124);
    fall back to the detected builtin, then chatml."""
    if template:
        try:
            import jinja2

            env = jinja2.Environment(
                loader=jinja2.BaseLoader(), keep_trailing_newline=True,
                extensions=["jinja2.ext.loopcontrols"],
            )
            env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
                ValueError(msg)
            )
            env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
            ctx = dict(
                messages=messages,
                add_generation_prompt=add_generation_prompt,
                tools=tools,
                bos_token=bos_token,
                eos_token=eos_token,
            )
            ctx.update(extra_context or {})
            return env.from_string(template).render(**ctx)
        except Exception:
            builtin = detect_template(template)
            if builtin:
                return apply_builtin_template(builtin, messages, add_generation_prompt)
    return _chatml(messages, add_generation_prompt)


# ---------------------------------------------------------------------------
# output parsing: reasoning + tool calls (common/chat-parser.cpp)
# ---------------------------------------------------------------------------

REASONING_TAGS = {
    "deepseek": ("<think>", "</think>"),
    "deepseek-legacy": ("<think>", "</think>"),
    "rr": ("<rr>", "</rr>"),  # fork's Relevance Realization triadic format
}


@dataclass
class ChatMsg:
    content: str = ""
    reasoning_content: str = ""
    tool_calls: list[dict] = field(default_factory=list)


def parse_reasoning(
    text: str,
    fmt: str = "none",
    reasoning_in_content: bool = False,
    thinking_forced_open: bool = False,
) -> tuple[str, str]:
    """Extract (content, reasoning) per common_chat_msg_parser::try_parse_reasoning
    (common/chat-parser.cpp:130-177). Unclosed tags consume the rest."""
    if fmt in ("none", None):
        return text, ""
    start, end = REASONING_TAGS.get(fmt, ("<think>", "</think>"))
    s = text.lstrip()
    reasoning = ""
    rest = text
    if thinking_forced_open or s.startswith(start):
        body = s[len(start):] if s.startswith(start) else s
        idx = body.find(end)
        if idx >= 0:
            reasoning = body[:idx].strip()
            rest = body[idx + len(end):].lstrip()
        else:
            reasoning = body.strip()
            rest = ""
    if reasoning and reasoning_in_content:
        closed = end in s
        return (start + reasoning + (end if closed else "")) + rest, ""
    return rest, reasoning


_HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.DOTALL)


def parse_tool_calls(text: str, fmt: str = "auto") -> ChatMsg:
    """Extract tool calls from model output. Formats follow the reference's
    per-family parsers (common/chat.cpp): hermes `<tool_call>` JSON, mistral
    `[TOOL_CALLS]` array, llama3/generic bare JSON object with name+arguments."""
    msg = ChatMsg()
    calls = []
    rest = text
    for m in _HERMES_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
            calls.append(
                {"name": obj.get("name", ""),
                 "arguments": json.dumps(obj.get("arguments", {}))}
            )
        except json.JSONDecodeError:
            continue
    if calls:
        rest = _HERMES_RE.sub("", text).strip()
    elif m := _MISTRAL_RE.search(text):
        try:
            for obj in json.loads(m.group(1)):
                calls.append(
                    {"name": obj.get("name", ""),
                     "arguments": json.dumps(obj.get("arguments", {}))}
                )
            rest = text[: m.start()].strip()
        except json.JSONDecodeError:
            pass
    else:
        stripped = text.strip()
        if stripped.startswith("{") and fmt in ("auto", "generic", "llama3"):
            try:
                obj = json.loads(stripped)
                name = obj.get("name")
                args = obj.get("arguments", obj.get("parameters"))
                if name and args is not None:
                    calls.append({"name": name, "arguments": json.dumps(args)})
                    rest = ""
            except json.JSONDecodeError:
                pass
    msg.content = rest
    msg.tool_calls = calls
    return msg
