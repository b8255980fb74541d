"""Chat template application.

The analogue of llama_chat_apply_template (reference src/llama.cpp:21668):
prefer the GGUF's embedded `tokenizer.chat_template` (rendered with jinja2),
fall back to a detected builtin (chatml / llama2 / llama3), default chatml.
"""

from __future__ import annotations

from typing import Any


def _render_jinja(template: str, messages: list[dict], add_generation_prompt: bool,
                  bos: str = "", eos: str = "") -> str:
    import jinja2

    env = jinja2.Environment(loader=jinja2.BaseLoader(), keep_trailing_newline=True)

    def raise_exception(msg):
        raise jinja2.TemplateError(msg)

    tmpl = env.from_string(template)
    return tmpl.render(
        messages=messages,
        add_generation_prompt=add_generation_prompt,
        bos_token=bos,
        eos_token=eos,
        raise_exception=raise_exception,
    )


def _chatml(messages: list[dict], add_generation_prompt: bool) -> str:
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _llama3(messages: list[dict], add_generation_prompt: bool) -> str:
    out = []
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>")
    if add_generation_prompt:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _llama2(messages: list[dict], add_generation_prompt: bool, *,
            support_system: bool = True, space_around: bool = True,
            bos_inside: bool = False, strip: bool = False) -> str:
    """The llama2 family with its four template-content variants
    (llama_chat_apply_template_internal, src/llama.cpp:24105-24139):
    <<SYS>> support, space around the response, BOS inside history, and
    content stripping. llama2 templates ignore add_generation_prompt."""
    out = ["[INST] "]
    inside = True
    for m in messages:
        content = m["content"].strip() if strip else m["content"]
        if not inside:
            inside = True
            out.append("<s>[INST] " if bos_inside else "[INST] ")
        if m["role"] == "system":
            out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n" if support_system
                       else content + "\n")
        elif m["role"] == "user":
            out.append(content + " [/INST]")
        else:
            sp = " " if space_around else ""
            out.append(sp + content + sp + "</s>")
            inside = False
    return "".join(out)


def _llama2_from_tmpl(template: str):
    """Bind the llama2 variant flags from the template text (the
    tmpl_contains checks @24108-24114)."""
    return lambda m, a: _llama2(
        m, a,
        support_system="<<SYS>>" in template,
        space_around="' ' + eos_token" in template,
        bos_inside="bos_token + '[INST]" in template,
        strip="content.strip()" in template,
    )


def _phi3(messages, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _zephyr(messages, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in messages]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _monarch(messages, add_ass):
    out = []
    for i, m in enumerate(messages):
        bos = "" if i == 0 else "<s>"
        out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    if add_ass:
        out.append("<s>assistant\n")
    return "".join(out)


def _gemma(messages, add_ass):
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m["content"].strip()
            continue
        role = "model" if m["role"] == "assistant" else m["role"]
        out.append(f"<start_of_turn>{role}\n")
        if system and role != "model":
            out.append(system + "\n\n")
            system = ""
        out.append(m["content"].strip() + "<end_of_turn>\n")
    if add_ass:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _orion(messages, add_ass):
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m["content"]
        elif m["role"] == "user":
            out.append("Human: ")
            if system:
                out.append(system + "\n\n")
                system = ""
            out.append(m["content"] + "\n\nAssistant: </s>")
        else:
            out.append(m["content"] + "</s>")
    return "".join(out)


def _openchat(messages, add_ass):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"] + "<|end_of_turn|>")
        else:
            out.append(f"GPT4 Correct {m['role'].capitalize()}: {m['content']}<|end_of_turn|>")
    if add_ass:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _vicuna(messages, add_ass, orca=False):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"SYSTEM: {m['content']}\n" if orca else m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"USER: {m['content']}\n")
        elif m["role"] == "assistant":
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if add_ass:
        out.append("ASSISTANT:")
    return "".join(out)


def _deepseek(messages, add_ass):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"])
        elif m["role"] == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        else:
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if add_ass:
        out.append("### Response:\n")
    return "".join(out)


def _deepseek2(messages, add_ass):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}\n\n")
        else:
            out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _command_r(messages, add_ass):
    role_tok = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
                "assistant": "<|CHATBOT_TOKEN|>"}
    out = [f"<|START_OF_TURN_TOKEN|>{role_tok[m['role']]}"
           f"{m['content'].strip()}<|END_OF_TURN_TOKEN|>" for m in messages]
    if add_ass:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _chatglm3(messages, add_ass):
    # chatglm3-6b (src/llama.cpp:24281): note the space after the newline
    out = ["[gMASK]sop"]
    for m in messages:
        out.append(f"<|{m['role']}|>\n {m['content']}")
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _chatglm4(messages, add_ass):
    out = ["[gMASK]<sop>"]
    out += [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _minicpm(messages, add_ass):
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append("<用户>" + m["content"].strip() + "<AI>")
        else:
            out.append(m["content"].strip())
    return "".join(out)


def _exaone3(messages, add_ass):
    out = []
    for m in messages:
        c = m["content"].strip()
        if m["role"] == "system":
            out.append(f"[|system|]{c}[|endofturn|]\n")
        elif m["role"] == "user":
            out.append(f"[|user|]{c}\n")
        else:
            out.append(f"[|assistant|]{c}[|endofturn|]\n")
    if add_ass:
        out.append("[|assistant|]")
    return "".join(out)


_BUILTINS = {
    "chatml": _chatml,
    # named "llama2" has no <<SYS>> marker to detect; named "mistral"
    # forces system-message support (@24108)
    "llama2": lambda m, a: _llama2(m, a, support_system=False,
                                   space_around=False),
    "mistral": lambda m, a: _llama2(m, a, support_system=True,
                                    space_around=False),
    "llama3": _llama3, "phi3": _phi3, "zephyr": _zephyr, "monarch": _monarch,
    "gemma": _gemma, "gemma2": _gemma, "orion": _orion,
    "openchat": _openchat, "vicuna": _vicuna,
    "vicuna-orca": lambda m, a: _vicuna(m, a, orca=True),
    "deepseek": _deepseek, "deepseek2": _deepseek2, "command-r": _command_r,
    "chatglm3": _chatglm3, "chatglm4": _chatglm4, "minicpm": _minicpm,
    "exaone3": _exaone3,
}

# jinja-template-content markers -> builtin name (llama_chat_apply_template_
# internal's tmpl_contains detection, src/llama.cpp:21668) — used as the
# fallback when jinja2 is unavailable or rendering fails
_TEMPLATE_MARKERS = [
    ("<|im_start|>", "chatml"),
    ("[INST]", "llama2"),
    ("<|start_header_id|>", "llama3"),
    ("<|end|>", "phi3"),
    ("<|user|>", "zephyr"),
    ("bos_token + message['role']", "monarch"),
    ("<start_of_turn>", "gemma"),
    ("'\\n\\nAssistant: ' + eos_token", "orion"),
    ("GPT4 Correct ", "openchat"),
    ("USER: ", "vicuna"),
    ("### Instruction:", "deepseek"),
    ("<|START_OF_TURN_TOKEN|>", "command-r"),
    ("[gMASK]<sop>", "chatglm4"),
    ("[gMASK]sop", "chatglm3"),
    ("<用户>", "minicpm"),
    ("'Assistant: ' + message['content'] + eos_token", "deepseek2"),
    ("[|assistant|]", "exaone3"),
]


def detect_from_template(template: str) -> str | None:
    for marker, name in _TEMPLATE_MARKERS:
        if marker in template:
            return name
    return None


def detect_builtin(vocab) -> str:
    toks = vocab.token_to_id
    if "<|start_header_id|>" in toks:
        return "llama3"
    if "<|im_start|>" in toks:
        return "chatml"
    if "<start_of_turn>" in toks:
        return "gemma"
    if "<|START_OF_TURN_TOKEN|>" in toks:
        return "command-r"
    if "[INST]" in toks or vocab.model == "llama":
        return "llama2"
    return "chatml"


def apply_chat_template(
    messages: list[dict[str, Any]],
    template: str | None = None,
    vocab=None,
    add_generation_prompt: bool = True,
) -> str:
    msgs = [{"role": m["role"], "content": m["content"]} for m in messages]
    if template and template not in _BUILTINS:
        bos = vocab.tokens[vocab.bos_id] if vocab and vocab.bos_id >= 0 else ""
        eos = vocab.tokens[vocab.eos_id] if vocab and vocab.eos_id >= 0 else ""
        try:
            return _render_jinja(template, msgs, add_generation_prompt, bos, eos)
        except Exception:
            # no jinja2 / render failure: detect a builtin from the template
            # text, like llama_chat_apply_template_internal does
            detected = detect_from_template(template)
            if detected == "llama2":
                return _llama2_from_tmpl(template)(msgs, add_generation_prompt)
            if detected:
                return _BUILTINS[detected](msgs, add_generation_prompt)
    name = template if template in _BUILTINS else (detect_builtin(vocab) if vocab else "chatml")
    return _BUILTINS[name](msgs, add_generation_prompt)
