"""Model-family chat templates for the chat completion endpoint.

The port's copy of ``operator_tpu/serving/templates.py``.

Real instruct checkpoints are trained against a specific conversation
format; feeding them the neutral ``role: content`` fallback degrades
their output badly.  The formats below are the published conventions for
each family served from models/configs.py (no network egress is needed —
they are fixed strings, reproduced from the models' public cards):

- **llama3**: ``<|start_header_id|>role<|end_header_id|>\\n\\ncontent<|eot_id|>``
- **chatml** (Qwen2/2.5): ``<|im_start|>role\\ncontent<|im_end|>``
- **mistral**: ``[INST] ... [/INST]`` with system folded into the first
  user turn (Mistral has no system role)
- **zephyr** (TinyLlama-Chat): ``<|system|>/<|user|>/<|assistant|>`` tags
- **plain**: the neutral fallback for unknown models / base checkpoints

Templates never emit a BOS string (``<|begin_of_text|>`` / ``<s>``): the
engine's tokenizer prepends ``bos_id`` at admission (all tokenizer
classes default ``add_bos=True``) — baking it into the text
would double it.

Selection is by model config name prefix (:func:`template_for`); the
serving CLI and operator pass the loaded model's name through.  The
templates emit TEXT — tokenization happens downstream, so they work with
any tokenizer that covers the special strings (a real checkpoint's
tokenizer does; the byte/BPE fallbacks encode them literally, which is
exactly as good as the neutral format was).
"""

from __future__ import annotations

from typing import Callable, Sequence

Message = dict  # {"role": str, "content": str} (content pre-flattened)


def _plain(messages: Sequence[Message]) -> str:
    parts = [f"{m.get('role', 'user')}: {m['content']}" for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)


def _llama3(messages: Sequence[Message]) -> str:
    parts = []  # BOS comes from the tokenizer, not the template
    for m in messages:
        parts.append(
            f"<|start_header_id|>{m.get('role', 'user')}<|end_header_id|>\n\n"
            f"{m['content']}<|eot_id|>"
        )
    parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


def _chatml(messages: Sequence[Message]) -> str:
    parts = [
        f"<|im_start|>{m.get('role', 'user')}\n{m['content']}<|im_end|>\n"
        for m in messages
    ]
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def _mistral(messages: Sequence[Message]) -> str:
    # no system role: fold system text into the first user turn (the
    # published convention); alternating [INST] user [/INST] assistant</s>
    system = "\n".join(
        m["content"] for m in messages if m.get("role") == "system"
    )
    parts = []  # BOS comes from the tokenizer, not the template
    pending_system = system
    for m in messages:
        role = m.get("role", "user")
        if role == "system":
            continue
        if role == "assistant":
            parts.append(f" {m['content']}</s>")
        else:
            content = m["content"]
            if pending_system:
                content = f"{pending_system}\n\n{content}"
                pending_system = ""
            parts.append(f"[INST] {content} [/INST]")
    if pending_system:  # system-only conversation: never drop the content
        parts.append(f"[INST] {pending_system} [/INST]")
    return "".join(parts)


def _zephyr(messages: Sequence[Message]) -> str:
    parts = [
        f"<|{m.get('role', 'user')}|>\n{m['content']}</s>\n" for m in messages
    ]
    parts.append("<|assistant|>\n")
    return "".join(parts)


#: model-name prefix -> formatter (first match wins, checked in order)
_TEMPLATES: list[tuple[str, Callable[[Sequence[Message]], str]]] = [
    ("llama-3", _llama3),
    ("qwen", _chatml),
    ("mistral", _mistral),
    ("tinyllama", _zephyr),
]


def template_for(model_name: str) -> Callable[[Sequence[Message]], str]:
    """The chat formatter for a model config name (prefix match; the
    neutral plain format for anything unknown, incl. tiny-test)."""
    lowered = (model_name or "").lower()
    for prefix, formatter in _TEMPLATES:
        if lowered.startswith(prefix):
            return formatter
    return _plain


__all__ = ["template_for"]
