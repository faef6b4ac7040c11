"""Post-processors: the specials ``encode(..., add_special_tokens=True)``
puts around one sequence's ids (the pair forms are not used here)."""

from __future__ import annotations

from typing import Callable, Optional

from . import unsupported

__all__ = ["build_post_processor", "template"]

PostProcessor = Callable[["list[int]"], "list[int]"]


def template(single: list, special_tokens: dict) -> PostProcessor:
    """``TemplateProcessing``'s ``single`` template: the specials' ids
    (each may stand for several) around sequence ``A``'s."""
    parts: list = []
    for piece in single:
        if "SpecialToken" in piece:
            name = piece["SpecialToken"]["id"]
            if name not in special_tokens:
                raise ValueError(f"TemplateProcessing: special token {name!r} has no ids")
            parts.append(list(special_tokens[name]["ids"]))
        elif "Sequence" in piece:
            if piece["Sequence"]["id"] != "A":
                raise ValueError("TemplateProcessing: a single template names sequence B")
            parts.append(None)
        else:
            raise ValueError(f"TemplateProcessing: bad piece {piece!r}")

    def run(ids):
        out: list[int] = []
        for part in parts:
            out.extend(ids if part is None else part)
        return out

    return run


def build_post_processor(spec: Optional[dict]) -> PostProcessor:
    if spec is None:
        return lambda ids: list(ids)
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_post_processor(s) for s in spec["processors"]]

        def run(ids):
            for step in steps:
                ids = step(ids)
            return ids

        return run
    if kind in ("BertProcessing", "RobertaProcessing"):
        # [token, id] pairs
        cls_id, sep_id = int(spec["cls"][1]), int(spec["sep"][1])
        return lambda ids: [cls_id, *ids, sep_id]
    if kind == "ByteLevel":  # offsets only
        return lambda ids: list(ids)
    if kind == "TemplateProcessing":
        return template(spec["single"], spec.get("special_tokens") or {})
    raise unsupported(f"post_processor {kind!r}")
