"""Temperature + truncated-nucleus sampling; ``temp <= 0`` is greedy.

Port of ``operator_tpu/serving/programs.py:_sample`` (:273).  Greedy rows
take the argmax over the full vocabulary (first index on ties, as
``jnp.argmax``).  Other rows scale by the temperature, keep the top
``top_k`` candidates, drop those past the nucleus ``top_p`` (the first
candidate is always kept) and draw one with ``torch.multinomial`` from an
explicit ``torch.Generator``.  The draws are not JAX's: sampled streams of
the two packages agree only in distribution.  Every row is sampled every
call, so the shapes of the work never depend on the batch's mix — no host
sync, nothing data-dependent.
"""

from __future__ import annotations

import torch

__all__ = ["SAMPLE_TOP_K", "sample"]

#: candidates nucleus sampling runs inside (the JAX package's SAMPLE_TOP_K)
SAMPLE_TOP_K = 64


def sample(
    logits: torch.Tensor,  # [N, V]
    gen: torch.Generator,
    temp: torch.Tensor,  # [N] f32
    top_p: torch.Tensor,  # [N] f32
    top_k: int = SAMPLE_TOP_K,
) -> torch.Tensor:
    """[N, V] logits -> [N] int32 token ids."""
    greedy = torch.argmax(logits, dim=-1)
    safe_temp = torch.clamp_min(temp, 1e-4)[:, None]
    scaled = logits.to(torch.float32) / safe_temp
    k = min(top_k, logits.shape[-1])
    top_logits, top_idx = torch.topk(scaled, k, dim=-1)
    probs = torch.softmax(top_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1) - probs  # exclusive prefix
    keep = cumulative < top_p[:, None]
    # the first candidate is always kept, top_p == 0 included: an all-zero
    # row is an error for multinomial (a device-side assert on the card)
    keep[:, 0] = True
    filtered = torch.where(keep, probs, torch.zeros_like(probs))
    choice = torch.multinomial(filtered, 1, generator=gen)  # [N, 1]
    sampled = torch.gather(top_idx, 1, choice)[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled).to(torch.int32)
