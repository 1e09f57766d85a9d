"""The one traffic generator: every mix is a data file of parameters
that this module reads.

Serve mixes (a closed loop of batched ``generate`` calls):

  batch          requests a call
  prompt_len     tokens a prompt, the same in every call
  new_tokens     tokens generated a request (greedy)
  prefix_len     image-patch embeddings before the prompt (0: none)
  pool           distinct calls drawn; the loop cycles through them

Train and gradient mixes: ``batch`` × ``seq_len`` tokens a step,
``pool`` distinct batches.

Token ids are uniform over the vocabulary; a prefix is N(0, 1/d) in
bf16, so that after the model's √d it has the scale of a token
embedding.  Everything is drawn on the device from a generator seeded
by the run's seed, apart from the weights' stream.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def stream_seed(seed: int, stream: int) -> int:
    """A seed for the ``stream``-th generator of a run, apart from the
    weights' (stream 0 is the seed itself)."""
    return (seed * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)


class ServeTraffic:
    """The calls of a serve mix, drawn at set-up on ``device``."""

    def __init__(self, tr: Dict[str, Any], vocab: int, d_model: int,
                 seed: int, device, dtype=torch.bfloat16):
        self.batch, self.new_tokens = tr["batch"], tr["new_tokens"]
        self.prompt_len = tr["prompt_len"]
        self.prefix_len = tr.get("prefix_len", 0)
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, 1))
        self.calls = []
        for _ in range(tr["pool"] + 1):
            toks = torch.randint(0, vocab, (self.batch, self.prompt_len),
                                 generator=g, device=device)
            prefix = None
            if self.prefix_len:
                prefix = (torch.randn((self.batch, self.prefix_len, d_model),
                                      generator=g, device=device,
                                      dtype=dtype) * d_model ** -0.5)
            self.calls.append((toks, prefix))
        # the last draw is the warm-up call, kept out of the window
        self.warm = self.calls.pop()

    def call(self, i: int):
        return self.calls[i % len(self.calls)]


def train_batches(tr: Dict[str, Any], vocab: int, seed: int, device,
                  stream: int = 2, count: Optional[int] = None
                  ) -> List[Dict[str, torch.Tensor]]:
    """``count`` (default ``pool``) batches {tokens, labels} of
    ``batch`` × ``seq_len``: labels are the next token of a sequence one
    longer."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    out = []
    for _ in range(count or tr["pool"]):
        seq = torch.randint(0, vocab, (tr["batch"], tr["seq_len"] + 1),
                            generator=g, device=device)
        out.append({"tokens": seq[:, :-1].contiguous(),
                    "labels": seq[:, 1:].contiguous()})
    return out
