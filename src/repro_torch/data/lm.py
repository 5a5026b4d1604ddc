"""Synthetic LM token stream for end-to-end transformer training, in torch.

Counterpart of `repro.data.lm`. A first-order Markov chain over the
vocabulary with Zipf marginals: there IS learnable structure (bigram
statistics), so a model trained for a few hundred steps shows a real loss
decrease, without shipping a corpus. Each sample's draws come from a CPU
`torch.Generator` seeded from (seed, step, node): the stream replays, the
same tokens on every device (they are drawn on the host, then moved),
and per-node streams are disjoint, the paper's parallel-composition
requirement. The tokens differ from the reference's
`jax.random` ones; the two streams agree in distribution (the tests hold
the walk's shift share and the Zipf marginal), never by value.

>>> ts = TokenStream(vocab_size=100, seed=0, device="cpu")
>>> a = ts.sample(step=3, node=1, batch=2, seq=8)
>>> a.shape, a.dtype, bool((a == ts.sample(3, 1, 2, 8)).all())
(torch.Size([2, 8]), torch.int32, True)
>>> b = next(lm_batches(100, batch=2, seq=8, nodes=3, device="cpu"))
>>> b["tokens"].shape, int(b["labels"][..., -1].max())
(torch.Size([3, 2, 8]), -1)
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.data.social import seeded_generator
from repro_torch.device import resolve_device

__all__ = ["TokenStream", "lm_batches"]


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_states: int = 64  # low-rank transition structure
    device: str = "cuda"

    def _marginal(self) -> torch.Tensor:
        """The Zipf marginal over the vocabulary (on the host)."""
        ranks = torch.arange(1, self.vocab_size + 1, dtype=torch.float32)
        p = ranks ** (-self.zipf_a)
        return p / p.sum()

    def sample(self, step: int, node: int, batch: int,
               seq: int) -> torch.Tensor:
        """Tokens (batch, seq) int32 on the stream's device: a Markov walk
        keyed by (seed, step, node). The first token is a Zipf draw; each
        next one is ``(prev * 31 + 7) % vocab_size`` with probability 1/2,
        else a fresh Zipf draw."""
        dev = resolve_device(self.device)
        p = self._marginal()
        gen = seeded_generator(torch.device("cpu"), self.seed, step, node)
        draws = torch.multinomial(p, batch * seq, replacement=True,
                                  generator=gen).reshape(batch, seq)
        follow = torch.rand((batch, seq), generator=gen) < 0.5
        cols = [draws[:, 0]]
        for i in range(1, seq):
            shift = (cols[-1] * 31 + 7) % self.vocab_size
            cols.append(torch.where(follow[:, i], shift, draws[:, i]))
        return torch.stack(cols, dim=1).to(device=dev, dtype=torch.int32)


def lm_batches(vocab_size: int, batch: int, seq: int, nodes: int = 1,
               seed: int = 0, device: str = "cuda") -> Iterator[dict]:
    """Yields {'tokens' (nodes, batch, seq) or (batch, seq), 'labels' ...}
    on ``device`` (CUDA unless the caller asks for the CPU).

    Labels are next-token shifted; the final position is masked (-1).
    """
    stream = TokenStream(vocab_size=vocab_size, seed=seed, device=device)
    step = 0
    while True:
        if nodes > 1:
            toks = torch.stack([stream.sample(step, i, batch, seq)
                                for i in range(nodes)])
        else:
            toks = stream.sample(step, 0, batch, seq)
        labels = torch.cat([toks[..., 1:],
                            torch.full(toks.shape[:-1] + (1,), -1,
                                       dtype=torch.int32,
                                       device=toks.device)], dim=-1)
        yield {"tokens": toks, "labels": labels}
        step += 1
