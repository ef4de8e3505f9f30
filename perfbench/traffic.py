"""The one traffic generator: requests and training batches from a mix's
parameters (``perfbench/traffic/<mix>.json``) and the seed.

Prompt lengths come in rounds: each round holds the same ``round`` lengths,
the midpoints of ``round`` equal-probability strata of the mix's length
distribution, in an order drawn from the seed.  So every seed sends the
same sizes, in another order, and any stretch of whole rounds has the
distribution's mean and tail.  Token ids are uniform over the vocabulary,
drawn on the device by a generator seeded from (seed, stream), in one call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.weights import derived_seed

TOKENS, ORDER, BATCHES, WARMUP = 1, 2, 3, 4   # the streams drawn from one seed


def stream_seed(seed: int, stream: int) -> int:
    return derived_seed(seed, 0x7AFF, stream)


def round_lengths(spec: dict) -> list[int]:
    """The ``round`` prompt lengths of one round, shortest first."""
    n, lo, hi = spec["round"], spec["lo"], spec["hi"]
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n * (math.log(hi) - math.log(lo)))))
            for i in range(n)]


def prompt_lengths(spec: dict, seed: int, count: int) -> list[int]:
    """The first ``count`` prompt lengths of ``seed``: whole rounds, each
    shuffled by the seed."""
    base = np.array(round_lengths(spec))
    rng = np.random.default_rng(stream_seed(seed, ORDER))
    rounds = -(-count // len(base))
    return [int(x) for r in range(rounds) for x in rng.permutation(base)][:count]


class Requests:
    """The prompts of a prefill mix: ``lengths[i]`` and ``prompt(i)`` (a
    (1, S) view of one flat tensor of token ids on ``device``)."""

    def __init__(self, mix: dict, vocab: int, seed: int, device, count: int | None = None):
        self.lengths = prompt_lengths(mix["prompt_len"], seed, count or mix["max_requests"])
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)]).tolist()
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, TOKENS))
        self.tokens = torch.randint(0, vocab, (self.offsets[-1],), generator=gen,
                                    device=device, dtype=torch.int32)

    def __len__(self) -> int:
        return len(self.lengths)

    def prompt(self, i: int) -> torch.Tensor:
        return self.tokens[self.offsets[i]:self.offsets[i + 1]][None]


def warmup_lengths(mix: dict) -> list[int]:
    """The prompt lengths set-up serves once: every length the mix sends,
    longest first."""
    return sorted(round_lengths(mix["prompt_len"]), reverse=True)


def warmup_tokens(n: int, vocab: int, seed: int, device) -> torch.Tensor:
    """``n`` token ids for the warm-up prompts (a stream of their own)."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WARMUP))
    return torch.randint(0, vocab, (n,), generator=gen, device=device, dtype=torch.int32)


def check_sample(mix: dict, lengths: list[int], seed: int) -> list[int]:
    """The requests whose answers the reference checks: ``requests`` of the
    first ``from_first`` (every run finishes them), drawn from the seed, the
    longest of those always among them."""
    chk = mix["check"]
    first = min(chk["from_first"], len(lengths))
    longest = max(range(first), key=lambda i: (lengths[i], -i))
    rng = np.random.default_rng(stream_seed(seed, ORDER + 100))
    rest = [i for i in rng.permutation(first).tolist() if i != longest]
    return sorted([longest] + rest[:chk["requests"] - 1])


def train_batches(mix: dict, vocab: int, seed: int, device, count: int) -> list:
    """``count`` (tokens, labels) pairs of (B, S) int32 rows: each row is
    S + 1 ids uniform over the vocabulary, the labels the next ids; every
    row of every step differs."""
    b, s = mix["batch"], mix["seq"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, BATCHES))
    rows = torch.randint(0, vocab, (count, b, s + 1), generator=gen, device=device,
                         dtype=torch.int32)
    return [(rows[i, :, :-1].contiguous(), rows[i, :, 1:].contiguous()) for i in range(count)]
