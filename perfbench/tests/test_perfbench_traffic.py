"""The traffic generator: reproducible from the seed, the same sizes for every
seed, and the check's sample."""
import pytest
import torch
from conftest import SEED

from perfbench import harness, traffic

PREFILL = harness.mix_file("rag-prefill-4k.szx-kv1")


def test_round_is_the_distributions_strata():
    lens = traffic.round_lengths(PREFILL["prompt_len"])
    assert len(lens) == PREFILL["prompt_len"]["round"] and lens == sorted(lens)
    assert PREFILL["prompt_len"]["lo"] <= lens[0] and lens[-1] <= PREFILL["prompt_len"]["hi"]
    assert 1200 < sum(lens) / len(lens) < 1450            # the log-uniform mean, ~1323
    assert lens[-1] + PREFILL["answer_slots"] <= 4096         # yi-6b's context


def test_same_seed_same_requests():
    a = traffic.Requests(PREFILL, 64000, SEED, "cpu", count=70)
    b = traffic.Requests(PREFILL, 64000, SEED, "cpu", count=70)
    assert a.lengths == b.lengths and torch.equal(a.tokens, b.tokens)
    c = traffic.Requests(PREFILL, 64000, SEED + 1, "cpu", count=70)
    assert c.lengths != a.lengths and not torch.equal(c.tokens[:100], a.tokens[:100])


@pytest.mark.parametrize("seed", [0, 7, SEED, 2 ** 40 + 3])
def test_every_seed_sends_the_same_sizes(seed):
    n = PREFILL["prompt_len"]["round"]
    lens = traffic.prompt_lengths(PREFILL["prompt_len"], seed, 3 * n)
    for r in range(3):
        assert sorted(lens[r * n:(r + 1) * n]) == traffic.round_lengths(PREFILL["prompt_len"])


def test_check_sample_holds_the_longest():
    lens = traffic.prompt_lengths(PREFILL["prompt_len"], SEED, 200)
    sample = traffic.check_sample(PREFILL, lens, SEED)
    first = PREFILL["check"]["from_first"]
    assert len(sample) == PREFILL["check"]["requests"] == len(set(sample))
    assert max(lens[i] for i in sample) == max(lens[:first])
    assert all(i < first for i in sample)
    assert sample == traffic.check_sample(PREFILL, lens, SEED)


def test_prompt_views():
    r = traffic.Requests(PREFILL, 1000, SEED, "cpu", count=5)
    for i in range(5):
        p = r.prompt(i)
        assert p.shape == (1, r.lengths[i]) and p.dtype == torch.int32
        assert int(p.min()) >= 0 and int(p.max()) < 1000


def test_train_batches_reproducible_and_distinct():
    mix = harness.mix_file("pretrain-2k.plain")
    mix = dict(mix, batch=3, seq=16)
    a = traffic.train_batches(mix, 500, SEED, "cpu", 4)
    b = traffic.train_batches(mix, 500, SEED, "cpu", 4)
    for (t, lab), (t2, lab2) in zip(a, b):
        assert torch.equal(t, t2) and torch.equal(lab, lab2)
        assert t.shape == lab.shape == (3, 16) and torch.equal(t[:, 1:], lab[:, :-1])
    rows = torch.cat([t for t, _ in a])
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)


def test_warmup_is_every_length_of_a_round():
    assert sorted(traffic.warmup_lengths(PREFILL)) == traffic.round_lengths(PREFILL["prompt_len"])
