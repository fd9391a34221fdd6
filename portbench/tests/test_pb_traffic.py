"""The docqa generator: deterministic in its seed, the stated lengths."""
import statistics

import numpy as np

from portbench import traffic


def _mix(root):
    from pathlib import Path
    return traffic.load_mix(Path(root) / "portbench", "docqa")


def test_same_seed_same_batches(root):
    mix = _mix(root)
    a, b = (traffic.Generator(mix, 256000, 2**31 + 7) for _ in range(2))
    for i in range(3):
        for x, y in zip(a.batch(i), b.batch(i)):
            assert x.uid == y.uid and x.max_new == y.max_new
            assert np.array_equal(x.prompt, y.prompt)
    assert np.array_equal(a.warm().prompt, b.warm().prompt)


def test_seeds_differ_in_order_not_in_work(root):
    mix = _mix(root)
    a = traffic.Generator(mix, 65024, 1).batch(0)
    b = traffic.Generator(mix, 65024, 2).batch(0)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


def test_lengths_median_and_clip(root):
    mix = _mix(root)
    lens = traffic.output_lengths(mix)
    assert len(lens) == traffic.batch_size(mix) == 64
    assert min(lens) >= 4 and max(lens) <= 96
    assert statistics.median(lens) == 24
    clipped = dict(mix, output_len=dict(mix["output_len"], min=10, max=30))
    lens = traffic.output_lengths(clipped)
    assert min(lens) == 10 and max(lens) == 30


def test_prompts_full_length_in_vocab_distinct_prefixes(root):
    mix = _mix(root)
    gen = traffic.Generator(mix, 65024, -5)
    reqs = gen.batch(0) + gen.batch(1)
    assert all(len(r.prompt) == 2048 and r.prompt.dtype == np.int32
               for r in reqs)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 65024 for r in reqs)
    assert len({int(r.prompt[0]) for r in reqs}) == len(reqs)
    assert len({r.uid for r in reqs}) == len(reqs)
