"""The traffic generator: one seed, one set of inputs; the sizes and
instance counts that the traffic file states."""
import collections

import numpy as np
import pytest

from traffic import generate


def dataset(name, seed, batch):
    p = generate.load(name)
    ds = generate.Dataset(p, seed)
    order = np.random.RandomState(seed % 2 ** 31).permutation(len(ds))
    ds.assign([order[i:i + batch] for i in range(0, len(ds) - batch + 1, batch)])
    return p, ds, order


def test_resize_rule_gives_the_transform_s_content_sizes():
    sizes = {generate.resized((720, 1280), s, 768)
             for s in generate.load("yt19_clips")["scales"]}
    assert sizes == {(288, 512), (320, 568), (352, 625), (392, 696), (416, 739), (432, 768)}


@pytest.mark.parametrize("name,batch", [("yt19_clips", 1), ("yt19_clips", 2)])
def test_the_same_seed_gives_the_same_inputs(name, batch):
    seed = 2 ** 31 + 17
    _, a, order = dataset(name, seed, batch)
    _, b, _ = dataset(name, seed, batch)
    _, c, _ = dataset(name, seed + 1, batch)
    i = int(order[0])
    sa, sb = a[i], b[i]
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    assert a.spec == b.spec
    assert not np.array_equal(sa["images"], c[i]["images"]) or a.spec != c.spec


@pytest.mark.parametrize("name,batch", [("yt19_clips", 1), ("yt19_clips", 2)])
def test_items_past_the_pool_repeat_the_item_a_block_before(name, batch):
    p, ds, order = dataset(name, 9, batch)
    block = 16
    pool = p["pool_blocks"] * block
    assert len(set(ds.source[int(i)] for i in order[:pool])) == pool
    for j in range(pool, pool + 3 * block):
        i, back = int(order[j]), int(order[j - block])
        assert ds.spec[i] == ds.spec[back] and ds.source[i] == ds.source[back]
    assert ds[int(order[pool])] is ds[int(order[pool - block])]


def test_clip_blocks_hold_every_scale_and_count_in_the_file_s_ratio():
    p, ds, order = dataset("yt19_clips", 123, 1)
    specs = [ds.spec[int(i)] for i in order[:16]]
    want_sizes = collections.Counter(generate.resized(p["source_hw"], s, p["max_size"])
                                     for s in p["block"]["scales"])
    assert collections.Counter(hw for hw, _ in specs) == want_sizes
    assert collections.Counter(n for _, n in specs) == collections.Counter(p["block"]["instances"])
    s = ds[int(order[0])]
    n = len(s["labels"])
    assert 1 <= n <= 6 and s["images"].shape[0] == 6
    assert s["masks"].shape == (n, 6) + s["images"].shape[1:3]
    assert s["valid"].any(1).all() or not s["valid"].all()
    assert np.all(s["valid"] <= (s["masks"].reshape(n, 6, -1).sum(-1) > 2))
