"""The surrogate pool: sizes, classes, determinism by seed and the tile."""

import numpy as np
import pytest

from codec_bench import pool, registry, traffic


@pytest.mark.parametrize("cls", sorted(pool.CLASSES))
def test_class_fills_its_size(cls):
    a = pool.CLASSES[cls](np.random.default_rng(5), np.random.default_rng(6),
                          1 << 20)
    assert a.dtype == np.uint8 and a.shape == (1 << 20,)


def test_same_seed_same_bytes_other_seed_other_bytes():
    seed = 2**31 + 977
    a = pool.make_file("english", 5000, seed, 3)
    assert a == pool.make_file("english", 5000, seed, 3)
    assert a != pool.make_file("english", 5000, seed + 1, 3)
    assert a != pool.make_file("english", 5000, seed, 4)


def test_the_seed_changes_bytes_and_not_the_shape():
    # the zero tables of the binary class lie where they lie for any seed
    a = np.frombuffer(pool.make_file("binary", 1 << 16, 1, 2), np.uint8)
    b = np.frombuffer(pool.make_file("binary", 1 << 16, 2, 2), np.uint8)
    assert (a != b).any()
    runs = [np.flatnonzero(np.convolve(x == 0, np.ones(32), "valid") == 32)
            for x in (a, b)]
    assert np.array_equal(runs[0], runs[1]) and runs[0].size


def test_a_file_repeats_its_tile_beyond_the_widest_window():
    b = pool.make_file("source", (3 << 20) + 17, 11, 0)
    assert len(b) == (3 << 20) + 17
    assert b[:1 << 20] == b[1 << 20:2 << 20]
    assert b[2 << 20:] == b[:(1 << 20) + 17]
    assert pool.MIN_TILE >= 16 * 65535


def test_pool_sizes_follow_the_config():
    cfg = registry.config("default-window")
    made = pool.make_pool(cfg["files"], 1, scale=10000)
    assert [len(f) for f in made] == [f["bytes"] // 10000
                                      for f in cfg["files"]]
    assert made[-1] != made[-2]


def test_random_class_is_incompressible_and_text_is_not():
    import zlib

    r = pool.make_file("random", 1 << 16, 3, 0)
    t = pool.make_file("english", 1 << 16, 3, 0)
    assert len(zlib.compress(r)) > 0.99 * len(r)
    assert len(zlib.compress(t)) < 0.5 * len(t)


def test_blocks_deck_has_the_same_sizes_files_and_ops_for_every_seed():
    cfg = registry.config("default-window")
    mix = registry.traffic("blocks-rw")
    sizes = [f["bytes"] for f in cfg["files"]]
    a = traffic.deck(mix, cfg["files"], sizes, 1)
    b = traffic.deck(mix, cfg["files"], sizes, 2**31 + 5)
    assert len(a) == mix["deck"]
    triples = sorted((i.size, i.file, i.op) for i in a)
    assert triples == sorted((i.size, i.file, i.op) for i in b)
    assert [i.size for i in a] != [i.size for i in b]
    assert [i.offset for i in a] != [i.offset for i in b]
    lo, hi = mix["block_bytes"]
    assert all(lo <= i.size <= hi for i in a)
    assert all(i.offset + i.size <= sizes[i.file] for i in a)
    assert sum(i.op == "compress" for i in a) == mix["deck"] // 2


def test_files_deck_is_every_file_once_from_a_seeded_start():
    cfg = registry.config("max-window")
    mix = registry.traffic("files-encode")
    sizes = [f["bytes"] for f in cfg["files"]]
    firsts = set()
    for seed in range(8):
        d = traffic.deck(mix, cfg["files"], sizes, seed)
        assert sorted(i.file for i in d) == list(range(12))
        assert all(i.op == "compress" and i.size == sizes[i.file]
                   for i in d)
        firsts.add(d[0].file)
    assert len(firsts) > 1
