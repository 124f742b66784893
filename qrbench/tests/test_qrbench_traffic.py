"""The one generator: deterministic for a seed, and each mix makes what
it says."""

import pytest
import torch

from qrbench import cell as cell_mod, generate

BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix_name", ["well", "rankdef"])
def test_same_seed_same_inputs(mix_name):
    mix = cell_mod.load_json(cell_mod.HERE / "traffic" / f"{mix_name}.json")
    a, ia = generate.make_inputs(mix, 256, 16, 3, BIG_SEED, "cpu")
    b, ib = generate.make_inputs(mix, 256, 16, 3, BIG_SEED, "cpu")
    c, _ = generate.make_inputs(mix, 256, 16, 3, BIG_SEED + 1, "cpu")
    assert ia == ib
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert len({float(x.sum()) for x in a}) == 3   # K distinct inputs
    assert all(x.dtype == torch.float32 and x.shape == (256, 16) for x in a)
    assert all(float(x.abs().max()) <= 1.0 for x in a)


def test_rankdef_zeroes_one_column_an_input():
    mix = cell_mod.load_json(cell_mod.HERE / "traffic" / "rankdef.json")
    seen = set()
    for seed in range(20):
        xs, info = generate.make_inputs(mix, 128, 32, 2, seed, "cpu")
        for x, i in zip(xs, info):
            zero = [j for j in range(32) if float(x[:, j].abs().sum()) == 0]
            assert zero == i["zero_columns"] and len(zero) == 1
            assert zero[0] != 0
            seen.add(zero[0])
    assert len(seen) > 5   # the index is drawn, not fixed


def test_well_zeroes_nothing():
    mix = cell_mod.load_json(cell_mod.HERE / "traffic" / "well.json")
    xs, info = generate.make_inputs(mix, 128, 32, 2, 9, "cpu")
    assert all(i["zero_columns"] == [] for i in info)
    assert all(float(x.abs().sum(0).min()) > 0 for x in xs)


def test_ranks_hold_their_rows_and_share_zero_columns():
    mix = {"low": -1.0, "high": 1.0, "zero_columns": 1}
    shards = [generate.make_inputs(mix, 64, 8, 1, 77, "cpu", r, 4)
              for r in range(4)]
    assert all(s[0][0].shape == (16, 8) for s in shards)
    assert len({tuple(s[1][0]["zero_columns"]) for s in shards}) == 1
    assert not torch.equal(shards[0][0][0], shards[1][0][0])


def test_unknown_key_raises():
    with pytest.raises(ValueError):
        generate.make_inputs({"skew": 1}, 8, 2, 1, 0, "cpu")


def test_judged_inputs_are_drawn_from_the_seed():
    picks = {tuple(generate.judged_inputs(6, 2, s)) for s in range(40)}
    assert len(picks) > 5
    for p in picks:
        assert len(p) == 2 and list(p) == sorted(p) and 0 <= p[0] < p[1] < 6
    assert generate.judged_inputs(6, 2, BIG_SEED) == \
        generate.judged_inputs(6, 2, BIG_SEED)
    assert generate.judged_inputs(1, 1, 3) == [0]
