"""The one generator of the benchmark's traffic: a run's K inputs, made on
the device from the seed by the parameters of a traffic mix.

A mix is a data file, ``qrbench/traffic/<mix>.json``:

- ``low``, ``high``: the entries are uniform in [low, high);
- ``zero_columns``: how many columns of each input are zeroed, their
  indices drawn from the seed per input, never column 0 (so that the
  leading block stays full rank and R's leading rows stay unique).

Every input is float32 (m / world, n), rank ``rank``'s rows of a global
(m, n) input.  The same seed gives the same inputs; a mix changes only
the entries, never the sizes, so that every seed does the same work.
"""

from __future__ import annotations

import numpy as np
import torch

_MIX_KEYS = {"low", "high", "zero_columns", "why"}


def _stream_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed for one stream of a run, from the run's
    seed (any whole number) and the stream's indices."""
    words = [int(seed) % (1 << 64), *parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def zeroed_columns(mix: dict, n: int, seed: int, index: int) -> list[int]:
    """The columns the mix zeroes in input ``index``: the same on every
    rank of a run."""
    count = int(mix.get("zero_columns", 0))
    if count == 0:
        return []
    rng = np.random.default_rng(_stream_seed(seed, index, 1 << 20))
    return sorted(int(c) for c in
                  rng.choice(np.arange(1, n), size=count, replace=False))


def judged_inputs(k: int, count: int, seed: int) -> list[int]:
    """The inputs whose outputs a run judges: ``count`` of the K, drawn
    from the seed, in increasing order."""
    rng = np.random.default_rng(_stream_seed(seed, 1 << 22))
    return sorted(int(j) for j in rng.choice(k, size=count, replace=False))


def make_inputs(mix: dict, m: int, n: int, k: int, seed: int, device,
                rank: int = 0, world: int = 1) -> tuple[list, list]:
    """The K inputs of a run on this rank, and what each was built to
    exercise: ([tensor (m / world, n)], [{"zero_columns": [...]}])."""
    unknown = set(mix) - _MIX_KEYS
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if m % world:
        raise ValueError(f"m={m} does not divide over {world} ranks")
    rows = m // world
    xs, info = [], []
    for i in range(k):
        gen = torch.Generator(device=device)
        gen.manual_seed(_stream_seed(seed, i, rank))
        x = torch.empty(rows, n, device=device).uniform_(
            float(mix.get("low", -1.0)), float(mix.get("high", 1.0)),
            generator=gen)
        cols = zeroed_columns(mix, n, seed, i)
        if cols:
            x[:, cols] = 0.0
        xs.append(x)
        info.append({"zero_columns": cols})
    return xs, info
