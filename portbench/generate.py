"""Seeded inputs: the panels, the query pools and the position pools a
cell runs on, made on the run's device from ``--seed`` in a few large
calls. Every stream of numbers is keyed by (seed, what, index), so a
chunk can be made again alone (the reference does that) and the same seed
gives the same inputs on the same kind of device."""

from __future__ import annotations

import math

import numpy as np
import torch

WORD_BITS = 32
CHUNK_ROWS = 4096  # rows of a panel made by one call


def stream_seed(seed: int, what: str, index: int = 0) -> int:
    """A 63-bit generator seed for the stream ``what``/``index`` of ``seed``
    (any nonnegative whole number, larger than 32 bits included)."""
    tag = [ord(c) for c in what]
    state = np.random.SeedSequence([int(seed), int(index), *tag]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, what: str, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, what, index))
    return g


def words_for_bits(m_bits: int) -> int:
    return -(-m_bits // WORD_BITS)


def words_chunk(seed: int, what: str, chunk: int, rows: int, m_bits: int, device) -> torch.Tensor:
    """int32 [rows, W] of uniform random words (density 0.5): chunk
    ``chunk`` of the panel ``what``."""
    if m_bits % WORD_BITS:
        raise ValueError(f"uniform words need a whole number of words, got m_bits={m_bits}")
    g = generator(seed, what, chunk, device)
    return torch.randint(-(1 << 31), 1 << 31, (rows, words_for_bits(m_bits)), dtype=torch.int32,
                         device=device, generator=g)


def chunk_rows(n: int, chunk: int, rows: int = CHUNK_ROWS) -> int:
    return min(rows, n - chunk * rows)


def words_panel_device(seed: int, what: str, n: int, m_bits: int, device, rows: int = CHUNK_ROWS):
    """Yield (row0, int32 [r, W] on ``device``) for every chunk of the panel."""
    for c in range(math.ceil(n / rows)):
        yield c * rows, words_chunk(seed, what, c, chunk_rows(n, c, rows), m_bits, device)


def words_panel_host(seed: int, what: str, n: int, m_bits: int, device,
                     rows: int = CHUNK_ROWS) -> np.ndarray:
    """The panel as the host array a user holds: uint32 [n, W], made on
    ``device`` a chunk at a time and copied down."""
    out = np.empty((n, words_for_bits(m_bits)), dtype=np.uint32)
    view = torch.from_numpy(out.view(np.int32))
    for r0, chunk in words_panel_device(seed, what, n, m_bits, device, rows):
        view[r0 : r0 + chunk.shape[0]].copy_(chunk)
    return out


def position_count(n: int, m_bits: int, density: float) -> int:
    return int(round(density * n * m_bits))


def positions_panel(seed: int, what: str, index: int, n: int, m_bits: int, density: float,
                    device) -> tuple[np.ndarray, np.ndarray]:
    """(row ids, positions) int64 on the host: ``density·n·m_bits`` set-bit
    positions drawn uniformly over the panel, duplicates allowed (a bit set
    twice is set)."""
    g = generator(seed, what, index, device)
    k = position_count(n, m_bits, density)
    rows = torch.randint(0, n, (k,), dtype=torch.int64, device=device, generator=g)
    pos = torch.randint(0, m_bits, (k,), dtype=torch.int64, device=device, generator=g)
    return rows.cpu().numpy(), pos.cpu().numpy()


def pick(seed: int, what: str, population: int, size: int) -> np.ndarray:
    """``size`` distinct sorted indices of ``range(population)``, from the seed."""
    rng = np.random.default_rng(stream_seed(seed, what))
    return np.sort(rng.choice(population, size=min(size, population), replace=False))


def binomial_upper_threshold(trials: int, p: float, tail: float) -> int:
    """The least t with P(X >= t) <= ``tail`` for X ~ Binomial(trials, p),
    summed exactly in log space from the mean upwards."""
    lp, lq = math.log(p), math.log1p(-p)
    mean = int(trials * p)

    def log_pmf(x: int) -> float:
        return (math.lgamma(trials + 1) - math.lgamma(x + 1) - math.lgamma(trials - x + 1)
                + x * lp + (trials - x) * lq)

    # the upper tail from the top down until it passes ``tail``
    sd = math.sqrt(trials * p * (1 - p))
    top = min(trials, int(mean + 40 * sd) + 1)
    acc = 0.0
    for x in range(top, mean, -1):
        acc += math.exp(log_pmf(x))
        if acc > tail:
            return x + 1
    raise ValueError(f"tail {tail} lies below the mean of Binomial({trials}, {p})")
