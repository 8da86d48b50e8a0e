"""The LD panel of the biobank configuration (``layout: "ld_neutral_blocks"``):
N variant rows over M haplotype bits, made on the run's device from
``--seed`` a chunk of rows at a time.

- Each row's carrier count a is drawn from the standard neutral
  site-frequency spectrum, P(a) ∝ 1/a for a = 1 … M−1 (Watterson 1975;
  Fu 1995), by the inverse of its CDF (summed on the host in float64, so
  that every device looks the counts up in the same table).
- Rows come in consecutive blocks of ``ld_block_rows``. A block draws one
  random order of the M haplotypes (a permutation, from (seed, block)),
  and the carriers of each of its rows are the haplotypes ranked below the
  row's count: carriers nest within a block (D′ = 1), blocks are
  independent.

Every stream of numbers is keyed by (seed, what, index)
(``generate.generator``), so the reference makes any chunk again alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import generate

LAYOUT = "ld_neutral_blocks"
_BATCH_ROWS = 256  # rows packed at a time: a [256, M] bool and its int32 bits


def check_layout(config: dict) -> None:
    if config["layout"] != LAYOUT or config["m_bits"] % generate.WORD_BITS:
        raise ValueError(f"this driver runs {LAYOUT} panels of whole words, not "
                         f"{config['layout']} at {config['m_bits']} bits")
    block = config["ld_block_rows"]
    if generate.CHUNK_ROWS % block or _BATCH_ROWS % block or config["n"] % block:
        raise ValueError(f"{config['n']} rows, a chunk of {generate.CHUNK_ROWS} and a batch "
                         f"of {_BATCH_ROWS} must hold whole blocks of {block}")


def spectrum_cdf(m_bits: int) -> np.ndarray:
    """float64 [M − 1]: P(count ≤ a) of the neutral spectrum at a = 1 … M−1."""
    cdf = np.cumsum(1.0 / np.arange(1, m_bits, dtype=np.float64))
    return cdf / cdf[-1]


def carrier_counts(seed: int, n: int, m_bits: int, device) -> torch.Tensor:
    """int64 [n] on ``device``: each row's carrier count, 1 … M−1."""
    cdf = torch.from_numpy(spectrum_cdf(m_bits)).to(device)
    u = torch.rand(n, dtype=torch.float64, device=device,
                   generator=generate.generator(seed, "ld_counts", 0, device))
    return torch.clamp(torch.searchsorted(cdf, u), max=m_bits - 2) + 1


def _bit_weights(device) -> torch.Tensor:
    """int32 [32]: each bit's weight in the int32 bit-view of a word (bit
    31 is −2³¹); a sum of distinct weights never leaves int32's range."""
    w = torch.tensor([1 << b for b in range(31)] + [-(1 << 31)], dtype=torch.int64)
    return w.to(torch.int32).to(device)


def chunk(seed: int, index: int, counts: torch.Tensor, config: dict, device) -> torch.Tensor:
    """int32 [r, W] on ``device``: chunk ``index`` of the panel (rows
    index·CHUNK_ROWS …), its rows' counts taken from ``counts``."""
    m, block = config["m_bits"], config["ld_block_rows"]
    r0 = index * generate.CHUNK_ROWS
    rows = generate.chunk_rows(config["n"], index)
    out = torch.empty((rows, m // generate.WORD_BITS), dtype=torch.int32, device=device)
    weights = _bit_weights(device)
    for b0 in range(0, rows, _BATCH_ROWS):
        b1 = min(rows, b0 + _BATCH_ROWS)
        rank = torch.stack([
            torch.randperm(m, device=device,
                           generator=generate.generator(seed, "ld_block", (r0 + s) // block,
                                                        device))
            for s in range(b0, b1, block)])
        a = counts[r0 + b0 : r0 + b1].view(-1, block, 1)
        bits = (rank[:, None, :] < a).view(b1 - b0, -1, generate.WORD_BITS)
        out[b0:b1] = (bits.to(torch.int32) * weights).sum(dim=2, dtype=torch.int32)
        del rank, bits
    return out


def panel_device(seed: int, config: dict, device):
    """Yield (row0, int32 [r, W] on ``device``) for every chunk of the panel."""
    check_layout(config)
    counts = carrier_counts(seed, config["n"], config["m_bits"], device)
    for c in range(math.ceil(config["n"] / generate.CHUNK_ROWS)):
        yield c * generate.CHUNK_ROWS, chunk(seed, c, counts, config, device)


def host_panel(cell) -> np.ndarray:
    """The panel as the host array a user holds: uint32 [n, W], made on the
    cell's device a chunk at a time and copied down."""
    c = cell.config
    out = np.empty((c["n"], c["m_bits"] // generate.WORD_BITS), dtype=np.uint32)
    view = torch.from_numpy(out.view(np.int32))
    for r0, words in panel_device(cell.seed, c, cell.device):
        view[r0 : r0 + words.shape[0]].copy_(words)
    return out


def reference_panel(cell) -> torch.Tensor:
    """The whole panel again, int32 [N, W] on the cell's device."""
    c = cell.config
    out = torch.empty((c["n"], c["m_bits"] // generate.WORD_BITS), dtype=torch.int32,
                      device=cell.device)
    for r0, words in panel_device(cell.seed, c, cell.device):
        out[r0 : r0 + words.shape[0]] = words
    return out
