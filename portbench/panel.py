"""The dense panel of uniform words that the config-4 drivers share: the
host ``BitMatrix`` a user holds, made on the device from the seed, and
the reference's own copy of it, made again from the seed."""

from __future__ import annotations

import numpy as np
import torch

from portbench import generate

PANEL = "panel"


def check_layout(config: dict) -> None:
    if config["layout"] != "uniform_words" or config["density"] != 0.5:
        raise ValueError(f"this driver runs panels of uniform words (density 0.5), "
                         f"not {config['layout']} at {config['density']}")


def host_panel(cell) -> np.ndarray:
    c = cell.config
    check_layout(c)
    return generate.words_panel_host(cell.seed, PANEL, c["n"], c["m_bits"], cell.device)


def bitmatrix(words: np.ndarray, m_bits: int):
    import stormtpu_torch as st

    return st.BitMatrix.from_packed(words, m_bits)


def reference_panel(cell) -> torch.Tensor:
    """The whole panel again, int32 [N, W] on the device, from the seed."""
    c = cell.config
    out = torch.empty((c["n"], generate.words_for_bits(c["m_bits"])), dtype=torch.int32,
                      device=cell.device)
    for r0, chunk in generate.words_panel_device(cell.seed, PANEL, c["n"], c["m_bits"],
                                                 cell.device):
        out[r0 : r0 + chunk.shape[0]] = chunk
    return out


def chunks_of(x: torch.Tensor, rows: int = generate.CHUNK_ROWS):
    for r0 in range(0, x.shape[0], rows):
        yield r0, x[r0 : r0 + rows]


def free_device(*bms) -> None:
    for bm in bms:
        if bm is not None:
            bm.clear_device_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
