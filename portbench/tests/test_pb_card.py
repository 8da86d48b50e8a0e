"""On the card: the reference's float32 product is exact there too (TF32
off), at the cells' width. Run there with
``python -m pytest portbench/tests -m cuda --confcutdir=portbench -q``."""

import numpy as np
import pytest

from portbench import generate
from portbench.reference import counts


@pytest.mark.cuda
def test_row_counts_exact_on_the_card(card):
    w = generate.words_panel_host(11, "panel", 3000, 1 << 20, card, rows=1024)
    t = generate.words_chunk(11, "panel", 0, 1024, 1 << 20, card)
    rows = np.array([0, 17, 1023])
    import torch

    full = torch.from_numpy(w.view(np.int32)).to(card)
    got = counts.row_counts(full[rows], [(0, full[:1500]), (1500, full[1500:])], 3000)
    want = np.stack([np.bitwise_count(w[r] & w).sum(axis=1, dtype=np.int64) for r in rows])
    assert np.array_equal(got, want)
    assert np.array_equal(t.cpu().numpy(), w[:1024].view(np.int32))
