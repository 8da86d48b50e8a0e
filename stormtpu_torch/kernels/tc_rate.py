"""Back-to-back issue rate of the tensor-core instructions K2 may use
(``csrc/tc_rate.cu``): the ceiling of a K2 tile body, and the rate its
operation bound is stated against. A measuring tool: the roofline that
``tuning.tune`` and the acceptance run hold rates to
(``tuning.wgmma_b1_ops_per_s``), ``chip_smoke.py`` and the scripts; no
count path launches it.

One multiply-accumulate (MAC) is one bit pair for the binary product and
one int8 pair for the int8 product; K2's work is ``pairs · M`` MACs either
way. Needs the card: there is no plain version of a rate.
"""

from __future__ import annotations

import torch

__all__ = ["KINDS", "issue_rate", "issue_rates"]

# kind numbers of csrc/tc_rate.cu
KINDS = {
    "mma_sync_s8": 0,
    "mma_sync_b1": 1,
    "wgmma_b1_n256": 2,  # the instruction K2's tile body issues
}


def issue_rate(kind: int, device=None, *, blocks_per_sm: int = 2, iters: int = 4096,
               reps: int = 3) -> dict:
    """Measured MACs per second of instruction ``kind`` issued back to back
    on every SM of ``device`` (CUDA events over ``reps`` launches after one
    warm-up): ``{"kind", "name", "macs_per_s", "ms"}``. An mma.sync kind
    runs 16 times ``iters``: its instruction is that much smaller."""
    from stormtpu_torch.kernels._build import library

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError("issue_rate measures the card; there is no CPU form")
    lib = library("tc_rate")
    if not 0 <= kind < lib.tc_rate_kinds():
        raise ValueError(f"unknown instruction kind {kind}")
    if kind in (KINDS["mma_sync_s8"], KINDS["mma_sync_b1"]):
        iters *= 16
    blocks = blocks_per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(blocks * lib.tc_rate_threads(), dtype=torch.int32, device=dev)

    def launch():
        with torch.cuda.device(dev):
            err = lib.tc_rate_launch(kind, blocks, iters, sink.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tc_rate_launch({kind}) failed: CUDA error {err}")

    launch()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(stop) / reps
    macs = float(lib.tc_rate_macs(kind)) * blocks * iters
    return {"kind": kind, "name": lib.tc_rate_name(kind).decode(),
            "macs_per_s": macs / (ms * 1e-3), "ms": ms}


def issue_rates(device=None, **kw) -> list[dict]:
    """:func:`issue_rate` of every kind."""
    from stormtpu_torch.kernels._build import library

    return [issue_rate(k, device, **kw) for k in range(library("tc_rate").tc_rate_kinds())]
