from stormtpu_torch.utils.backend import resolve_device
from stormtpu_torch.utils.profiling import (
    timeit_chain,
    timeit_sustained,
    timeit_sustained_auto,
    trace,
)
from stormtpu_torch.utils.tiling import (
    assemble_stripe,
    assemble_stripe_torch,
    assemble_triangular,
    assemble_triangular_torch,
    download,
    next_pow2,
    quantize_bucket,
    round_up,
    triangular_assembly_bytes,
    triangular_tile_ids,
)

__all__ = [
    "assemble_stripe",
    "assemble_stripe_torch",
    "assemble_triangular",
    "assemble_triangular_torch",
    "download",
    "next_pow2",
    "quantize_bucket",
    "resolve_device",
    "round_up",
    "timeit_chain",
    "timeit_sustained",
    "timeit_sustained_auto",
    "trace",
    "triangular_assembly_bytes",
    "triangular_tile_ids",
]
