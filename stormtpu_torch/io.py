"""BitMatrix serialization and domain ingest (port of ``stormtpu/io.py``;
host only).

Format: one ``.npz`` holding the packed words and metadata (and the
ingest-time COO cache when the matrix has one), or, out of core, an
uncompressed ``.npy`` with a ``.json`` sidecar. Both packages read and
write the same files: a matrix saved by one loads in the other.

``load_plink_bed`` decodes PLINK1 binary genotype files (``.bed``, with
their ``.fam`` / ``.bim`` sidecars) straight into the bitmaps the
all-pairs engine consumes.
"""

from __future__ import annotations

import numpy as np

from stormtpu_torch.layout import BitMatrix

__all__ = [
    "save_bitmatrix",
    "load_bitmatrix",
    "save_bitmatrix_mmap",
    "load_bitmatrix_mmap",
    "load_plink_bed",
]

_FORMAT_VERSION = 1


def save_bitmatrix(bm: BitMatrix, path: str) -> None:
    """Write a BitMatrix to ``path`` (.npz, compressed). The ingest-time
    COO cache, when present, rides along so the ultra-sparse K4 path
    stays O(nnz) after a round-trip."""
    extra = {}
    if bm.coo is not None:
        extra["coo_rows"], extra["coo_positions"] = bm.coo
    np.savez_compressed(
        path,
        format_version=_FORMAT_VERSION,
        packed=bm.packed,
        m_bits=bm.m_bits,
        **extra,
    )


def save_bitmatrix_mmap(bm: BitMatrix, path: str) -> None:
    """Out-of-core twin of :func:`save_bitmatrix`: an UNCOMPRESSED
    ``.npy`` of the packed words (memory-mappable — zip members of an
    ``.npz`` are not) plus a tiny ``<path>.json`` metadata sidecar.
    With :func:`load_bitmatrix_mmap` this extends the streaming drivers'
    bound from host RAM to DISK: the superblock walks (stream.py /
    stream_query.py, reference C11's driver) slice operands
    sequentially, so a panel larger than memory pages through the OS
    cache one superblock at a time."""
    import json

    np.save(path, np.ascontiguousarray(bm.packed))
    meta = {"format_version": _FORMAT_VERSION, "m_bits": bm.m_bits,
            "n": bm.n}
    real = path if path.endswith(".npy") else path + ".npy"
    with open(real + ".json", "w") as f:
        json.dump(meta, f)


def load_bitmatrix_mmap(path: str, *, mmap: bool = True) -> BitMatrix:
    """Load a :func:`save_bitmatrix_mmap` pair; ``mmap=True`` (default)
    keeps ``packed`` as a read-only ``np.memmap`` — construction pays
    one streaming pass (row popcounts + tail-bit validation), after
    which superblock slices read from disk on demand. Everything
    downstream treats ``packed`` as read-only, so the view is safe to
    share; single-shot device routes that would materialize the whole
    panel are already guarded by the device-budget refusals."""
    import json

    real = path if path.endswith(".npy") else path + ".npy"
    with open(real + ".json") as f:
        meta = json.load(f)
    if int(meta["format_version"]) > _FORMAT_VERSION:
        raise ValueError(
            f"{real}: format version {meta['format_version']} is newer "
            f"than supported ({_FORMAT_VERSION})"
        )
    packed = np.load(real, mmap_mode="r" if mmap else None)
    bm = BitMatrix.from_packed(packed, m_bits=int(meta["m_bits"]))
    if bm.n != int(meta["n"]):
        raise ValueError(
            f"{real}: payload has {bm.n} rows, sidecar says {meta['n']}"
        )
    return bm


# PLINK1 .bed 2-bit genotype codes (SNP-major; sample j of a variant
# occupies bits [2(j%4), 2(j%4)+1) of byte j//4, LSB-first):
#   0b00 homozygous A1   0b01 missing   0b10 heterozygous   0b11 homozygous A2
_PLINK_MAGIC = b"\x6c\x1b\x01"
_PLINK_ENCODINGS = {
    # predicate over the 2-bit code → set bit
    "carrier": lambda c: c >= 2,     # carries ≥1 A2 allele (het or hom-A2)
    "hom_a2": lambda c: c == 3,
    "het": lambda c: c == 2,
    "hom_a1": lambda c: c == 0,
    "missing": lambda c: c == 1,
}


def _count_lines(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        for line in f:
            n += line.strip() != b""
    return n


def load_plink_bed(
    path: str,
    n_samples: int | None = None,
    n_variants: int | None = None,
    *,
    encode: str = "carrier",
    rows: str = "variants",
    chunk_variants: int | None = None,
) -> BitMatrix:
    """Decode a PLINK1 binary genotype file (``.bed``, SNP-major) into a
    BitMatrix — the motivating ingest of the reference's domain (genotype
    indicator bitmaps; SURVEY.md §1).

    ``encode`` picks the indicator per genotype code: "carrier" (≥1 A2
    allele — the LD-screen default), "hom_a2", "het", "hom_a1", or
    "missing". ``rows``: "variants" (bitmap per variant over samples —
    all-pairs = variant×variant LD counts) or "samples" (transpose).
    ``n_samples`` defaults to the line count of the trio's ``.fam``
    sidecar and ``n_variants`` to the ``.bim``'s (else inferred from the
    file size). Decode runs in variant chunks bounded at ~256 MB of
    transients (``chunk_variants`` — a multiple of 32 — overrides the
    chunk size; the default is right outside tests). Missing genotypes set no bit except under
    ``encode="missing"`` (screen or mask them explicitly via a second
    matrix when needed).
    """
    if encode not in _PLINK_ENCODINGS:
        raise ValueError(
            f"unknown encode {encode!r}; want one of {sorted(_PLINK_ENCODINGS)}"
        )
    if rows not in ("variants", "samples"):
        raise ValueError(f"rows must be 'variants' or 'samples', got {rows!r}")
    stem = path[:-4] if path.endswith(".bed") else path
    if n_samples is None:
        import os

        fam = stem + ".fam"
        if not os.path.exists(fam):
            raise ValueError(
                f"n_samples not given and no sidecar {fam} to count"
            )
        n_samples = _count_lines(fam)
    if n_variants is None:
        import os

        bim = stem + ".bim"
        if os.path.exists(bim):
            n_variants = _count_lines(bim)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    with open(path, "rb") as f:
        head = f.read(3)
        if head[:2] != _PLINK_MAGIC[:2]:
            raise ValueError(f"{path}: not a PLINK .bed file (bad magic)")
        if head[2:3] != _PLINK_MAGIC[2:3]:
            raise ValueError(
                f"{path}: individual-major .bed (mode 0) is the obsolete "
                f"PLINK<1.0 layout; re-export SNP-major"
            )
        body = np.frombuffer(f.read(), dtype=np.uint8)
    bpv = (n_samples + 3) // 4
    if n_variants is None:
        if bpv == 0 or body.size % bpv:
            raise ValueError(
                f"{path}: {body.size} genotype bytes is not a multiple of "
                f"{bpv} bytes/variant for n_samples={n_samples}"
            )
        n_variants = body.size // bpv
    elif body.size != n_variants * bpv:
        raise ValueError(
            f"{path}: expected {n_variants * bpv} genotype bytes for "
            f"{n_variants} variants × {bpv} bytes, found {body.size}"
        )
    # Decode in variant chunks packed straight into uint32 words: a
    # single-shot decode materializes codes [V, 4·bpv] + dense [V, N]
    # (~2.25× the .bed body — ~200 GB of transients at the spec-scale
    # 100k × 1M panel, vs a 12.5 GB packed result), so transients here
    # are bounded at ~2·chunk·N bytes regardless of V.
    from stormtpu_torch.layout import pack_bits, words_for_bits

    shifts = np.array([0, 2, 4, 6], np.uint8)
    pred = _PLINK_ENCODINGS[encode]
    # ~256 MB of decode transients per chunk; multiple of 32 so the
    # "samples" orientation packs whole output words per chunk
    if chunk_variants is None:
        cv = max(32, ((1 << 27) // max(n_samples, 1)) & ~31)
    else:
        if chunk_variants < 32 or chunk_variants % 32:
            raise ValueError("chunk_variants must be a positive multiple of 32")
        cv = chunk_variants
    if rows == "variants":
        w = words_for_bits(n_samples)
        packed = np.empty((n_variants, w), dtype=np.uint32)
        for v0 in range(0, n_variants, cv):
            v1 = min(v0 + cv, n_variants)
            codes = (
                body[v0 * bpv : v1 * bpv].reshape(v1 - v0, bpv, 1) >> shifts
            ) & np.uint8(3)
            codes = codes.reshape(v1 - v0, bpv * 4)[:, :n_samples]
            packed[v0:v1] = pack_bits(pred(codes).astype(np.uint8))
        return BitMatrix.from_packed(packed, m_bits=n_samples)
    w = words_for_bits(n_variants)
    packed = np.zeros((n_samples, w), dtype=np.uint32)
    for v0 in range(0, n_variants, cv):
        v1 = min(v0 + cv, n_variants)
        codes = (
            body[v0 * bpv : v1 * bpv].reshape(v1 - v0, bpv, 1) >> shifts
        ) & np.uint8(3)
        codes = codes.reshape(v1 - v0, bpv * 4)[:, :n_samples]
        dense_t = np.ascontiguousarray(pred(codes).astype(np.uint8).T)
        # v0 is a multiple of 32, so this chunk fills whole words
        packed[:, v0 // 32 : (v0 + dense_t.shape[1] + 31) // 32] = pack_bits(
            dense_t
        )
    return BitMatrix.from_packed(packed, m_bits=n_variants)


def load_bitmatrix(path: str) -> BitMatrix:
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"{path}: format version {version} is newer than supported "
                f"({_FORMAT_VERSION})"
            )
        bm = BitMatrix.from_packed(z["packed"], m_bits=int(z["m_bits"]))
        if "coo_rows" in z:
            bm.coo = (z["coo_rows"], z["coo_positions"])
        return bm
