"""Capacity planner: quant x flat/IVF x shards from rows/dim/cards/memory.

The reference has no planner (its gallery is a pickle that either fits in
GPU RAM or crashes, code/search_image.py:142-165); at serving scale a user
discovers OOM at engine init. `mmrs plan` predicts the device residency
of every rung of the residency ladder BEFORE building, and the engine's
init-OOM error points here.

Residency is arithmetic (+-10%, cap rounding approximated): rows times
bytes per row, plus for IVF the slot budget, cap rounding, replicated
centroids and the spill strip. Multi-card numbers assume the slot-sharded
layouts (bytes/card / S, centroids replicated). The memory budget is the
device's own allocator limit (`memory_stats()["bytes_limit"]`, what one
JAX process may use) or `--hbm-gb`. Query latency is not predicted here:
it is measured per cell on the card (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

HBM_HEADROOM = 0.9              # leave 10% for queries/compiler scratch

QUANTS = ("bf16", "int8", "int4")

# quality ladder caveats, surfaced with every option (COVERAGE.md)
_QUANT_NOTES = {
    "bf16": "rank-parity default (0 violations vs f32 over 100k rows)",
    "int8": "~0.3% score error, rank-parity gated; IVF recall 0.973",
    "int4": "CAPACITY rung: top-10 recall plateaus ~0.80 on near-tie "
            "score geometry; prefer int8/bf16 for exact top-k ids",
}


def row_bytes(dim: int, quant: str) -> float:
    """Device bytes per gallery row incl. per-row f32 scale."""
    if quant == "bf16":
        return 2.0 * dim
    if quant == "int8":
        return float(dim) + 4.0
    if quant == "int4":
        return dim / 2.0 + 4.0
    raise ValueError(f"unknown quant {quant!r}")


def flat_resident_gb(rows: int, dim: int, quant: str = "bf16",
                     shards: int = 1) -> float:
    """Per-chip residency of the flat (exact-scan) gallery."""
    return rows * row_bytes(dim, quant) / shards / 1e9


def ivf_resident_gb(
    rows: int,
    dim: int,
    quant: str = "bf16",
    clusters: int = 0,
    slots_frac: float = 1.3,
    spill_frac: float = 0.05,
    shards: int = 1,
) -> float:
    """Per-chip residency of the IVF index: bucket slots (slots_frac x
    rows, slot-sharded over chips) + average cap-rounding waste (~64
    slots/bucket/shard) + replicated centroids + the exact-scanned spill
    strip. spill_frac is corpus-dependent (measured 7.9% at slots 1.25,
    2.4% at 1.6 on an anchor-skewed 10M corpus)."""
    clusters = clusters or default_clusters(rows)
    rb = row_bytes(dim, quant)
    buckets = slots_frac * rows * rb / shards
    cap_waste = clusters * 64.0 * rb          # per-shard average rounding
    centroids = clusters * dim * 4.0          # replicated on every chip
    spill = spill_frac * rows * rb / shards
    return (buckets + cap_waste + centroids + spill) / 1e9


def default_clusters(rows: int) -> int:
    """sqrt-rows rounded to a power of two (index/ivf.py default)."""
    c = max(16, int(rows ** 0.5))
    return 1 << (c - 1).bit_length()


def device_memory_gb(device=None) -> float:
    """Memory one JAX process may allocate on `device` (default: the
    first), in GB; raises where the backend does not report it."""
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise ValueError(f"{device} reports no memory limit; pass hbm_gb")
    return stats["bytes_limit"] / 1e9


@dataclass
class PlanOption:
    quant: str
    index: str                  # "flat" | "ivf"
    shards: int
    resident_gb_per_chip: float
    fits: bool
    exact: bool                 # exact top-k ids (no ANN, no int4)
    note: str = ""

    def describe(self) -> str:
        tag = f"{self.quant}/{self.index}"
        fit = "fits" if self.fits else "OOM"
        return (f"{tag:10s} x{self.shards} chip(s): "
                f"{self.resident_gb_per_chip:6.2f} GB/chip [{fit}] — "
                f"{self.note}")


@dataclass
class PlanReport:
    rows: int
    dim: int
    chips: int
    hbm_gb: float
    options: List[PlanOption] = field(default_factory=list)
    recommended: Optional[PlanOption] = None
    min_chips_exact_bf16: int = 0

    def render(self) -> str:
        lines = [
            f"plan: {self.rows:,} rows x {self.dim} dims on "
            f"{self.chips} chip(s) x {self.hbm_gb:.1f} GB device memory "
            f"(budget {HBM_HEADROOM:.0%})",
        ]
        lines += ["  " + o.describe() for o in self.options]
        if self.recommended is not None:
            r = self.recommended
            flags = {"bf16": "", "int8": " --gallery-quant int8",
                     "int4": " --gallery-quant int4"}[r.quant]
            if r.index == "ivf":
                flags += " --ann-nprobe 32"
            if r.shards > 1:
                flags += f" --gallery-shards {r.shards}"
            lines.append(f"recommended: {r.quant}/{r.index}"
                         f" — mmrs search{flags or ' (defaults)'}")
        else:
            lines.append(
                "recommended: NOTHING fits — add chips (bf16 flat needs "
                f">= {self.min_chips_exact_bf16}) or shrink the gallery")
        return "\n".join(lines)


def plan(
    rows: int,
    dim: int,
    chips: int = 1,
    hbm_gb: Optional[float] = None,
    nprobe: int = 32,
    clusters: int = 0,
    slots_frac: float = 1.3,
    spill_frac: float = 0.05,
) -> PlanReport:
    """Enumerate the residency ladder and recommend the highest-quality
    configuration that fits. `hbm_gb` defaults to device_memory_gb()."""
    if hbm_gb is None:
        hbm_gb = device_memory_gb()
    budget = hbm_gb * HBM_HEADROOM
    options: List[PlanOption] = []
    for quant in QUANTS:
        g = flat_resident_gb(rows, dim, quant, chips)
        options.append(PlanOption(
            quant, "flat", chips, g, g <= budget, exact=(quant != "int4"),
            note="exact scan; " + _QUANT_NOTES[quant]))
        gi = ivf_resident_gb(rows, dim, quant, clusters, slots_frac,
                             spill_frac, chips)
        options.append(PlanOption(
            quant, "ivf", chips, gi, gi <= budget, exact=False,
            note=f"ANN nprobe={nprobe}; " + _QUANT_NOTES[quant]))

    # quality order: exact scans first (bf16 then int8), then bf16 IVF,
    # int8 IVF, and the int4 capacity rungs last
    order = [("bf16", "flat"), ("int8", "flat"), ("bf16", "ivf"),
             ("int8", "ivf"), ("int4", "flat"), ("int4", "ivf")]
    by_key = {(o.quant, o.index): o for o in options}
    recommended = next((by_key[key] for key in order if by_key[key].fits),
                       None)

    bf16_gb_total = rows * row_bytes(dim, "bf16") / 1e9
    min_chips = max(1, int(-(-bf16_gb_total // budget)))
    return PlanReport(rows, dim, chips, hbm_gb, options, recommended,
                      min_chips_exact_bf16=min_chips)


def oom_hint(rows: int, dim: int) -> str:
    """Message fragment attached to engine-init OOM errors."""
    return (f"gallery does not fit on this chip; run `mmrs plan --rows "
            f"{rows} --dim {dim}` to pick a quant/IVF/shards config "
            "(residency ladder: --gallery-quant int8|int4, --ann-nprobe, "
            "--gallery-shards)")
